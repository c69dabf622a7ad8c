"""Data-parallel training and drive over ``torch.distributed`` (port of
``latentpose_tpu/parallel/``, its data-parallel half): ``mesh.py`` holds
the group, the rows, the reductions and the global batch; ``launch.py``
starts the local ranks of a ``--num_devices N`` run."""
