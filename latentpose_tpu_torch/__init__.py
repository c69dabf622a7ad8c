"""latentpose_tpu_torch — the PyTorch / CUDA port of ``latentpose_tpu`` for
NVIDIA Hopper (H100), beside the JAX package that stays the reference.

Ported: the flagship model's meta-train, fine-tune and drive paths, with
both TPU kernels as CUDA kernels written for sm_90a: the generator's AdaIN +
ReLU (``csrc/adain_fused.cu``, wrapper ``ops/adain.py``) and ResNeXt-50's
BN -> ReLU -> 1x1 conv -> stats link (``csrc/conv_bn_fused.cu``, wrapper
``ops/conv_bn.py``).
It trains from frames on disk: the VoxCeleb2 dataloader on a C++ image
loader of its own (``csrc/lpr_loader.cpp``, ``data/native_loader.py``) and
the epoch loop with validation, visuals and save-on-signal
(``runners/loop.py``).  Raw footage is preprocessed by the port too: S³FD,
the latentpose cropper, FAN landmarks and Graphonomy masks
(``preprocess/``, ``eval/``, ``cli/preprocess_dataset.py``,
``cli/crop_as_in_dataset.py``, drive's ``--crop``).  Kernels and the loader
build from ``csrc/`` into ``_build/`` at first use.  The package
imports ``torch`` and never ``jax``; it reads and writes the JAX package's
checkpoint format (``checkpoint.py``, ``convert.py``).
"""
