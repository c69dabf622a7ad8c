"""latentpose_tpu_torch — the PyTorch / CUDA port of ``latentpose_tpu`` for
NVIDIA Hopper (H100), beside the JAX package that stays the reference.

Ported so far: the drive path of the flagship model (MobileNetV2 latent-pose
encoder -> AdaIN generator), with the generator's AdaIN + ReLU as a CUDA
kernel written for sm_90a (``csrc/adain_fused.cu``, wrapper ``ops/adain.py``).
Kernels build from ``csrc/`` into ``_build/`` at first use.  The package
imports ``torch`` and never ``jax``; it reads and writes the JAX package's
checkpoint format (``checkpoint.py``, ``convert.py``).
"""
