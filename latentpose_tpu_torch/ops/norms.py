"""Plain normalisation ops: instance norm and AdaIN (port of
``latentpose_tpu/ops/norms.py``).

Tensors are NHWC, as in the JAX package: x (B, H, W, C), statistics per
(sample, channel) over H and W.  One-pass f32 moments, E[x²] − E[x]² clamped
at 0, biased variance, eps 1e-4 (torch InstanceNorm2d(eps=1e-4) parity).
The generator's AdaIN + ReLU runs through the CUDA kernel in
``ops/adain.py``; these are its plain reference and the CPU path.
"""

from __future__ import annotations

import torch


def moments(x32):
    """Per-(sample, channel) mean and clamped one-pass variance of f32 x."""
    mean = x32.mean(dim=(1, 2), keepdim=True)
    meansq = x32.square().mean(dim=(1, 2), keepdim=True)
    return mean, torch.clamp(meansq - mean.square(), min=0.0)


def instance_norm(x, eps: float = 1e-4):
    """InstanceNorm2d(affine=False) over (H, W) of x (B, H, W, C)."""
    x32 = x.float()
    mean, var = moments(x32)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def adain(x, weight, bias, eps: float = 1e-4):
    """IN(x) * weight + bias; weight, bias (B, C) per sample."""
    y = instance_norm(x, eps)
    return y * weight[:, None, None, :].to(y.dtype) \
        + bias[:, None, None, :].to(y.dtype)


def instance_norm_affine(x, weight, bias, eps: float = 1e-4):
    """InstanceNorm2d(affine=True): shared (C,) weight and bias."""
    y = instance_norm(x, eps)
    return y * weight.to(y.dtype) + bias.to(y.dtype)
