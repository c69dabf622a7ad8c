"""Spectral-normalised conv and linear layers, eval form (port of
``SNConv`` / ``SNDense`` in ``latentpose_tpu/ops/spectral_norm.py``).

The weight is viewed as the 2-D matrix W of torch's ``spectral_norm``:
(O, I·kh·kw) of the OIHW conv kernel, (out, in) of the linear weight.  The
power-iteration state (u, v) is a pair of buffers loaded from the
checkpoint's ``spectral`` collection, and at eval σ = uᵀ(W v) is taken from
it in f32 with no further iteration.  Serving could fold W/σ into the weight
once at load time; this port recomputes σ in each forward (one matrix-vector
product per layer), so the same module serves before and after a load and
the training slices can add the power iteration in place.

Parameters stay f32; a forward casts the normalised weight to the input's
dtype, as the JAX layers do under bf16.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from latentpose_tpu_torch.ops import initializers as tinit


def _l2_normalize(x, eps):
    # torch F.normalize: x / max(||x||, eps)
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


class _SpectralNorm(nn.Module):
    def _init_spectral(self, out_features, sn_eps, generator):
        """Random u, then one power iteration (JAX init: v, then u)."""
        self.sn_eps = sn_eps
        w2d = self.weight.detach().reshape(out_features, -1).float()
        u = _l2_normalize(torch.randn(out_features, generator=generator), 1e-12)
        v = _l2_normalize(w2d.T @ u, sn_eps)
        u = _l2_normalize(w2d @ v, sn_eps)
        self.register_buffer("u", u)
        self.register_buffer("v", v)

    def weight_sn(self):
        """W / σ with σ = uᵀ (W v) in f32 from the stored (u, v)."""
        w2d = self.weight.reshape(self.weight.shape[0], -1).float()
        sigma = self.u @ (w2d @ self.v)
        return self.weight / sigma.to(self.weight.dtype)


class SNConv(_SpectralNorm):
    """Conv2d + spectral norm on NCHW tensors; ``padding`` is zero padding."""

    def __init__(self, in_features, features, kernel_size=3, padding=1,
                 use_bias=True, groups=1, sn_eps=1e-4, generator=None):
        super().__init__()
        self.padding = padding
        self.groups = groups
        fan_in = in_features // groups * kernel_size * kernel_size
        self.weight = nn.Parameter(tinit.torch_conv_kernel_init(
            (features, in_features // groups, kernel_size, kernel_size),
            generator))
        self.bias = nn.Parameter(tinit.torch_bias_init(
            fan_in, (features,), generator)) if use_bias else None
        self._init_spectral(features, sn_eps, generator)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight_sn().to(x.dtype), bias,
                        padding=self.padding, groups=self.groups)


class SNDense(_SpectralNorm):
    """Linear + spectral norm; weight (out, in) is the JAX kernel's transpose."""

    def __init__(self, in_features, features, use_bias=True, sn_eps=1e-4,
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(tinit.torch_conv_kernel_init(
            (features, in_features), generator))
        self.bias = nn.Parameter(tinit.torch_bias_init(
            in_features, (features,), generator)) if use_bias else None
        self._init_spectral(features, sn_eps, generator)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight_sn().to(x.dtype), bias)
