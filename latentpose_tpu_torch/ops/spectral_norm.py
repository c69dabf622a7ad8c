"""Spectral-normalised conv, linear and embedding layers (port of
``SNConv`` / ``SNDense`` / ``SNEmbed`` in ``latentpose_tpu/ops/spectral_norm.py``).

The weight is viewed as the 2-D matrix W of torch's ``spectral_norm``:
(O, I·kh·kw) of the OIHW conv kernel, (out, in) of the linear weight,
(num, dim) of the embedding table.  The power-iteration state (u, v) is a
pair of buffers (the checkpoint's ``spectral`` collection).  A forward with
``update_stats=True`` first runs one power iteration, ``v = normalize(Wᵀu);
u = normalize(W v)``, without gradient and in place on the buffers (the
JAX package returns the new state instead), as torch's training-mode hook
does; without it the stored (u, v) are used as they are.  Then W is divided
by σ = uᵀ(W v), computed in f32, through which the gradient reaches W.
Serving could fold W/σ into the weight once at load time; this port
recomputes σ in each forward (one matrix-vector product per layer).

Parameters stay f32; a forward casts the normalised weight to the input's
dtype, as the JAX layers do under bf16.

``SNConv(quantize='int8' | 'int8_static')`` is drive's int8 path
(``ops/quant.py``): the JAX package's ``_QuantConvMixin``.  Each such conv
holds a per-input-channel ``act_absmax`` buffer, the running maximum of
|x| that a calibration pass (:func:`calibrating`) records.  The static conv
quantizes its input with it; in the dynamic conv it is not part of the
module's state, so the float, dynamic and calibrated-dynamic modules load
the same checkpoint.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from latentpose_tpu_torch.ops import initializers as tinit
from latentpose_tpu_torch.ops import quant
from latentpose_tpu_torch.ops.image import (depth_to_space, s2d_up_kernel,
                                            upsample_nearest_2x)

QUANTIZE = ("", "int8", "int8_static")


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

    def weight_sn(self, update_stats: bool = False):
        """W / σ with σ = uᵀ (W v) in f32 from the stored (u, v), after one
        power iteration on them if ``update_stats``."""
        w2d = self.weight.reshape(self.weight.shape[0], -1).float()
        if update_stats:
            with torch.no_grad():
                v = _l2_normalize(w2d.T @ self.u, self.sn_eps)
                self.u.copy_(_l2_normalize(w2d @ v, self.sn_eps))
                self.v.copy_(v)
        # copies: a later forward updates the buffers in place, and autograd
        # keeps these for the backward of this one
        sigma = self.u.clone() @ (w2d @ self.v.clone())
        return self.weight / sigma.to(self.weight.dtype)


class SNConv(_SpectralNorm):
    """Conv2d + spectral norm on NCHW tensors; ``padding`` is zero padding.

    ``quantize``: '' (float), 'int8' (dynamic activation scale) or
    'int8_static' (the calibrated ``act_absmax``).  Quantized convs are
    dense (``groups`` 1)."""

    def __init__(self, in_features, features, kernel_size=3, padding=1,
                 use_bias=True, groups=1, sn_eps=1e-4, generator=None,
                 quantize=""):
        super().__init__()
        if quantize not in QUANTIZE:
            raise ValueError(f"quantize must be one of {QUANTIZE}, got "
                             f"{quantize!r}")
        if quantize and groups != 1:
            raise ValueError("the int8 path supports dense convs only")
        self.padding = padding
        self.groups = groups
        self.features = features
        self.quantize = quantize
        self.calibrating = False
        fan_in = in_features // groups * kernel_size * kernel_size
        self.weight = nn.Parameter(tinit.torch_conv_kernel_init(
            (features, in_features // groups, kernel_size, kernel_size),
            generator))
        self.bias = nn.Parameter(tinit.torch_bias_init(
            fan_in, (features,), generator)) if use_bias else None
        self._init_spectral(features, sn_eps, generator)
        if quantize:
            self.register_buffer("act_absmax", torch.zeros(in_features),
                                 persistent=quantize == "int8_static")

    def forward(self, x, update_stats: bool = False,
                upsample_2x: bool = False):
        """``upsample_2x``: nearest-up-2x before the conv; the int8 path
        convolves the low-resolution x with the polyphase kernel instead
        (3x3, zero pad 1)."""
        weight = self.weight_sn(update_stats)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if not self.quantize:
            if upsample_2x:
                x = upsample_nearest_2x(x)
            return F.conv2d(x, weight.to(x.dtype), bias,
                            padding=self.padding, groups=self.groups)
        if upsample_2x:
            if weight.shape[2:] != (3, 3) or self.padding != 1:
                raise ValueError("the int8 upsample conv needs a 3x3 kernel "
                                 "with zero padding 1")
            weight = s2d_up_kernel(weight)
        y = self._quant_conv(x, weight.to(x.dtype))
        if upsample_2x:
            y = depth_to_space(y, self.features)
        return y if bias is None else y + bias[:, None, None]

    def _quant_conv(self, x, kernel):
        if self.calibrating:
            with torch.no_grad():
                torch.maximum(self.act_absmax,
                              quant.act_absmax_per_channel(x),
                              out=self.act_absmax)
        elif self.quantize == "int8_static":
            return quant.conv2d_int8_static(x, kernel, self.act_absmax,
                                            self.padding, x.dtype)
        return quant.conv2d_int8(x, kernel, self.padding, x.dtype)


def quantized_convs(module):
    """{name: SNConv} of every quantized conv in ``module``."""
    return {name: m for name, m in module.named_modules()
            if isinstance(m, SNConv) and m.quantize}


@contextlib.contextmanager
def calibrating(module):
    """Inside, every quantized conv of ``module`` raises its ``act_absmax``
    to the per-input-channel maximum of |x| that it sees, and computes with
    the dynamic scale (the JAX package's calibration pass runs the dynamic
    module with the ``quant_calib`` collection mutable)."""
    convs = quantized_convs(module).values()
    for conv in convs:
        conv.calibrating = True
    try:
        yield
    finally:
        for conv in convs:
            conv.calibrating = False


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

    def forward(self, x, update_stats: bool = False):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight_sn(update_stats).to(x.dtype), bias)


class SNEmbed(_SpectralNorm):
    """Embedding table (num, dim) with spectral norm over the whole table;
    init U(-0.1, 0.1) (the reference discriminator's projection matrix)."""

    def __init__(self, num_embeddings, features, sn_eps=1e-4, generator=None):
        super().__init__()
        table = torch.empty(num_embeddings, features)
        table.uniform_(-0.1, 0.1, generator=generator)
        self.weight = nn.Parameter(table)
        self._init_spectral(num_embeddings, sn_eps, generator)

    def forward(self, labels, update_stats: bool = False):
        return self.weight_sn(update_stats)[labels]
