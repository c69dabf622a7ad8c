"""Residual block of the generator (port of ``ResBlock`` in
``latentpose_tpu/nn/blocks.py``).

Modules work on NCHW tensors in ``channels_last`` memory format: cuDNN's
convolutions run on them, and ``permute(0, 2, 3, 1)`` hands the AdaIN kernel
a contiguous NHWC buffer without a copy.  Every norm in the block is followed
by a ReLU, so each one is a single call of the fused kernel
(:func:`norm_relu`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from latentpose_tpu_torch.ops.adain import adain
from latentpose_tpu_torch.ops.image import avg_pool_2x, upsample_nearest_2x
from latentpose_tpu_torch.ops.spectral_norm import SNConv


def norm_relu(x, weight, bias, eps: float = 1e-4):
    """ReLU(IN(x) * weight + bias) on NCHW x through the fused AdaIN kernel;
    weight and bias (B, C).  Returns NCHW in ``channels_last``."""
    x = x.contiguous(memory_format=torch.channels_last)
    y = adain(x.permute(0, 2, 3, 1), weight.to(x.dtype), bias.to(x.dtype),
              relu=True, eps=eps)
    return y.permute(0, 3, 1, 2)


class InstanceNormAffine(nn.Module):
    """InstanceNorm2d(affine=True, eps=1e-4) parameters (weight 1, bias 0)."""

    def __init__(self, features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))


class ResBlock(nn.Module):
    """Pre-activation residual block.

    main: [norm0] -> ReLU -> [up x2] -> SNConv3x3 -> [norm1] -> ReLU
          -> SNConv3x3 -> [down avgpool2]
    skip (if in != out or up or down): SNConv1x1(bias) -> [up x2] -> [down]

    ``norm_layer``: 'none' | 'in' | 'adain'; conv biases only without a norm.
    With 'adain' the per-sample (weight, bias) pairs of the two norms are
    call arguments.  The 1x1 skip conv runs at the low resolution, then the
    result is upsampled (the two commute).

    ``quantize`` ('int8' | 'int8_static', ``ops/quant.py``) quantizes conv0,
    conv1 and the skip.  With zero padding the int8 upsample conv0 is the
    polyphase int8 conv at the low resolution, interleaved, then norm1: the
    JAX package applies norm1 before the interleave, over the same values.
    """

    def __init__(self, in_features, out_features, norm_layer="none",
                 upsample=False, downsample=False, padding="zero", eps=1e-4,
                 generator=None, quantize=""):
        super().__init__()
        if norm_layer not in ("none", "in", "adain"):
            raise ValueError(f"norm_layer must be none|in|adain, got {norm_layer!r}")
        if padding not in ("zero", "reflection"):
            raise ValueError(f"padding must be zero|reflection, got {padding!r}")
        self.norm_layer = norm_layer
        self.upsample = upsample
        self.downsample = downsample
        self.reflect = padding == "reflection"
        self.eps = eps
        conv_bias = norm_layer == "none"
        conv_pad = 0 if self.reflect else 1
        if norm_layer == "in":
            self.norm0 = InstanceNormAffine(in_features)
        self.conv0 = SNConv(in_features, out_features, 3, conv_pad, conv_bias,
                            generator=generator, quantize=quantize)
        if norm_layer == "in":
            self.norm1 = InstanceNormAffine(out_features)
        self.conv1 = SNConv(out_features, out_features, 3, conv_pad, conv_bias,
                            generator=generator, quantize=quantize)
        self.skip = None
        if in_features != out_features or upsample or downsample:
            self.skip = SNConv(in_features, out_features, 1, 0, True,
                               generator=generator, quantize=quantize)

    def _norm_relu(self, h, idx, ada):
        if self.norm_layer == "none":
            return torch.relu(h)
        if self.norm_layer == "in":
            norm = getattr(self, f"norm{idx}")
            shape = (h.shape[0], -1)
            weight, bias = norm.weight.expand(shape), norm.bias.expand(shape)
        elif ada is None:
            raise ValueError(f"adain ResBlock needs ada{idx}=(weight, bias)")
        else:
            weight, bias = ada
        return norm_relu(h, weight, bias, self.eps)

    def _pad(self, h):
        return F.pad(h, (1, 1, 1, 1), mode="reflect") if self.reflect else h

    def forward(self, x, ada0=None, ada1=None, update_stats: bool = False):
        """``update_stats``: one spectral-norm power iteration per conv."""
        h = self._norm_relu(x, 0, ada0)
        # without a norm the reference's in-place ReLU also rewrote the
        # block input, so the shortcut sees relu(x); with a norm it sees x
        shortcut_in = h if self.norm_layer == "none" else x
        if self.upsample and not self.reflect:
            h = self.conv0(h, update_stats, upsample_2x=True)
        else:
            if self.upsample:
                h = upsample_nearest_2x(h)
            h = self.conv0(self._pad(h), update_stats)
        h = self._norm_relu(h, 1, ada1)
        h = self.conv1(self._pad(h), update_stats)
        if self.downsample:
            h = avg_pool_2x(h)
        if self.skip is None:
            return h + shortcut_in
        s = self.skip(shortcut_in, update_stats)
        if self.upsample:
            s = upsample_nearest_2x(s)
        if self.downsample:
            s = avg_pool_2x(s)
        return h + s
