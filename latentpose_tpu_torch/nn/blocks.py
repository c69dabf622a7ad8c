"""The block library (port of ``latentpose_tpu/nn/blocks.py``): the
generator's ``ResBlock``, and the variants that no model of the registry
builds (``ShuffleConv``, ``ResBlockShuffle``, ``ResBlockV2``,
``ResBlockV2Shuffle``, ``ResBlockNoSpectralNorm``, ``GatedBlock``,
``GatedResBlock``, ``MobileNetBlock``, ``SelfAttention``), each under the
JAX module's name and with its parameter names.

Modules work on NCHW tensors in ``channels_last`` memory format: cuDNN's
convolutions run on them, and ``permute(0, 2, 3, 1)`` hands the AdaIN kernel
a contiguous NHWC buffer without a copy.  Every instance norm, adaptive
('adain') or with shared affine parameters ('in'), is one call of the fused
kernel (:func:`norm_relu`), with the ReLU that follows it fused in where
there is one.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from latentpose_tpu_torch.ops.adain import adain
from latentpose_tpu_torch.ops.image import avg_pool_2x, upsample_nearest_2x
from latentpose_tpu_torch.ops.spectral_norm import SNConv


def norm_relu(x, weight, bias, eps: float = 1e-4, relu: bool = True):
    """ReLU(IN(x) * weight + bias) on NCHW x through the fused AdaIN kernel
    (without the ReLU if ``relu`` is false); weight and bias (B, C).
    Returns NCHW in ``channels_last``."""
    x = x.contiguous(memory_format=torch.channels_last)
    y = adain(x.permute(0, 2, 3, 1), weight.to(x.dtype), bias.to(x.dtype),
              relu=relu, eps=eps)
    return y.permute(0, 3, 1, 2)


class InstanceNormAffine(nn.Module):
    """InstanceNorm2d(affine=True, eps=1e-4) parameters (weight 1, bias 0)."""

    def __init__(self, features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))


def _check_norm(norm_layer):
    if norm_layer not in ("none", "in", "adain"):
        raise ValueError(f"norm_layer must be none|in|adain, got {norm_layer!r}")


class _Norms(nn.Module):
    """The norms of a block: 'in' holds ``norm0``, ``norm1``, ... as
    :class:`InstanceNormAffine`; 'adain' takes each (weight, bias) as a
    call argument; 'none' normalises nothing."""

    def _add_norms(self, norm_layer, *features):
        _check_norm(norm_layer)
        self.norm_layer = norm_layer
        if norm_layer == "in":
            for idx, f in enumerate(features):
                setattr(self, f"norm{idx}", InstanceNormAffine(f))

    def _norm(self, h, idx, ada, relu):
        """Norm ``idx`` of h, then a ReLU if ``relu``; one kernel call."""
        if self.norm_layer == "none":
            return torch.relu(h) if relu else h
        if self.norm_layer == "in":
            norm = getattr(self, f"norm{idx}")
            shape = (h.shape[0], -1)
            weight, bias = norm.weight.expand(shape), norm.bias.expand(shape)
        elif ada is None:
            raise ValueError(f"adain {type(self).__name__} needs "
                             f"ada{idx}=(weight, bias)")
        else:
            weight, bias = ada
        return norm_relu(h, weight, bias, self.eps, relu)

    def _norm_act(self, h, idx, ada, activation):
        """Norm ``idx`` of h, then ``activation`` (a ReLU fused in)."""
        if activation in (torch.relu, F.relu):
            return self._norm(h, idx, ada, True)
        return activation(self._norm(h, idx, ada, False))


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


def channel_shuffle(x, groups: int):
    """ShuffleNet's channel shuffle of NCHW x: channel ``g * (C // groups)
    + j`` moves to ``j * groups + g``, the permutation the JAX package
    applies to the last axis of NHWC x."""
    b, c, h, w = x.shape
    x = x.reshape(b, groups, c // groups, h, w).transpose(1, 2)
    return x.reshape(b, c, h, w)


class ShuffleConv(nn.Module):
    """ShuffleNet-style factorised conv: where both channel counts divide
    ``groups``, SN-grouped 1x1 (``conv0``) -> ReLU6 -> channel shuffle ->
    SN-grouped 3x3 pad 1 (``conv1``) -> ReLU6 -> SN-grouped 1x1
    (``conv2``), each with a bias; otherwise one SN 3x3 pad 1 (``conv``)."""

    def __init__(self, in_features, out_features, groups=4, generator=None):
        super().__init__()
        self.groups = groups
        self.grouped = in_features % groups == 0 and out_features % groups == 0
        if self.grouped:
            self.conv0 = SNConv(in_features, out_features, 1, 0,
                                groups=groups, generator=generator)
            self.conv1 = SNConv(out_features, out_features, 3, 1,
                                groups=groups, generator=generator)
            self.conv2 = SNConv(out_features, out_features, 1, 0,
                                groups=groups, generator=generator)
        else:
            self.conv = SNConv(in_features, out_features, 3, 1,
                               generator=generator)

    def forward(self, x, update_stats: bool = False):
        if not self.grouped:
            return self.conv(x, update_stats)
        h = F.relu6(self.conv0(x, update_stats))
        h = channel_shuffle(h, self.groups)
        h = F.relu6(self.conv1(h, update_stats))
        return self.conv2(h, update_stats)


class ResBlockShuffle(_Norms):
    """ResBlock with a :class:`ShuffleConv` for each conv: [norm0] -> ReLU
    -> [up x2] -> ``sc0`` -> [norm1] -> ReLU -> ``sc1`` -> [down avgpool2];
    the skip (if in != out or up or down) [up x2] -> ``skip`` (a
    ShuffleConv) -> [down].  Without a norm the shortcut sees relu(x), as
    in :class:`ResBlock`."""

    def __init__(self, in_features, out_features, norm_layer="none",
                 upsample=False, downsample=False, eps=1e-4, generator=None):
        super().__init__()
        self._add_norms(norm_layer, in_features, out_features)
        self.upsample, self.downsample, self.eps = upsample, downsample, eps
        self.sc0 = ShuffleConv(in_features, out_features, generator=generator)
        self.sc1 = ShuffleConv(out_features, out_features,
                               generator=generator)
        self.skip = None
        if in_features != out_features or upsample or downsample:
            self.skip = ShuffleConv(in_features, out_features,
                                    generator=generator)

    def forward(self, x, ada0=None, ada1=None, update_stats: bool = False):
        h = self._norm(x, 0, ada0, True)
        shortcut_in = h if self.norm_layer == "none" else x
        if self.upsample:
            h = upsample_nearest_2x(h)
        h = self._norm(self.sc0(h, update_stats), 1, ada1, True)
        h = self.sc1(h, update_stats)
        if self.downsample:
            h = avg_pool_2x(h)
        if self.skip is None:
            return h + shortcut_in
        if self.upsample:
            shortcut_in = upsample_nearest_2x(shortcut_in)
        s = self.skip(shortcut_in, update_stats)
        return h + (avg_pool_2x(s) if self.downsample else s)


class ResBlockV2(_Norms):
    """Pre-activation residual block with the activation a constructor
    argument and the resize by name (``resize_layer`` 'none' | 'nearest' |
    'avgpool'): [norm0] -> act -> [up x2] -> SNConv3x3 (``conv0``) ->
    [norm1] -> act -> SNConv3x3 (``conv1``) -> [down]; the skip SNConv1x1
    (``skip``, bias) -> [up] -> [down] of x itself.  Conv biases only
    without a norm."""

    MAIN = ("conv0", "conv1")

    def __init__(self, in_features, out_features, resize_layer="none",
                 norm_layer="none", activation=torch.relu, eps=1e-4,
                 generator=None):
        super().__init__()
        if resize_layer not in ("none", "nearest", "avgpool"):
            raise ValueError("resize_layer must be none|nearest|avgpool, got "
                             f"{resize_layer!r}")
        self._add_norms(norm_layer, in_features, out_features)
        self.upsample = resize_layer == "nearest"
        self.downsample = resize_layer == "avgpool"
        self.activation, self.eps = activation, eps
        self._convs(in_features, out_features, generator)

    def _convs(self, in_features, out_features, generator):
        bias = self.norm_layer == "none"
        self.conv0 = SNConv(in_features, out_features, 3, 1, bias,
                            generator=generator)
        self.conv1 = SNConv(out_features, out_features, 3, 1, bias,
                            generator=generator)
        self.skip = None
        if in_features != out_features or self.upsample or self.downsample:
            self.skip = SNConv(in_features, out_features, 1, 0, True,
                               generator=generator)

    def _skip(self, x, update_stats):
        s = self.skip(x, update_stats)
        return upsample_nearest_2x(s) if self.upsample else s

    def forward(self, x, ada0=None, ada1=None, update_stats: bool = False):
        conv0, conv1 = (getattr(self, name) for name in self.MAIN)
        h = self._norm_act(x, 0, ada0, self.activation)
        if self.upsample:
            h = upsample_nearest_2x(h)
        h = self._norm_act(conv0(h, update_stats), 1, ada1, self.activation)
        h = conv1(h, update_stats)
        if self.downsample:
            h = avg_pool_2x(h)
        if self.skip is None:
            return h + x
        s = self._skip(x, update_stats)
        return h + (avg_pool_2x(s) if self.downsample else s)


class ResBlockV2Shuffle(ResBlockV2):
    """:class:`ResBlockV2` with a :class:`ShuffleConv` for each conv
    (``sc0``, ``sc1``; the skip upsamples x first)."""

    MAIN = ("sc0", "sc1")

    def _convs(self, in_features, out_features, generator):
        self.sc0 = ShuffleConv(in_features, out_features, generator=generator)
        self.sc1 = ShuffleConv(out_features, out_features,
                               generator=generator)
        self.skip = None
        if in_features != out_features or self.upsample or self.downsample:
            self.skip = ShuffleConv(in_features, out_features,
                                    generator=generator)

    def _skip(self, x, update_stats):
        if self.upsample:
            x = upsample_nearest_2x(x)
        return self.skip(x, update_stats)


class ResBlockNoSpectralNorm(_Norms):
    """:class:`ResBlock`'s dataflow with plain convs (``conv0``, ``conv1``
    3x3 pad 1, biases only without a norm; ``skip`` 1x1 with a bias, after
    the upsample).  Without a norm the shortcut sees relu(x)."""

    def __init__(self, in_features, out_features, norm_layer="none",
                 upsample=False, downsample=False, eps=1e-4):
        super().__init__()
        self._add_norms(norm_layer, in_features, out_features)
        self.upsample, self.downsample, self.eps = upsample, downsample, eps
        bias = norm_layer == "none"
        self.conv0 = nn.Conv2d(in_features, out_features, 3, padding=1,
                               bias=bias)
        self.conv1 = nn.Conv2d(out_features, out_features, 3, padding=1,
                               bias=bias)
        self.skip = None
        if in_features != out_features or upsample or downsample:
            self.skip = nn.Conv2d(in_features, out_features, 1)

    def forward(self, x, ada0=None, ada1=None, update_stats: bool = False):
        h = self._norm(x, 0, ada0, True)
        shortcut_in = h if self.norm_layer == "none" else x
        if self.upsample:
            h = upsample_nearest_2x(h)
        h = self._norm(self.conv0(h), 1, ada1, True)
        h = self.conv1(h)
        if self.downsample:
            h = avg_pool_2x(h)
        if self.skip is None:
            return h + shortcut_in
        if self.upsample:
            shortcut_in = upsample_nearest_2x(shortcut_in)
        s = self.skip(shortcut_in)
        return h + (avg_pool_2x(s) if self.downsample else s)


class GatedBlock(nn.Module):
    """act(conv(x)) * sigmoid(gate(x)): two SN convs (``conv``, ``gate``),
    each normalised by its own σ, so they are not one conv of 2C outputs."""

    def __init__(self, in_features, out_features, kernel_size=3, padding=0,
                 use_bias=True, activation=torch.relu, generator=None):
        super().__init__()
        self.activation = activation
        self.conv = SNConv(in_features, out_features, kernel_size, padding,
                           use_bias, generator=generator)
        self.gate = SNConv(in_features, out_features, kernel_size, padding,
                           use_bias, generator=generator)

    def forward(self, x, update_stats: bool = False):
        return self.activation(self.conv(x, update_stats)) \
            * torch.sigmoid(self.gate(x, update_stats))


class GatedResBlock(_Norms):
    """Residual block of two :class:`GatedBlock` s: [norm0] -> [up x2] ->
    pad 1 -> ``gated0`` 3x3 -> [norm1] -> pad 1 -> ``gated1`` 3x3 -> [down];
    the skip [up x2] -> ``skip`` (a 1x1 GatedBlock with biases) -> [down] of
    x.  The norms have no activation after them (it lives in the gated
    blocks); conv biases only without a norm."""

    def __init__(self, in_features, out_features, norm_layer="none",
                 upsample=False, downsample=False, padding="zero", eps=1e-4,
                 generator=None):
        super().__init__()
        if padding not in ("zero", "reflection"):
            raise ValueError(f"padding must be zero|reflection, got {padding!r}")
        self._add_norms(norm_layer, in_features, out_features)
        self.upsample, self.downsample, self.eps = upsample, downsample, eps
        self.pad_mode = "reflect" if padding == "reflection" else "constant"
        bias = norm_layer == "none"
        self.gated0 = GatedBlock(in_features, out_features, 3, 0, bias,
                                 generator=generator)
        self.gated1 = GatedBlock(out_features, out_features, 3, 0, bias,
                                 generator=generator)
        self.skip = None
        if in_features != out_features or upsample or downsample:
            self.skip = GatedBlock(in_features, out_features, 1, 0, True,
                                   generator=generator)

    def _pad(self, h):
        return F.pad(h, (1, 1, 1, 1), mode=self.pad_mode)

    def forward(self, x, ada0=None, ada1=None, update_stats: bool = False):
        h = self._norm(x, 0, ada0, False)
        if self.upsample:
            h = upsample_nearest_2x(h)
        h = self._norm(self.gated0(self._pad(h), update_stats), 1, ada1,
                       False)
        h = self.gated1(self._pad(h), update_stats)
        if self.downsample:
            h = avg_pool_2x(h)
        if self.skip is None:
            return h + x
        s = self.skip(upsample_nearest_2x(x) if self.upsample else x,
                      update_stats)
        return h + (avg_pool_2x(s) if self.downsample else s)


class MobileNetBlock(nn.Module):
    """Depthwise-separable residual block with plain convs: ``expand`` 1x1
    -> [norm0] -> ReLU6 -> [up x2] -> ``depthwise`` 3x3 (stride 2 when
    downsampling) -> [norm1] -> ReLU6 -> ``project`` 1x1 -> [norm2]; the
    skip [up x2] -> ``skip`` 1x1 -> [down avgpool2] of x.  With a norm,
    norm0 and norm1 are :class:`InstanceNormAffine` ('adain' too); norm2 is
    one as well for 'in', and adaptive (``ada2``) for 'adain'."""

    def __init__(self, in_features, out_features, norm_layer="none",
                 upsample=False, downsample=False, expansion=6, eps=1e-4):
        super().__init__()
        _check_norm(norm_layer)
        self.norm_layer = norm_layer
        self.upsample, self.downsample, self.eps = upsample, downsample, eps
        hidden = int(in_features * expansion)
        self.expand = nn.Conv2d(in_features, hidden, 1)
        self.depthwise = nn.Conv2d(hidden, hidden, 3, 2 if downsample else 1,
                                   1, groups=hidden)
        self.project = nn.Conv2d(hidden, out_features, 1)
        if norm_layer != "none":
            self.norm0 = InstanceNormAffine(hidden)
            self.norm1 = InstanceNormAffine(hidden)
        if norm_layer == "in":
            self.norm2 = InstanceNormAffine(out_features)
        self.skip = None
        if in_features != out_features or upsample or downsample:
            self.skip = nn.Conv2d(in_features, out_features, 1)

    def _in(self, h, norm):
        shape = (h.shape[0], -1)
        return norm_relu(h, norm.weight.expand(shape),
                         norm.bias.expand(shape), self.eps, relu=False)

    def forward(self, x, ada2=None, update_stats: bool = False):
        h = self.expand(x)
        if self.norm_layer != "none":
            h = self._in(h, self.norm0)
        h = F.relu6(h)
        if self.upsample:
            h = upsample_nearest_2x(h)
        h = self.depthwise(h)
        if self.norm_layer != "none":
            h = self._in(h, self.norm1)
        h = self.project(F.relu6(h))
        if self.norm_layer == "in":
            h = self._in(h, self.norm2)
        elif self.norm_layer == "adain":
            if ada2 is None:
                raise ValueError("adain MobileNetBlock needs "
                                 "ada2=(weight, bias)")
            h = norm_relu(h, *ada2, self.eps, relu=False)
        if self.skip is None:
            return h + x
        s = self.skip(upsample_nearest_2x(x) if self.upsample else x)
        return h + (avg_pool_2x(s) if self.downsample else s)


class SelfAttention(nn.Module):
    """SAGAN self-attention: plain 1x1 convs ``query``, ``key`` (C -> C/8)
    and ``value`` (C -> C), softmax over the positions of the query-key
    products (in f32), and a gate ``gamma`` (initialised 0) on the
    attended values, added to x."""

    def __init__(self, features):
        super().__init__()
        self.query = nn.Conv2d(features, features // 8, 1)
        self.key = nn.Conv2d(features, features // 8, 1)
        self.value = nn.Conv2d(features, features, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x, update_stats: bool = False):
        b, c, h, w = x.shape
        f = self.query(x).flatten(2)              # (B, C/8, HW)
        g = self.key(x).flatten(2)
        v = self.value(x).flatten(2)              # (B, C, HW)
        attn = torch.softmax(torch.einsum("bci,bcj->bij", f.float(),
                                          g.float()), dim=-1)
        out = torch.einsum("bij,bcj->bci", attn.to(v.dtype), v)
        return self.gamma.to(x.dtype) * out.reshape(b, c, h, w) + x
