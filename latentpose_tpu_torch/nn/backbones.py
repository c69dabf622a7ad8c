"""Identity and pose encoder backbones: ResNeXt-50 (32x4d) and MobileNetV2
(port of ``latentpose_tpu/nn/backbones.py``).

torchvision's structure with the JAX package's attribute names (``stem_conv``,
``block3.conv1``, ``head_bn``, ``classifier``; ``layer2_0.conv3``,
``downsample_bn``, ``fc``), so a checkpoint converts by renaming and
transposing.  BatchNorm has eps 1e-5 and runs in one of two forms, chosen by
the ``train`` argument as in the JAX modules:

- eval: normalise with the running statistics;
- train: normalise with the batch's mean and biased variance (one pass,
  clamped at 0, in f32, as flax computes them) and update the running
  statistics in place with flax's momentum 0.9 (torch's 0.1) and the
  **biased** variance, where ``F.batch_norm(training=True)`` would take the
  unbiased one.

ReLU6 is ``min(relu(x), 6)``; MobileNetV2's Dropout(0.2) before the
classifier is live only in train mode, its mask drawn on the CPU so that a
card run and a CPU run from one seed drop the same features.  ResNeXt-50's
bottleneck runs its bn2 -> ReLU -> conv3 link as one call of the fused
kernel in ``ops/conv_bn.py`` in both forms: eval (fine-tune's ê, drive)
folds bn2's running statistics into the kernel's scale and offset; train
(meta-train) folds bn2's batch statistics, with their gradient, and bn3
takes its batch statistics from the kernel's (Σy, Σy²) rather than a second
pass over y.

Under N ranks, inside ``parallel.global_batch`` (the default data-parallel
regime), every train-form statistic is the global batch's: BatchNorm's
(Σx, Σx², n) and the link's (Σy, Σy², rows) are summed over the ranks in
f32, with their gradient, before the mean and variance; the running
statistics move toward those, so every rank keeps the same ones.  The
dropout mask is the rank's rows of the global batch's mask.  Outside it
(one process, the explicit regime, every eval form) each rank's own rows
give the statistics and no collective is reached.

Parameters stay f32; under bf16 a forward casts conv and linear weights to
the input's dtype.  BatchNorm on bf16 input computes what flax 0.12's
``nn.BatchNorm(dtype=bfloat16)`` computes in train form (``_compute_stats``,
``_normalize``): the statistics in f32 from the input upcast, ``(x - mean) *
(rsqrt(var + eps) * scale) + bias`` in f32, one cast to bf16 at the end; the
running statistics update in f32.  The eval form takes
``F.batch_norm`` (cuDNN on the card), which folds the statistics into one
scale and shift before its single rounding.  In the train form the link
hands bn3 its statistics from the kernel's f32 accumulator, where flax's bn3
takes them from the bf16-rounded y (ROADMAP.md C.5).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from latentpose_tpu_torch.ops import initializers as tinit
from latentpose_tpu_torch.ops.conv_bn import bn_relu_conv1x1_stats, fold_bn
from latentpose_tpu_torch.parallel import mesh as parallel


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


class Conv(nn.Conv2d):
    """Bias-free conv whose weight follows the input's dtype."""

    def __init__(self, in_features, features, kernel_size, stride=1,
                 groups=1, generator=None):
        super().__init__(in_features, features, kernel_size, stride,
                         padding=kernel_size // 2, groups=groups, bias=False)
        # torch kaiming_normal_(mode='fan_out', nonlinearity='relu')
        nn.init.kaiming_normal_(self.weight, mode="fan_out",
                                nonlinearity="relu", generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                        self.padding, self.dilation, self.groups)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d(eps=1e-5) in flax's two forms (see the module docstring);
    ``train`` is an argument of the forward, not the module's mode."""

    MOMENTUM = 0.9      # flax: running = 0.9 * running + 0.1 * batch

    def forward(self, x, train: bool = False):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mean, var = batch_moments(x)
        self.track(mean, var)
        return self.normalize(x, mean, var)

    def track(self, mean, var):
        """Move the running statistics toward a batch's (mean, biased
        variance), rounding as flax does: ``0.9 * running + 0.1 * batch``,
        each product rounded (an ``add_`` with ``alpha`` may fuse them)."""
        with torch.no_grad():
            for running, batch in ((self.running_mean, mean),
                                   (self.running_var, var)):
                running.copy_(self.MOMENTUM * running
                              + (1 - self.MOMENTUM) * batch)

    def normalize(self, x, mean, var, dim: int = 1):
        """flax's train-form normalisation of x (channels on ``dim``) by
        given batch statistics, in f32, cast back to x's dtype."""
        shape = [1] * x.dim()
        shape[dim] = -1
        y = (x.float() - mean.view(shape)) * (
            torch.rsqrt(var + self.eps) * self.weight).view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)


def batch_moments(x):
    """Per-channel mean and biased variance of NCHW ``x`` over (N, H, W),
    one pass in f32, clamped at 0, as flax computes them; over the global
    batch inside ``parallel.global_batch``."""
    if parallel.sync() is not None:
        return parallel.global_moments(x, (0, 2, 3))
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3))
    var = torch.clamp(x32.square().mean(dim=(0, 2, 3)) - mean.square(),
                      min=0.0)
    return mean, var


def _dropout(x, rate: float, generator=None):
    """Inverted dropout: keep with probability 1 - rate, scale by
    1 / (1 - rate); the mask is drawn on the CPU from ``generator`` (a CPU
    generator, or None for torch's default one), inside
    ``parallel.global_batch`` as the global batch's, of which the rank
    keeps its rows."""
    world = parallel.sync()
    if world is None:
        keep = torch.rand(x.shape, generator=generator) >= rate
    else:
        keep = torch.rand((x.shape[0] * world,) + x.shape[1:],
                          generator=generator) >= rate
        keep = keep[parallel.local_rows(keep.shape[0])]
    keep = keep.to(x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _bn(features):
    return BatchNorm(features, eps=1e-5)


class InvertedResidual(nn.Module):
    """expand 1x1 -> depthwise 3x3 -> project 1x1, each with BatchNorm."""

    def __init__(self, in_features, out_features, stride, expand_ratio,
                 generator=None):
        super().__init__()
        hidden = int(round(in_features * expand_ratio))
        self.use_res = stride == 1 and in_features == out_features
        self.expand = expand_ratio != 1
        layers = []
        if self.expand:
            layers.append(Conv(in_features, hidden, 1, generator=generator))
        layers.append(Conv(hidden, hidden, 3, stride, groups=hidden,
                           generator=generator))
        layers.append(Conv(hidden, out_features, 1, generator=generator))
        self.depth = len(layers)
        for idx, conv in enumerate(layers):
            self.add_module(f"conv{idx}", conv)
            self.add_module(f"bn{idx}", _bn(conv.out_channels))

    def forward(self, x, train: bool = False):
        h = x
        for idx in range(self.depth):
            h = getattr(self, f"bn{idx}")(getattr(self, f"conv{idx}")(h),
                                          train)
            if idx < self.depth - 1:
                h = _relu6(h)
        return x + h if self.use_res else h


class MobileNetV2(nn.Module):
    """mobilenet_v2 with a ``num_classes`` classifier (256 for pose)."""

    # (expand_ratio t, channels c, repeats n, stride s) — torchvision table
    SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))

    def __init__(self, num_classes=256, generator=None):
        super().__init__()
        self.stem_conv = Conv(3, 32, 3, 2, generator=generator)
        self.stem_bn = _bn(32)
        in_features, idx = 32, 0
        for t, c, n, s in self.SETTINGS:
            for i in range(n):
                self.add_module(f"block{idx}", InvertedResidual(
                    in_features, c, s if i == 0 else 1, t,
                    generator=generator))
                in_features, idx = c, idx + 1
        self.num_blocks = idx
        self.head_conv = Conv(in_features, 1280, 1, generator=generator)
        self.head_bn = _bn(1280)
        self.classifier = nn.Linear(1280, num_classes)
        nn.init.normal_(self.classifier.weight, 0.0, 0.01, generator=generator)
        nn.init.zeros_(self.classifier.bias)

    def forward(self, x, train: bool = False, dropout_generator=None):
        """x: (B, C, H, W) -> (B, num_classes).  ``train``: batch statistics
        (updating the running ones) and live dropout, whose mask is drawn
        from ``dropout_generator``."""
        h = _relu6(self.stem_bn(self.stem_conv(x), train))
        for idx in range(self.num_blocks):
            h = getattr(self, f"block{idx}")(h, train)
        h = _relu6(self.head_bn(self.head_conv(h), train))
        h = h.mean(dim=(2, 3))
        if train:
            h = _dropout(h, 0.2, dropout_generator)
        return F.linear(h, self.classifier.weight.to(h.dtype),
                        self.classifier.bias.to(h.dtype))


class Bottleneck(nn.Module):
    """torchvision's ResNeXt bottleneck (groups 32, base width 4):

        conv1 1x1 -> bn1 -> ReLU -> conv2 3x3 (groups, stride) -> [bn2 -> ReLU
        -> conv3 1x1] -> bn3, + shortcut (downsample conv 1x1 + bn), ReLU

    The bracketed link is one call of ``bn_relu_conv1x1_stats`` with bn2
    folded into its scale and offset: bn2's running statistics in eval
    form, its batch statistics in train form, where bn3 normalises with the
    batch statistics the link returns.  conv2 is cuDNN's native grouped conv
    (the JAX package's block-diagonal ``GroupedConv`` is a TPU layout trick
    with the same parameter layout)."""

    def __init__(self, in_features, planes, stride=1, groups=32,
                 base_width=4, has_downsample=False, generator=None):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_features = planes * 4
        self.conv1 = Conv(in_features, width, 1, generator=generator)
        self.bn1 = _bn(width)
        self.conv2 = Conv(width, width, 3, stride, groups=groups,
                          generator=generator)
        self.bn2 = _bn(width)
        self.conv3 = Conv(width, out_features, 1, generator=generator)
        self.bn3 = _bn(out_features)
        self.has_downsample = has_downsample
        if has_downsample:
            self.downsample_conv = Conv(in_features, out_features, 1, stride,
                                        generator=generator)
            self.downsample_bn = _bn(out_features)

    def forward(self, x, train: bool = False):
        h = torch.relu(self.bn1(self.conv1(x), train))
        h = self.conv2(h).contiguous(memory_format=torch.channels_last)
        bn2, bn3 = self.bn2, self.bn3
        if train:
            mean, var = batch_moments(h)
            bn2.track(mean, var)
        else:
            mean, var = bn2.running_mean, bn2.running_var
        scale, offset = fold_bn(mean, var, bn2.weight, bn2.bias, bn2.eps)
        w = self.conv3.weight.to(h.dtype)
        w = w.view(w.shape[0], w.shape[1]).t()         # (Cin, Cout) view
        y, stats = bn_relu_conv1x1_stats(h.permute(0, 2, 3, 1), scale,
                                         offset, w)
        if train:
            rows = y.numel() // y.shape[-1]
            if parallel.sync() is not None:
                # the global batch's (Σy, Σy², rows)
                mean, var = parallel.global_mean_var(stats, rows)
            else:
                mean = stats[0] / rows
                var = torch.clamp(stats[1] / rows - mean.square(), min=0.0)
            bn3.track(mean, var)
            h = bn3.normalize(y, mean, var, dim=3).permute(0, 3, 1, 2)
        else:
            h = bn3(y.permute(0, 3, 1, 2))
        if self.has_downsample:
            x = self.downsample_bn(self.downsample_conv(x), train)
        return torch.relu(h + x)


class ResNeXt50(nn.Module):
    """resnext50_32x4d with a ``num_classes`` fc (512 for identity);
    ``layers``, the bottlenecks of each stage, as the JAX module's field.
    Modules work in ``channels_last``, so the fused link sees a contiguous
    NHWC buffer without a copy.  Both forms run in the input's dtype (f32 or
    bf16)."""

    LAYERS = (3, 4, 6, 3)

    def __init__(self, num_classes=512, layers=LAYERS, generator=None):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, generator=generator)
        self.bn1 = _bn(64)
        in_features, self.names = 64, []
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                     layers)):
            for i in range(blocks):
                stride = 1 if stage == 0 or i else 2
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, Bottleneck(
                    in_features, planes, stride,
                    has_downsample=stride != 1 or in_features != planes * 4,
                    generator=generator))
                self.names.append(name)
                in_features = planes * 4
        self.fc = nn.Linear(in_features, num_classes)
        with torch.no_grad():
            self.fc.weight.copy_(tinit.torch_conv_kernel_init(
                (num_classes, in_features), generator))
            self.fc.bias.zero_()

    def forward(self, x, train: bool = False):
        """x: (B, C, H, W) -> (B, num_classes).  ``train``: batch
        statistics, updating the running ones."""
        h = x.contiguous(memory_format=torch.channels_last)
        h = torch.relu(self.bn1(self.conv1(h), train))
        h = F.max_pool2d(h, 3, 2, padding=1)
        for name in self.names:
            h = getattr(self, name)(h, train)
        h = h.mean(dim=(2, 3))
        return F.linear(h, self.fc.weight.to(h.dtype),
                        self.fc.bias.to(h.dtype))
