"""MobileNetV2 latent-pose encoder, eval form (port of ``InvertedResidual``
and ``MobileNetV2`` in ``latentpose_tpu/nn/backbones.py``).

torchvision's structure with the JAX package's attribute names (``stem_conv``,
``block3.conv1``, ``head_bn``, ``classifier``), so a checkpoint converts by
renaming and transposing.  BatchNorm uses its running statistics (eps 1e-5);
ReLU6 is ``min(relu(x), 6)``; dropout before the classifier is inactive at
eval and therefore absent.  The ResNeXt-50 identity tower is not ported yet:
drive takes identity from the fine-tuned embedding.

Parameters stay f32; under bf16 a forward casts conv and linear weights to
the input's dtype and BatchNorm runs with f32 statistics on bf16 input.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


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
    """BatchNorm2d(eps=1e-5) that always normalises with its running
    statistics (the eval form; training is a later slice)."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


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

    def forward(self, x):
        h = x
        for idx in range(self.depth):
            h = getattr(self, f"bn{idx}")(getattr(self, f"conv{idx}")(h))
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

    def forward(self, x):
        """x: (B, C, H, W) -> (B, num_classes)."""
        h = _relu6(self.stem_bn(self.stem_conv(x)))
        for idx in range(self.num_blocks):
            h = getattr(self, f"block{idx}")(h)
        h = _relu6(self.head_bn(self.head_conv(h)))
        h = h.mean(dim=(2, 3))
        return F.linear(h, self.classifier.weight.to(h.dtype),
                        self.classifier.bias.to(h.dtype))
