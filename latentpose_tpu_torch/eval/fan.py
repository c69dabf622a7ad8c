"""FAN 68-landmark detector, 2DFAN4 (port of ``latentpose_tpu/eval/fan.py``).

A 7x7/2 stem, three ConvBlocks, then ``num_modules`` stacked hourglasses
(depth 4, 256 features), each emitting 68 heatmaps at a quarter of the input
size; a landmark is the heatmap's argmax with the quarter-pixel refinement
toward the larger neighbour, in input pixels.  Attribute names mirror the
flax tree, so ``fan_2d.npz`` loads into both packages
(``utils/weights.py``).  Eval-form BatchNorm (eps 1e-5) throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _bn(features):
    return nn.BatchNorm2d(features, eps=1e-5)


class ConvBlock(nn.Module):
    """face-alignment's ConvBlock: three BN-ReLU-conv branches (out/2,
    out/4, out/4) concatenated, plus the input or its BN-ReLU-1x1 shortcut
    when the widths differ."""

    def __init__(self, in_features, out_features):
        super().__init__()
        o2, o4 = out_features // 2, out_features // 4
        self.bn1 = _bn(in_features)
        self.conv1 = nn.Conv2d(in_features, o2, 3, padding=1, bias=False)
        self.bn2 = _bn(o2)
        self.conv2 = nn.Conv2d(o2, o4, 3, padding=1, bias=False)
        self.bn3 = _bn(o4)
        self.conv3 = nn.Conv2d(o4, o4, 3, padding=1, bias=False)
        self.downsample = in_features != out_features
        if self.downsample:
            self.down_bn = _bn(in_features)
            self.down_conv = nn.Conv2d(in_features, out_features, 1,
                                       bias=False)

    def forward(self, x):
        b1 = self.conv1(F.relu(self.bn1(x)))
        b2 = self.conv2(F.relu(self.bn2(b1)))
        b3 = self.conv3(F.relu(self.bn3(b2)))
        out = torch.cat([b1, b2, b3], dim=1)
        if self.downsample:
            return out + self.down_conv(F.relu(self.down_bn(x)))
        return out + x


class Hourglass(nn.Module):
    def __init__(self, depth=4, features=256):
        super().__init__()
        self.depth = depth
        for n in range(depth, 0, -1):
            setattr(self, f"b1_{n}", ConvBlock(features, features))
            setattr(self, f"b2_{n}", ConvBlock(features, features))
            setattr(self, f"b3_{n}", ConvBlock(features, features))
        self.b2plus_1 = ConvBlock(features, features)

    def _level(self, n, x):
        up1 = getattr(self, f"b1_{n}")(x)
        low1 = getattr(self, f"b2_{n}")(F.avg_pool2d(x, 2, 2))
        low2 = self._level(n - 1, low1) if n > 1 else self.b2plus_1(low1)
        low3 = getattr(self, f"b3_{n}")(low2)
        # jax.image.resize "nearest": half-pixel source centres
        return up1 + F.interpolate(low3, size=up1.shape[2:],
                                   mode="nearest-exact")

    def forward(self, x):
        return self._level(self.depth, x)


class FAN(nn.Module):
    def __init__(self, num_modules=4, num_landmarks=68):
        super().__init__()
        self.num_modules = num_modules
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = _bn(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        for m in range(num_modules):
            setattr(self, f"m{m}", Hourglass(4, 256))
            setattr(self, f"top_m_{m}", ConvBlock(256, 256))
            setattr(self, f"conv_last{m}", nn.Conv2d(256, 256, 1))
            setattr(self, f"bn_end{m}", _bn(256))
            setattr(self, f"l{m}", nn.Conv2d(256, num_landmarks, 1))
            if m < num_modules - 1:
                setattr(self, f"bl{m}", nn.Conv2d(256, 256, 1))
                setattr(self, f"al{m}", nn.Conv2d(num_landmarks, 256, 1))

    def forward(self, images):
        """images: (B, 3, H, W) float in [0, 1] (256² in use).  Returns the
        ``num_modules`` heatmap stacks, each (B, 68, H/4, W/4)."""
        h = F.relu(self.bn1(self.conv1(images)))
        h = F.avg_pool2d(self.conv2(h), 2, 2)
        h = self.conv4(self.conv3(h))
        outputs = []
        previous = h
        for m in range(self.num_modules):
            ll = getattr(self, f"top_m_{m}")(getattr(self, f"m{m}")(previous))
            ll = F.relu(getattr(self, f"bn_end{m}")(
                getattr(self, f"conv_last{m}")(ll)))
            heatmaps = getattr(self, f"l{m}")(ll)
            outputs.append(heatmaps)
            if m < self.num_modules - 1:
                previous = previous + getattr(self, f"bl{m}")(ll) \
                    + getattr(self, f"al{m}")(heatmaps)
        return outputs


def heatmaps_to_landmarks(heatmaps):
    """(B, 68, h, w) heatmaps -> (B, 68, 2) (x, y) in input pixels (x4):
    the argmax (the first of equal maxima), moved a quarter pixel toward
    the larger of its two neighbours on each axis (clipped at the edge)."""
    b, n, hh, ww = heatmaps.shape
    idx = heatmaps.reshape(b, n, -1).argmax(dim=-1)
    ys, xs = idx // ww, idx % ww

    def at(y, x):
        return torch.gather(heatmaps.reshape(b, n, -1), 2,
                            (y * ww + x).unsqueeze(-1)).squeeze(-1)

    dx = torch.sign(at(ys, (xs + 1).clamp(0, ww - 1))
                    - at(ys, (xs - 1).clamp(0, ww - 1))) * 0.25
    dy = torch.sign(at((ys + 1).clamp(0, hh - 1), xs)
                    - at((ys - 1).clamp(0, hh - 1), xs)) * 0.25
    return torch.stack([xs.float() + dx, ys.float() + dy], dim=-1) * 4.0
