"""ArcFace LResNet100E-IR identity descriptor (port of
``latentpose_tpu/eval/arcface.py``).

IR units (BN -> conv3x3 -> BN -> PReLU -> conv3x3(stride) -> BN, plus the
input or its 1x1(stride)+BN shortcut), [3, 13, 30, 3] stages of 64..512
features, a BN -> dropout -> FC -> BN head; 112² input preprocessed as
``(x - 127.5) / 128``.  Attribute paths mirror the flax tree, so
``arcface_r100.npz`` loads into both packages (``utils/weights.py``).
Eval form only: BatchNorm from its running statistics (eps 2e-5), dropout
off.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

BN_EPS = 2e-5


def _bn(features, dims=2):
    return (nn.BatchNorm2d if dims == 2 else nn.BatchNorm1d)(
        features, eps=BN_EPS)


def _conv3x3(cin, cout, stride=1):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class PReLU(nn.Module):
    """x where x >= 0, else x * alpha[c] (flax's ``alpha``, init 0.25)."""

    def __init__(self, features):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, x * self.alpha.view(1, -1, 1, 1))


class IRBlock(nn.Module):
    def __init__(self, in_features, features, stride=1,
                 has_shortcut_conv=False):
        super().__init__()
        self.bn1 = _bn(in_features)
        self.conv1 = _conv3x3(in_features, features)
        self.bn2 = _bn(features)
        self.prelu = PReLU(features)
        self.conv2 = _conv3x3(features, features, stride)
        self.bn3 = _bn(features)
        self.has_shortcut_conv = has_shortcut_conv
        if has_shortcut_conv:
            # flax's 1x1 'SAME' at stride 2 pads nothing
            self.conv1sc = nn.Conv2d(in_features, features, 1, stride=stride,
                                     bias=False)
            self.sc = _bn(features)

    def forward(self, x):
        h = self.conv1(self.bn1(x))
        h = self.conv2(self.prelu(self.bn2(h)))
        h = self.bn3(h)
        if self.has_shortcut_conv:
            x = self.sc(self.conv1sc(x))
        return h + x


class ArcFaceR100(nn.Module):
    """LResNet100E-IR: the 512-d descriptor (not normalized) of (B, 112,
    112, 3) uint8 images."""

    def __init__(self, embedding_size: int = 512,
                 stage_blocks: Sequence[int] = (3, 13, 30, 3),
                 stage_features: Sequence[int] = (64, 128, 256, 512),
                 input_size: int = 112):
        super().__init__()
        self.conv0 = _conv3x3(3, 64)
        self.bn0 = _bn(64)
        self.prelu0 = PReLU(64)
        in_features = 64
        self.units = []
        for s, (blocks, features) in enumerate(zip(stage_blocks,
                                                   stage_features)):
            for i in range(blocks):
                stride = 2 if i == 0 else 1
                name = f"stage{s + 1}_unit{i + 1}"
                setattr(self, name, IRBlock(
                    in_features, features, stride,
                    has_shortcut_conv=stride != 1 or in_features != features))
                self.units.append(name)
                in_features = features
        self.bn1 = _bn(in_features)
        side = input_size >> len(stage_blocks)
        self.fc1 = nn.Linear(side * side * in_features, embedding_size)
        self.fc1_bn = _bn(embedding_size, dims=1)

    def forward(self, images_uint8):
        x = (images_uint8.float() - 127.5) / 128.0
        h = x.permute(0, 3, 1, 2)
        h = self.prelu0(self.bn0(self.conv0(h)))
        for name in self.units:
            h = getattr(self, name)(h)
        h = self.bn1(h)
        # flax flattens (B, H, W, C): the same order here
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self.fc1_bn(self.fc1(h))


def normalize_embeddings(emb):
    return emb / torch.linalg.norm(emb, dim=-1, keepdim=True).clamp_min(1e-12)
