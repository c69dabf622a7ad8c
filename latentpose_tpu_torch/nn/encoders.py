"""The downsampling encoder tower of the FSTH family (port of
``latentpose_tpu/nn/encoders.py``): a stem, strided ResBlocks without a
norm, then a spatial sum."""

from __future__ import annotations

import torch
import torch.nn as nn

from latentpose_tpu_torch.nn.blocks import ResBlock
from latentpose_tpu_torch.ops.image import avg_pool_2x
from latentpose_tpu_torch.ops.spectral_norm import SNConv


class SumPoolEncoder(nn.Module):
    """stem (SNConv3x3 -> ReLU -> SNConv3x3 -> AvgPool2, plus an SNConv1x1
    -> AvgPool2 skip) -> ``num_blocks - 1`` strided ResBlocks (norm 'none':
    the shortcut sees relu(x), the reference's in-place ReLU), each doubling
    the channels up to ``max_num_channels``, the last widening to
    ``out_features`` -> ReLU -> sum over H and W.

    Takes NCHW x (``channels_last``); returns (features (B, out_features),
    the feature maps after the stem and each block)."""

    def __init__(self, in_channels=6, num_channels=64, max_num_channels=512,
                 out_features=512, num_blocks=6, padding="zero",
                 generator=None):
        super().__init__()
        g = generator
        self.out_features = out_features
        self.stem_conv0 = SNConv(in_channels, num_channels, 3, 1, True,
                                 generator=g)
        self.stem_conv1 = SNConv(num_channels, num_channels, 3, 1, True,
                                 generator=g)
        self.stem_skip = SNConv(in_channels, num_channels, 1, 0, True,
                                generator=g)
        self.num_blocks = num_blocks
        in_ch = num_channels
        for i in range(1, num_blocks):
            out_ch = out_features if i == num_blocks - 1 \
                else min(in_ch * 2, max_num_channels)
            self.add_module(f"block{i}", ResBlock(
                in_ch, out_ch, norm_layer="none", downsample=True,
                padding=padding, generator=g))
            in_ch = out_ch

    def forward(self, x, update_stats: bool = False):
        upd = update_stats
        h = self.stem_conv1(torch.relu(self.stem_conv0(x, upd)), upd)
        out = avg_pool_2x(h) + avg_pool_2x(self.stem_skip(x, upd))
        feats = [out]
        for i in range(1, self.num_blocks):
            out = getattr(self, f"block{i}")(out, update_stats=upd)
            feats.append(out)
        return torch.relu(out).sum(dim=(2, 3)), feats
