"""Flagship projection discriminator, RGB only (port of
``latentpose_tpu/models/discriminators/no_landmarks.py``).

- stem: SNConv3x3 -> ReLU -> SNConv3x3 -> AvgPool2, plus an SNConv1x1 ->
  AvgPool2 skip;
- min(log2(image_size) - 2, dis_num_blocks) strided ResBlocks (norm 'none'),
  the rest unstrided; the last block widens to ``embed_channels``;
- score = linear(feat_sum) + <feat_sum, W[label]> with a spectral-normalised
  per-identity embedding W (one row, ê, after fine-tuning);
- the per-block features for feature matching, with the reference's
  aliasing: every map but the last is returned after a ReLU.

Each pass with ``update_stats`` advances every spectral-norm state it
touches by one power iteration; the fine-tune step runs the embedding
lookup and three passes in the reference's order.  Images come in NHWC
(B, H, W, 3); features are NCHW (``channels_last``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from latentpose_tpu_torch.nn.blocks import ResBlock
from latentpose_tpu_torch.ops.image import avg_pool_2x
from latentpose_tpu_torch.ops.spectral_norm import SNConv, SNDense, SNEmbed


class Wrapper:
    @staticmethod
    def get_net(args, generator=None):
        return Discriminator(
            padding=args.dis_padding,
            in_channels=args.in_channels,
            num_channels=args.num_channels,
            max_num_channels=args.max_num_channels,
            embed_channels=args.embed_channels,
            num_blocks=args.dis_num_blocks,
            image_size=args.image_size,
            num_labels=args.num_labels,
            # the fine-tuned 1-row W is re-registered by the reference with
            # torch's default spectral_norm eps (1e-12)
            embed_sn_eps=1e-12 if args.finetune else 1e-4,
            generator=generator)


def plan(num_channels, max_num_channels, embed_channels, num_blocks,
         image_size):
    """Static block plan: list of (in_ch, out_ch, downsample)."""
    num_down = min(int(math.log2(image_size)) - 2, num_blocks)
    blocks, in_ch = [], num_channels
    for i in range(1, num_down):
        out_ch = min(in_ch * 2, max_num_channels)
        if i == num_blocks - 1:
            out_ch = embed_channels
        blocks.append((in_ch, out_ch, True))
        in_ch = out_ch
    for i in range(num_down, num_blocks):
        out_ch = embed_channels if i == num_blocks - 1 else in_ch
        blocks.append((in_ch, out_ch, False))
        in_ch = out_ch
    return blocks


class Discriminator(nn.Module):
    def __init__(self, padding="zero", in_channels=3, num_channels=64,
                 max_num_channels=512, embed_channels=512, num_blocks=7,
                 image_size=256, num_labels=1, embed_sn_eps=1e-4,
                 generator=None):
        super().__init__()
        self.embed_channels = embed_channels
        g = generator
        self.stem_conv0 = SNConv(in_channels, num_channels, 3, 1, True,
                                 generator=g)
        self.stem_conv1 = SNConv(num_channels, num_channels, 3, 1, True,
                                 generator=g)
        self.stem_skip = SNConv(in_channels, num_channels, 1, 0, True,
                                generator=g)
        blocks = plan(num_channels, max_num_channels, embed_channels,
                      num_blocks, image_size)
        self.num_blocks = len(blocks)
        for i, (in_ch, out_ch, down) in enumerate(blocks):
            self.add_module(f"block{i}", ResBlock(
                in_ch, out_ch, norm_layer="none", downsample=down,
                padding=padding, generator=g))
        self.linear = SNDense(embed_channels, 1, generator=g)
        self.embed = SNEmbed(num_labels, embed_channels, sn_eps=embed_sn_eps,
                             generator=g)

    @staticmethod
    def make_input(batch, rgbs):
        """The scored input (B, H, W, 3): ``rgbs`` (B, [T,] H, W, 3) at its
        first frame."""
        return rgbs if rgbs.dim() == 4 else rgbs[:, 0]

    def embed_labels(self, labels, update_stats: bool = False):
        """The projection rows W[label] (B, embed_channels)."""
        return self.embed(labels, update_stats)

    def pass_inputs(self, x, embed=None, update_stats: bool = False):
        """One pass: x (B, H, W, 3), embed (B, E) or None ->
        (score (B,), feats: list of NCHW maps)."""
        upd = update_stats
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        h = self.stem_conv1(torch.relu(self.stem_conv0(x, upd)), upd)
        out = avg_pool_2x(h) + avg_pool_2x(self.stem_skip(x, upd))
        feats = [out]
        for i in range(self.num_blocks):
            out = getattr(self, f"block{i}")(out, update_stats=upd)
            feats.append(out)
        # the reference's in-place ReLU of each block rewrote the stored maps
        feats = [torch.relu(f) for f in feats[:-1]] + feats[-1:]
        feat_sum = torch.relu(out).sum(dim=(2, 3))
        score = self.linear(feat_sum, upd)[:, 0]
        if embed is not None:
            score = score + (feat_sum * embed).sum(dim=1)
        return score, feats

    def forward(self, x, labels=None, update_stats: bool = False):
        embed = None if labels is None \
            else self.embed_labels(labels, update_stats)
        return self.pass_inputs(x, embed, update_stats)
