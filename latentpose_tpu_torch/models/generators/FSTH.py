"""FSTH generator (port of ``latentpose_tpu/models/generators/FSTH.py``):
an encoder-decoder from the driver's stickman.  A strided tower (stem, then
'in'-norm down blocks) encodes the stickman; AdaIN residual and upsampling
blocks decode it, and every AdaIN's (bias, weight) comes from one
spectral-normalised linear layer over the identity embedding
(:meth:`Generator.project_embeds`), packed in module order with the bias
first.  Output: tanh RGB in (-1, 1), no segmentation.

Every norm is followed by a ReLU and runs through the fused AdaIN kernel
(``ops/adain.py``): at the defaults 17 AdaINs and 6 instance norms (their
shared affine expanded over the batch) a forward.

Fine-tuning trains the packed vector itself: ``finetune_affine`` (1,
num_affine_params) = project(ê) (:meth:`Wrapper.make_finetune_state`),
which the forward takes in place of the projection."""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from latentpose_tpu_torch.nn.blocks import ResBlock, norm_relu
from latentpose_tpu_torch.ops.image import avg_pool_2x
from latentpose_tpu_torch.ops.spectral_norm import SNConv, SNDense


class Wrapper:
    @staticmethod
    def get_net(args, generator=None):
        return Generator(
            padding=args.gen_padding, in_channels=args.in_channels,
            out_channels=args.out_channels, num_channels=args.num_channels,
            max_num_channels=args.max_num_channels,
            embed_channels=args.embed_channels,
            num_downsample_blocks=args.gen_num_downsample_blocks,
            num_residual_blocks=args.gen_num_residual_blocks,
            generator=generator)

    @staticmethod
    @torch.no_grad()
    def make_finetune_state(generator, e_hat):
        """The per-avatar trainable leaves: {'finetune_affine':
        project(ê)} (1, num_affine_params), σ from the stored (u, v)."""
        return {"finetune_affine": generator.project_embeds(e_hat.float())}


def schedule(num_channels=64, max_num_channels=512, num_downsample_blocks=4,
             num_residual_blocks=4):
    """(down blocks [(in, out)], decoder blocks [(in, out, upsample)], the
    feature count of every AdaIN in packing order)."""
    down: List[Tuple[int, int]] = []
    ch = num_channels
    for _ in range(1, num_downsample_blocks):
        out_ch = min(ch * 2, max_num_channels)
        down.append((ch, out_ch))
        ch = out_ch
    dec: List[Tuple[int, int, bool]] = [(ch, ch, False)] \
        * num_residual_blocks
    for i in range(num_downsample_blocks - 1, -1, -1):
        in_ch, ch = ch, min(int(num_channels * 2 ** i), max_num_channels)
        dec.append((in_ch, ch, True))
    adain = [f for in_ch, out_ch, _ in dec for f in (in_ch, out_ch)]
    adain.append(ch)      # the head's AdaIN
    return down, dec, adain


class Generator(nn.Module):
    INPUT_KEYS = ("embeds", "dec_stickmen")

    def __init__(self, padding="zero", in_channels=3, out_channels=3,
                 num_channels=64, max_num_channels=512, embed_channels=512,
                 num_downsample_blocks=4, num_residual_blocks=4,
                 generator=None):
        super().__init__()
        g = generator
        self.embed_channels = embed_channels
        down, dec, self.adain_features = schedule(
            num_channels, max_num_channels, num_downsample_blocks,
            num_residual_blocks)
        self.project = SNDense(embed_channels, self.num_affine_params(),
                               generator=g)
        self.stem_conv0 = SNConv(in_channels, num_channels, 3, 1, True,
                                 generator=g)
        self.stem_conv1 = SNConv(num_channels, num_channels, 3, 1, True,
                                 generator=g)
        self.stem_skip = SNConv(in_channels, num_channels, 1, 0, True,
                                generator=g)
        self.num_down, self.num_dec = len(down), len(dec)
        for i, (in_ch, out_ch) in enumerate(down):
            self.add_module(f"down{i}", ResBlock(
                in_ch, out_ch, norm_layer="in", downsample=True,
                padding=padding, generator=g))
        for i, (in_ch, out_ch, up) in enumerate(dec):
            self.add_module(f"dec{i}", ResBlock(
                in_ch, out_ch, norm_layer="adain", upsample=up,
                padding=padding, generator=g))
        self.head_conv = SNConv(self.adain_features[-1], out_channels, 3, 1,
                                True, generator=g)

    def num_affine_params(self) -> int:
        return sum(2 * f for f in self.adain_features)

    def project_embeds(self, embeds, update_stats: bool = False):
        """The packed AdaIN parameters (B, num_affine_params) of ``embeds``
        (B, E)."""
        return self.project(embeds, update_stats)

    def forward(self, embeds, dec_stickmen, update_stats: bool = False,
                finetune_affine=None):
        """embeds (B, E) or None with ``finetune_affine`` (B or 1,
        num_affine_params); dec_stickmen (B, [T,] H, W, 3) ->
        (fake_rgbs (B, H, W, 3), None).  ``update_stats``: one
        spectral-norm power iteration per layer it runs."""
        upd = update_stats
        stickman = dec_stickmen[:, 0] if dec_stickmen.dim() > 4 \
            else dec_stickmen
        if finetune_affine is not None:
            affine = finetune_affine.expand(stickman.shape[0], -1)
        else:
            affine = self.project_embeds(embeds, upd)
        ada, offset = [], 0
        for f in self.adain_features:       # bias first, then weight
            ada.append((affine[:, offset + f:offset + 2 * f],
                        affine[:, offset:offset + f]))
            offset += 2 * f

        x = stickman.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        h = self.stem_conv1(torch.relu(self.stem_conv0(x, upd)), upd)
        h = avg_pool_2x(h) + avg_pool_2x(self.stem_skip(x, upd))
        for i in range(self.num_down):
            h = getattr(self, f"down{i}")(h, update_stats=upd)
        for i in range(self.num_dec):
            h = getattr(self, f"dec{i}")(h, ada0=ada[2 * i],
                                         ada1=ada[2 * i + 1],
                                         update_stats=upd)
        h = norm_relu(h, *ada[-1])
        return torch.tanh(self.head_conv(h, upd)).permute(0, 2, 3, 1), None
