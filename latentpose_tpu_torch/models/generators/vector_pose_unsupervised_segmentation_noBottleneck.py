"""Flagship generator: AdaIN decoder from a learned constant (port of
``latentpose_tpu/models/generators/vector_pose_unsupervised_segmentation_noBottleneck.py``).

identity ⊕ pose embeddings -> SN projector MLP -> per-sample (bias, weight)
for every AdaIN, packed in module order with the bias first; a learned
constant (ones) -> ``num_residual_blocks`` AdaIN blocks at constant
resolution -> log2(image_size / constant) upsampling AdaIN blocks -> head
AdaIN -> ReLU -> SNConv3x3 -> tanh -> rgb·segm.  All 17 AdaIN + ReLU
applications of the flagship run through the fused kernel (``ops/adain.py``).
Activations follow the pose embedding's dtype (bf16 serving).

``args.quantize`` ('int8' | 'int8_static', drive's ``--quantize``) makes
every block's convs int8 (``ops/quant.py``): 22 of them in the flagship, 8
blocks x 2 and 6 skips.  The head conv stays float, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn as nn

from latentpose_tpu_torch.nn.blocks import ResBlock, norm_relu
from latentpose_tpu_torch.ops.spectral_norm import SNConv, SNDense


class Wrapper:
    @staticmethod
    def get_net(args, generator=None):
        return Generator(
            padding=args.gen_padding,
            out_channels=args.out_channels + 1,  # +1 segmentation channel
            num_channels=args.num_channels,
            max_num_channels=args.max_num_channels,
            identity_embedding_size=args.embed_channels,
            pose_embedding_size=args.pose_embedding_size,
            constant_input_size=args.gen_constant_input_size,
            num_residual_blocks=args.gen_num_residual_blocks,
            output_image_size=args.image_size,
            generator=generator,
            quantize=getattr(args, "quantize", "") or "")


def schedule(num_channels=64, max_num_channels=512, constant_input_size=4,
             num_residual_blocks=2, output_image_size=256
             ) -> Tuple[List[Tuple[int, int, bool]], List[int], int]:
    """Static channel plan: (blocks, adain_features, head_features).

    blocks lists (in_ch, out_ch, upsample); adain_features the feature count
    of every AdaIN in module order (norm0, norm1 per block, then the head) —
    the packing order of the projector output.
    """
    ratio = output_image_size / constant_input_size
    if not math.log2(ratio).is_integer():
        raise ValueError("constant_input_size must divide image_size by a "
                         "power of 2")
    num_up = int(math.log2(ratio))
    ch_nonclamped = num_channels * (2 ** num_up)
    ch = min(ch_nonclamped, max_num_channels)
    blocks = [(ch, ch, False)] * num_residual_blocks
    for _ in range(num_up):
        in_ch = ch
        ch_nonclamped //= 2
        ch = min(ch_nonclamped, max_num_channels)
        blocks.append((in_ch, ch, True))
    adain_features = [f for in_ch, out_ch, _ in blocks for f in (in_ch, out_ch)]
    adain_features.append(ch)  # head AdaIN
    return blocks, adain_features, ch


def quantized_conv_shapes(num_channels=64, max_num_channels=512,
                          constant_input_size=4, num_residual_blocks=2,
                          output_image_size=256):
    """The int8 products of one ``--quantize`` forward, in order: (conv
    name, input channels, output channels of the product, kernel size,
    input side).  An upsampling block's conv0 is the polyphase product at
    the low resolution (4x the output channels); its skip runs there too."""
    blocks, _, _ = schedule(num_channels, max_num_channels,
                            constant_input_size, num_residual_blocks,
                            output_image_size)
    shapes, side = [], constant_input_size
    for i, (in_ch, out_ch, up) in enumerate(blocks):
        shapes.append((f"block{i}.conv0", in_ch, 4 * out_ch if up else out_ch,
                       3, side))
        shapes.append((f"block{i}.conv1", out_ch, out_ch, 3,
                       2 * side if up else side))
        if in_ch != out_ch or up:
            shapes.append((f"block{i}.skip", in_ch, out_ch, 1, side))
        side = 2 * side if up else side
    return shapes


class Generator(nn.Module):
    INPUT_KEYS = ("embeds", "pose_embedding")

    def __init__(self, padding="zero", out_channels=4, num_channels=64,
                 max_num_channels=512, identity_embedding_size=512,
                 pose_embedding_size=256, constant_input_size=4,
                 num_residual_blocks=2, output_image_size=256, generator=None,
                 quantize=""):
        super().__init__()
        self.config = (num_channels, max_num_channels, constant_input_size,
                       num_residual_blocks, output_image_size)
        blocks, self.adain_features, head_ch = self._schedule()
        joint = identity_embedding_size + pose_embedding_size
        hidden = max(joint, 512)
        self.projector_0 = SNDense(joint, hidden, generator=generator)
        self.projector_1 = SNDense(hidden, self.num_affine_params(),
                                   generator=generator)
        # NCHW (1, C, S, S); the JAX package stores (1, S, S, C)
        self.constant = nn.Parameter(torch.ones(
            1, blocks[0][0], constant_input_size, constant_input_size))
        self.num_blocks = len(blocks)
        for i, (in_ch, out_ch, up) in enumerate(blocks):
            self.add_module(f"block{i}", ResBlock(
                in_ch, out_ch, norm_layer="adain", upsample=up,
                padding=padding, generator=generator, quantize=quantize))
        self.head_conv = SNConv(head_ch, out_channels, 3, 1, True,
                                generator=generator)

    def _schedule(self):
        return schedule(*self.config)

    def num_affine_params(self) -> int:
        return sum(2 * f for f in self.adain_features)

    def forward(self, embeds, pose_embedding, update_stats: bool = False):
        """embeds (B, E), pose_embedding (B, P) ->
        (fake_rgbs (B, H, W, 3), fake_segm (B, H, W, 1)).
        ``update_stats``: one spectral-norm power iteration per layer."""
        upd = update_stats
        joint = torch.cat([embeds, pose_embedding], dim=-1)
        affine = self.projector_1(torch.relu(self.projector_0(joint, upd)),
                                  upd)
        ada_params, offset = [], 0
        for f in self.adain_features:  # bias first, then weight
            ada_params.append((affine[:, offset + f:offset + 2 * f],
                               affine[:, offset:offset + f]))
            offset += 2 * f

        x = self.constant.to(pose_embedding.dtype).expand(
            pose_embedding.shape[0], -1, -1, -1)
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x, ada0=ada_params[2 * i],
                                           ada1=ada_params[2 * i + 1],
                                           update_stats=upd)
        x = norm_relu(x, *ada_params[-1])
        x = torch.tanh(self.head_conv(x, upd)).permute(0, 2, 3, 1)
        rgb = x[..., :-1] * 0.75 + 0.5    # tanh range -> (-0.25, 1.25)
        segm = x[..., -1:] * 0.5 + 0.5    # tanh range -> (0, 1)
        return rgb * segm, segm
