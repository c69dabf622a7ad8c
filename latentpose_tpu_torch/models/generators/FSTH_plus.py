"""FSTH_plus generator (port of
``latentpose_tpu/models/generators/FSTH_plus.py``): the flagship's AdaIN
decoder from a learned constant, driven by the 68 keypoints (136 values in
[0, 1], minus 0.5) in place of a pose embedding, through a plain 3-layer
LeakyReLU(0.05) projector without spectral norm.  17 AdaIN + ReLU a forward
at the defaults, each through the fused kernel.  Fine-tuning trains the
identity embedding, as the flagship's does."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from latentpose_tpu_torch.models.generators.\
    vector_pose_unsupervised_segmentation_noBottleneck import schedule
from latentpose_tpu_torch.nn.blocks import ResBlock, norm_relu
from latentpose_tpu_torch.ops import initializers as tinit
from latentpose_tpu_torch.ops.spectral_norm import SNConv

POSE_SIZE = 136       # 68 keypoints x 2


class Wrapper:
    @staticmethod
    def get_net(args, generator=None):
        return Generator(
            padding=args.gen_padding, out_channels=args.out_channels + 1,
            num_channels=args.num_channels,
            max_num_channels=args.max_num_channels,
            identity_embedding_size=args.embed_channels,
            constant_input_size=args.gen_constant_input_size,
            num_residual_blocks=args.gen_num_residual_blocks,
            output_image_size=args.image_size, generator=generator)


def _linear(in_features, out_features, generator):
    """A plain linear layer with the JAX package's init: the kernel
    U(±1/sqrt(fan_in)) (``ops/initializers.py``), the bias zeros (flax's
    default)."""
    layer = nn.Linear(in_features, out_features)
    with torch.no_grad():
        layer.weight.copy_(tinit.torch_conv_kernel_init(
            (out_features, in_features), generator))
        layer.bias.zero_()
    return layer


class Generator(nn.Module):
    INPUT_KEYS = ("embeds", "dec_keypoints")

    def __init__(self, padding="zero", out_channels=4, num_channels=64,
                 max_num_channels=512, identity_embedding_size=512,
                 constant_input_size=4, num_residual_blocks=2,
                 output_image_size=256, generator=None):
        super().__init__()
        g = generator
        blocks, self.adain_features, head_ch = schedule(
            num_channels, max_num_channels, constant_input_size,
            num_residual_blocks, output_image_size)
        joint = identity_embedding_size + POSE_SIZE
        hidden = max(512, joint)
        self.projector_0 = _linear(joint, hidden, g)
        self.projector_1 = _linear(hidden, hidden, g)
        self.projector_2 = _linear(hidden, self.num_affine_params(), g)
        # NCHW (1, C, S, S); the JAX package stores (1, S, S, C)
        self.constant = nn.Parameter(torch.ones(
            1, blocks[0][0], constant_input_size, constant_input_size))
        self.num_blocks = len(blocks)
        for i, (in_ch, out_ch, up) in enumerate(blocks):
            self.add_module(f"block{i}", ResBlock(
                in_ch, out_ch, norm_layer="adain", upsample=up,
                padding=padding, generator=g))
        self.head_conv = SNConv(head_ch, out_channels, 3, 1, True,
                                generator=g)

    def num_affine_params(self) -> int:
        return sum(2 * f for f in self.adain_features)

    def forward(self, embeds, dec_keypoints, update_stats: bool = False):
        """embeds (B, E), dec_keypoints (B, [T,] 136) ->
        (fake_rgbs (B, H, W, 3), fake_segm (B, H, W, 1)).  Activations
        follow the keypoints' dtype, which the concatenation promotes to."""
        upd = update_stats
        keypoints = dec_keypoints[:, 0] if dec_keypoints.dim() > 2 \
            else dec_keypoints
        pose = keypoints - 0.5
        h = torch.cat([embeds, pose], dim=-1)
        h = F.leaky_relu(self.projector_0(h), 0.05)
        h = F.leaky_relu(self.projector_1(h), 0.05)
        affine = self.projector_2(h)
        ada, offset = [], 0
        for f in self.adain_features:       # bias first, then weight
            ada.append((affine[:, offset + f:offset + 2 * f],
                        affine[:, offset:offset + f]))
            offset += 2 * f
        x = self.constant.to(pose.dtype).expand(pose.shape[0], -1, -1, -1)
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x, ada0=ada[2 * i],
                                           ada1=ada[2 * i + 1],
                                           update_stats=upd)
        x = norm_relu(x, *ada[-1])
        x = torch.tanh(self.head_conv(x, upd)).permute(0, 2, 3, 1)
        rgb = x[..., :-1] * 0.75 + 0.5
        segm = x[..., -1:] * 0.5 + 0.5
        return rgb * segm, segm
