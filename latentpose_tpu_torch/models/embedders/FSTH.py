"""FSTH embedder (port of ``latentpose_tpu/models/embedders/FSTH.py``): a
strided ResBlock tower over concat(stickman, rgb) of each identity frame
(the rgb alone with ``use_stickmen=False``, ``no_pose_encoder``),
the spatial sum of its features, then the mean ('sum') or max over the
frames.  No pose path: the FSTH generators take the pose from landmarks.

Inputs are NHWC as in the JAX package; the tower works in NCHW."""

from __future__ import annotations

import torch
import torch.nn as nn

from latentpose_tpu_torch.nn.encoders import SumPoolEncoder


class Wrapper:
    @staticmethod
    def get_net(args, generator=None):
        return Embedder(num_channels=args.num_channels,
                        max_num_channels=args.max_num_channels,
                        embed_channels=args.embed_channels,
                        num_blocks=args.embed_num_blocks,
                        padding=args.embed_padding,
                        average_function=args.average_function,
                        generator=generator)


class Embedder(nn.Module):
    INPUT_KEYS = ("enc_rgbs", "pose_input_rgbs", "enc_stickmen")

    def __init__(self, num_channels=64, max_num_channels=512,
                 embed_channels=512, num_blocks=6, padding="zero",
                 average_function="sum", generator=None, use_stickmen=True):
        super().__init__()
        self.use_stickmen = use_stickmen
        if average_function not in ("sum", "max"):
            raise ValueError("average_function must be sum|max, got "
                             f"{average_function!r}")
        self.embed_channels = embed_channels
        self.average_function = average_function
        self.encoder = SumPoolEncoder(6 if use_stickmen else 3, num_channels,
                                      max_num_channels,
                                      embed_channels, num_blocks, padding,
                                      generator=generator)

    def get_identity_embedding(self, enc_rgbs, enc_stickmen,
                               train: bool = False):
        """enc_rgbs, enc_stickmen (B, K, H, W, 3) -> (embeds (B, E),
        embeds_elemwise (B, K, E)); ``train`` advances the tower's
        spectral-norm states."""
        x = enc_rgbs
        if self.use_stickmen:
            if enc_stickmen is None:
                raise ValueError("the FSTH embedder needs enc_stickmen")
            x = torch.cat([enc_stickmen, enc_rgbs], dim=-1)
        b, k = x.shape[:2]
        x = x.reshape(b * k, *x.shape[2:]).permute(0, 3, 1, 2)
        pooled, _ = self.encoder(
            x.contiguous(memory_format=torch.channels_last),
            update_stats=train)
        elemwise = pooled.reshape(b, k, self.embed_channels)
        agg = elemwise.mean(dim=1) if self.average_function == "sum" \
            else elemwise.amax(dim=1)
        return agg, elemwise

    def get_pose_embedding(self, pose_input_rgbs, train: bool = False,
                           dropout_generator=None):
        return None

    def forward(self, enc_rgbs, pose_input_rgbs=None, enc_stickmen=None,
                train: bool = False, dropout_generator=None,
                compute_identity: bool = True):
        """(embeds, embeds_elemwise, None)."""
        if not compute_identity:
            return None, None, None
        embeds, elemwise = self.get_identity_embedding(enc_rgbs,
                                                       enc_stickmen, train)
        return embeds, elemwise, None
