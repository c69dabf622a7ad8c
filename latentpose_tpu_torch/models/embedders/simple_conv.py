"""Lightweight conv embedder (port of
``latentpose_tpu/models/embedders/simple_conv.py``; no reference
counterpart): two towers of four 3x3 stride-2 convolutions with ReLU
(width doubling from ``--simple_embedder_width`` up to 256), a spatial
mean and a dense layer, one for identity (the mean or max over the K
frames) and one for pose (driver frame 0).  The test embedder of the CLIs.
Computes in f32 (flax's promotion of a bf16 input)."""

from __future__ import annotations

import torch
import torch.nn as nn

from latentpose_tpu_torch.nn.unet import seeded_conv, seeded_linear


class Wrapper:
    @staticmethod
    def get_net(args, generator=None):
        return Embedder(identity_embedding_size=args.embed_channels,
                        pose_embedding_size=args.pose_embedding_size,
                        average_function=args.average_function,
                        width=getattr(args, "simple_embedder_width", 32),
                        generator=generator)


class Tower(nn.Module):
    def __init__(self, out_size, width=32, generator=None):
        super().__init__()
        channels, w = 3, width
        for i in range(4):
            self.add_module(f"conv{i}", seeded_conv(channels, w, 3, 2, 1,
                                                    generator))
            channels, w = w, min(w * 2, 256)
        self.fc = seeded_linear(channels, out_size, generator)

    def forward(self, x):
        """(B, H, W, 3) -> (B, out_size) f32."""
        h = x.permute(0, 3, 1, 2).float()
        for i in range(4):
            h = torch.relu(getattr(self, f"conv{i}")(h))
        return self.fc(h.mean(dim=(2, 3)))


class Embedder(nn.Module):
    INPUT_KEYS = ("enc_rgbs", "pose_input_rgbs")

    def __init__(self, identity_embedding_size=512, pose_embedding_size=256,
                 average_function="sum", width=32, generator=None):
        super().__init__()
        if average_function not in ("sum", "max"):
            raise ValueError("average_function must be 'sum' or 'max', got "
                             f"{average_function!r}")
        self.identity_embedding_size = identity_embedding_size
        self.average_function = average_function
        self.identity_encoder = Tower(identity_embedding_size, width,
                                      generator)
        self.pose_encoder = Tower(pose_embedding_size, width, generator)

    def get_identity_embedding(self, enc_rgbs, train: bool = False):
        b, k = enc_rgbs.shape[:2]
        emb = self.identity_encoder(
            enc_rgbs.reshape(b * k, *enc_rgbs.shape[2:])).reshape(
                b, k, self.identity_embedding_size)
        agg = emb.mean(dim=1) if self.average_function == "sum" \
            else emb.amax(dim=1)
        return agg, emb

    def get_pose_embedding(self, pose_input_rgbs, train: bool = False,
                           dropout_generator=None):
        return self.pose_encoder(pose_input_rgbs[:, 0])

    def pose_module(self):
        """The pose path as a module of (B, 3, H, W) frames (drive)."""
        return _NHWC(self.pose_encoder)

    def forward(self, enc_rgbs, pose_input_rgbs=None, train: bool = False,
                dropout_generator=None, compute_identity: bool = True):
        embeds, elemwise = self.get_identity_embedding(enc_rgbs, train) \
            if compute_identity else (None, None)
        pose = None if pose_input_rgbs is None \
            else self.get_pose_embedding(pose_input_rgbs, train)
        return embeds, elemwise, pose


class _NHWC(nn.Module):
    """A tower of NHWC frames called on NCHW ones."""

    def __init__(self, tower):
        super().__init__()
        self.tower = tower

    def forward(self, x):
        return self.tower(x.permute(0, 2, 3, 1))
