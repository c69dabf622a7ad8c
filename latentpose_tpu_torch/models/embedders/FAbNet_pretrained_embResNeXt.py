"""FAbNet-pretrained-pose embedder (port of
``latentpose_tpu/models/embedders/FAbNet_pretrained_embResNeXt.py``): the
flagship's ResNeXt-50 identity tower (its 16 BN->ReLU->1x1-conv links
through ``ops/conv_bn.py``) beside a *frozen* FAb-Net pose encoder: six
4x4 stride-2 convolutions, each with BatchNorm and LeakyReLU 0.2, a
spatial mean, ``fc`` and tanh.

The pose encoder is frozen as the JAX module freezes it: its BatchNorm
always normalises with the running statistics, in meta-train too, and
never moves them, and its output is cut from the graph, so its parameters
get zero gradients (Adam leaves them as they were).  ``PRETRAINED``: the
converted FAb-Net release weights (``fabnet.npz``, WEIGHTS.md), overlaid
at init where found (``runners/build.py``)."""

from __future__ import annotations

import logging

import torch
import torch.nn as nn
import torch.nn.functional as F

from latentpose_tpu_torch.models.embedders import \
    unsupervised_pose_separate_embResNeXt_segmentation as flagship
from latentpose_tpu_torch.nn.backbones import BatchNorm
from latentpose_tpu_torch.nn.unet import seeded_conv, seeded_linear
from latentpose_tpu_torch.utils.weights import find_weights_file

logger = logging.getLogger("latentpose_tpu_torch.models.fabnet_emb")


class Wrapper:
    @staticmethod
    def get_net(args, generator=None):
        if find_weights_file("fabnet.npz") is None:
            logger.warning(
                "FAbNet_pretrained_embResNeXt: converted FAb-Net weights "
                "(fabnet.npz) not found — the frozen pose encoder is "
                "randomly initialized (ablation plumbing only; WEIGHTS.md)")
        return Embedder(identity_embedding_size=args.embed_channels,
                        pose_embedding_size=args.pose_embedding_size,
                        average_function=getattr(args, "average_function",
                                                 "sum"),
                        generator=generator)


class FAbNetEncoder(nn.Module):
    """FAb-Net-style encoder of (B, 3, H, W) frames -> (B, out_size), in
    eval form always, computing in f32."""

    WIDTHS = (64, 128, 256, 512, 512, 512)

    def __init__(self, out_size=256, generator=None):
        super().__init__()
        channels = 3
        for i, width in enumerate(self.WIDTHS):
            self.add_module(f"conv{i}", seeded_conv(channels, width, 4, 2, 1,
                                                    generator))
            self.add_module(f"bn{i}", BatchNorm(width))
            channels = width
        self.fc = seeded_linear(channels, out_size, generator)

    def forward(self, x, train: bool = False, dropout_generator=None):
        h = x.float()
        for i in range(len(self.WIDTHS)):
            h = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h), False)
            h = F.leaky_relu(h, 0.2)
        return torch.tanh(self.fc(h.mean(dim=(2, 3))))


class FrozenPoseEmbedder(flagship.ResNeXtIdentity):
    """The flagship's identity tower beside a frozen pose encoder
    (``pose_module``): its pose is computed without a graph, whatever the
    form."""

    def get_pose_embedding(self, pose_input_rgbs, train: bool = False,
                           dropout_generator=None):
        """The frozen pose path of driver frame 0, cut from the graph."""
        frames = pose_input_rgbs[:, 0] if pose_input_rgbs.dim() > 4 \
            else pose_input_rgbs
        with torch.no_grad():
            return self.pose_module()(frames.permute(0, 3, 1, 2))


class Embedder(FrozenPoseEmbedder):
    PRETRAINED = (("pose_encoder", "fabnet.npz", ""),)

    def __init__(self, identity_embedding_size=512, pose_embedding_size=256,
                 average_function="sum", generator=None):
        super().__init__(identity_embedding_size, average_function,
                         generator)
        self.pose_encoder = FAbNetEncoder(pose_embedding_size, generator)

    def pose_module(self):
        """The pose path as a module of (B, 3, H, W) frames."""
        return self.pose_encoder
