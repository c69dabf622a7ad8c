"""X2Face-pretrained-pose embedder (port of
``latentpose_tpu/models/embedders/X2Face_pretrained_embResNeXt.py``): the
flagship's ResNeXt-50 identity tower beside a *frozen* X2Face driving
UNet: the pose is ``pose_proj`` of the spatial mean of the UNet's
bottleneck, cut from the graph, so the UNet and ``pose_proj`` both get
zero gradients.  Only the UNet's down path runs; its decoder's parameters
stay in the state and the checkpoint, array for array.  ``PRETRAINED``:
the driving UNet of the converted X2Face release weights (``x2face.npz``,
WEIGHTS.md), overlaid at init where found (``runners/build.py``)."""

from __future__ import annotations

import logging

import torch.nn as nn

from latentpose_tpu_torch.models.embedders.FAbNet_pretrained_embResNeXt \
    import FrozenPoseEmbedder
from latentpose_tpu_torch.nn.unet import UNet, seeded_linear
from latentpose_tpu_torch.utils.weights import find_weights_file

logger = logging.getLogger("latentpose_tpu_torch.models.x2face_emb")


class Wrapper:
    @staticmethod
    def get_net(args, generator=None):
        if find_weights_file("x2face.npz") is None:
            logger.warning(
                "X2Face_pretrained_embResNeXt: converted X2Face weights "
                "(x2face.npz) not found — the frozen pose encoder is "
                "randomly initialized (ablation plumbing only; WEIGHTS.md)")
        return Embedder(identity_embedding_size=args.embed_channels,
                        pose_embedding_size=args.pose_embedding_size,
                        average_function=getattr(args, "average_function",
                                                 "sum"),
                        generator=generator)


class X2FacePose(nn.Module):
    """pose_proj(mean of pose_unet's bottleneck) of (B, 3, H, W) frames."""

    def __init__(self, unet, proj):
        super().__init__()
        self.unet = unet
        self.proj = proj

    def forward(self, x):
        return self.proj(self.unet.bottleneck(x).mean(dim=(2, 3)))


class Embedder(FrozenPoseEmbedder):
    PRETRAINED = (("pose_unet", "x2face.npz", "driving_net"),)

    def __init__(self, identity_embedding_size=512, pose_embedding_size=256,
                 average_function="sum", generator=None):
        super().__init__(identity_embedding_size, average_function,
                         generator)
        self.pose_unet = UNet(2, generator=generator)
        self.pose_proj = seeded_linear(UNet.WIDTHS[-1], pose_embedding_size,
                                       generator)

    def pose_module(self):
        """The pose path as a module of (B, 3, H, W) frames."""
        return X2FacePose(self.pose_unet, self.pose_proj)
