"""Flagship embedder, pose half (port of
``latentpose_tpu/models/embedders/unsupervised_pose_separate_embResNeXt_segmentation.py``).

Only ``get_pose_embedding`` is ported: MobileNetV2 on driver frame 0.  The
ResNeXt-50 identity tower comes with the meta-train slice; drive takes the
identity from the fine-tuned embedding instead.
"""

from __future__ import annotations

import torch.nn as nn

from latentpose_tpu_torch.nn.backbones import MobileNetV2


class Wrapper:
    @staticmethod
    def get_net(args, generator=None):
        return Embedder(pose_embedding_size=args.pose_embedding_size,
                        generator=generator)


class Embedder(nn.Module):
    def __init__(self, pose_embedding_size=256, generator=None):
        super().__init__()
        self.pose_encoder = MobileNetV2(num_classes=pose_embedding_size,
                                        generator=generator)

    def get_pose_embedding(self, pose_input_rgbs):
        """pose_input_rgbs (B, T, H, W, 3) -> (B, pose_embedding_size),
        from driver frame 0."""
        return self.pose_encoder(pose_input_rgbs[:, 0].permute(0, 3, 1, 2))
