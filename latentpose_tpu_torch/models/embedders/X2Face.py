"""X2Face passthrough embedder (port of
``latentpose_tpu/models/embedders/X2Face.py``): no parameters and no
output; the X2Face generator reads the identity frames and the driver
itself."""

from __future__ import annotations

import torch.nn as nn


class Wrapper:
    @staticmethod
    def get_net(args, generator=None):
        return Embedder()


class Embedder(nn.Module):
    INPUT_KEYS = ("enc_rgbs", "pose_input_rgbs")

    def get_identity_embedding(self, enc_rgbs, train: bool = False):
        return None, None

    def get_pose_embedding(self, pose_input_rgbs, train: bool = False,
                           dropout_generator=None):
        return None

    def forward(self, enc_rgbs, pose_input_rgbs=None, train: bool = False,
                dropout_generator=None, compute_identity: bool = True):
        return None, None, None
