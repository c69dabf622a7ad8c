"""X2Face generator (port of ``latentpose_tpu/models/generators/X2Face.py``):
the identity frames -> the embedding UNet -> tanh, the mean over the K
frames, x0.5 + 0.5: the embedded face in [0, 1]; the driver -> the driving
UNet -> tanh: a sampling grid in [-1, 1] that warps the embedded face
(bilinear, reflection, ``ops/image.py``).  It has no segmentation: the
forward returns ``(warped, None)``.

Its "fine-tune" trains nothing (``FINETUNE_PARAM = "none"``): it stores the
avatar's identity images as ``finetune_identity_images`` (``cli/train.py``),
which drive broadcasts to the batch as ``enc_rgbs``
(``runners/drive.py``).  ``PRETRAINED``: the converted X2Face release
weights (``x2face.npz``, WEIGHTS.md), overlaid at init where found
(``runners/build.py``); without them the weights are the seeded init."""

from __future__ import annotations

import logging

import torch
import torch.nn as nn

from latentpose_tpu_torch.nn.unet import UNet
from latentpose_tpu_torch.ops.image import grid_sample_bilinear
from latentpose_tpu_torch.utils.weights import find_weights_file

logger = logging.getLogger("latentpose_tpu_torch.models.x2face")


class Wrapper:
    @staticmethod
    def get_net(args, generator=None):
        if find_weights_file("x2face.npz") is None:
            logger.warning(
                "X2Face generator: converted X2Face weights (x2face.npz) "
                "not found — weights are randomly initialized (pipeline/"
                "ablation use only; see WEIGHTS.md)")
        return Generator(generator=generator)


class Generator(nn.Module):
    INPUT_KEYS = ("enc_rgbs", "pose_input_rgbs")
    FINETUNE_PARAM = "none"
    # (target subtree, npz file, source subtree in the file)
    PRETRAINED = (("", "x2face.npz", ""),)

    def __init__(self, generator=None):
        super().__init__()
        self.embedding_net = UNet(3, generator=generator)
        self.driving_net = UNet(2, generator=generator)

    def forward(self, enc_rgbs, pose_input_rgbs, update_stats: bool = False):
        """enc_rgbs (B, K, H, W, 3) identity frames, pose_input_rgbs
        (B, 1, H, W, 3) or (B, H, W, 3) driver -> ((B, H, W, 3) f32, None)."""
        b, k = enc_rgbs.shape[:2]
        frames = enc_rgbs.reshape(b * k, *enc_rgbs.shape[2:])
        embedded = torch.tanh(self.embedding_net(frames.permute(0, 3, 1, 2)))
        embedded = embedded.reshape(b, k, *embedded.shape[1:]).mean(dim=1) \
            * 0.5 + 0.5
        driver = pose_input_rgbs[:, 0] if pose_input_rgbs.dim() > 4 \
            else pose_input_rgbs
        grid = torch.tanh(self.driving_net(driver.permute(0, 3, 1, 2)))
        warped = grid_sample_bilinear(embedded, grid[:, 0], grid[:, 1])
        return warped.permute(0, 2, 3, 1), None

    def get_pose_vector(self, pose_input_rgbs):
        """The driving UNet's bottleneck, averaged over space: X2Face's
        latent pose descriptor."""
        driver = pose_input_rgbs[:, 0] if pose_input_rgbs.dim() > 4 \
            else pose_input_rgbs
        return self.driving_net.bottleneck(
            driver.permute(0, 3, 1, 2)).mean(dim=(2, 3))
