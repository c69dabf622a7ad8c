"""Landmark backends of the eval harness and the cropper (port of the
landmark half of ``latentpose_tpu/eval/backends.py``): FAN when
``fan_2d.npz`` is found (``--eval_weights_dir`` / ``--weights_dir``,
``$LATENTPOSE_WEIGHTS_DIR``, ``<repo>/weights/``), else an error.  The
descriptor backends (ArcFace) and the proxies wait for the eval half of
ROADMAP A.18.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from latentpose_tpu_torch.ops.resize import resize_linear
from latentpose_tpu_torch.utils.weights import (find_weights_file,
                                                load_flax_weights,
                                                missing_weights_error)

logger = logging.getLogger("latentpose_tpu_torch.eval.backends")


class FANBackend:
    """FAN on ``device``: frames -> 68 (x, y) landmarks in frame pixels.
    Each frame is resized to 256² (cv2's INTER_LINEAR on uint8), and the
    landmarks scaled back by width / 256 on both axes, as the JAX package
    has it."""

    def __init__(self, weights_path, device="cuda"):
        from latentpose_tpu_torch.eval.fan import FAN, heatmaps_to_landmarks
        self.device = torch.device(device)
        self.model = load_flax_weights(FAN(), weights_path).to(
            self.device).eval()
        self._to_landmarks = heatmaps_to_landmarks
        logger.info("FAN backend active (%s)", weights_path)

    def heatmaps(self, images):
        """The heatmap stacks of (N, H, W, 3) uint8 frames (numpy or
        tensor)."""
        x = torch.as_tensor(np.asarray(images)).to(self.device)
        x = resize_linear(x, (256, 256)).float() / 255.0
        with torch.no_grad():
            return self.model(x.permute(0, 3, 1, 2).contiguous())

    def __call__(self, images):
        """images: (H, W, 3) or (N, H, W, 3) uint8 RGB.  Returns (landmarks
        (68, 2) or (N, 68, 2) float32, True)."""
        single = np.ndim(images) == 3
        batch = np.asarray(images)[None] if single else images
        lm = self._to_landmarks(self.heatmaps(batch)[-1]).cpu().numpy()
        lm = lm * (np.shape(batch)[2] / 256.0)
        return (lm[0] if single else lm), True


def make_landmark_backend(weights_dir, allow_proxy=False, device="cuda"):
    path = find_weights_file("fan_2d.npz", weights_dir)
    if path is not None:
        return FANBackend(path, device)
    if not allow_proxy:
        raise missing_weights_error(
            "fan_2d.npz", "landmark backend", "--allow_proxy_eval",
            weights_dir)
    raise NotImplementedError(
        "the proxy landmark backend is not ported to PyTorch yet (ROADMAP.md "
        "A.18, the eval half); provide fan_2d.npz")
