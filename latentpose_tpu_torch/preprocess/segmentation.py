"""Background (head + body) segmentation stage (port of
``latentpose_tpu/preprocess/segmentation.py``): the Graphonomy parser with
test-time scales 0.75 / 1.0 / 1.5 / 2.0, averaged at the crop's size and
thresholded at 0.5 (:func:`segment_with_tta`); GrabCut through cv2, with
its warning, when ``graphonomy.npz`` is absent.

Frames go through as a batch on the backend's device, one Graphonomy pass a
scale; both resizes are cv2's INTER_LINEAR arithmetic (``ops/resize.py``),
uint8 for the image, float32 for the probabilities, as the JAX package
computes them with cv2.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from latentpose_tpu_torch.ops.resize import resize_linear
from latentpose_tpu_torch.utils.weights import (empty_module,
                                                find_weights_file,
                                                load_flax_weights)

logger = logging.getLogger("latentpose_tpu_torch.preprocess.segmentation")

TTA_SCALES = (0.75, 1.0, 1.5, 2.0)


class GrabCutBackend:
    """cv2.grabCut seeded with a centred rectangle (fallback only)."""

    device = torch.device("cpu")

    def __init__(self):
        try:
            import cv2
        except ImportError as err:
            raise RuntimeError(
                "no segmentation backend: graphonomy.npz was not found "
                "(--weights_dir, $LATENTPOSE_WEIGHTS_DIR, <repo>/weights/; "
                "see WEIGHTS.md) and the GrabCut fallback needs cv2, which "
                "does not import here") from err
        self.cv2 = cv2
        logger.warning(
            "Using the GrabCut segmentation fallback — NOT Graphonomy "
            "parity; convert Graphonomy weights for paper-parity masks.")

    def _one(self, image_rgb_uint8):
        cv2 = self.cv2
        h, w = image_rgb_uint8.shape[:2]
        mask = np.zeros((h, w), np.uint8)
        rect = (w // 8, h // 12, w * 3 // 4, h * 7 // 8)
        bgd = np.zeros((1, 65), np.float64)
        fgd = np.zeros((1, 65), np.float64)
        try:
            cv2.grabCut(image_rgb_uint8[..., ::-1].copy(), mask, rect, bgd,
                        fgd, 3, cv2.GC_INIT_WITH_RECT)
        except cv2.error:
            return np.ones((h, w), np.float32)
        fg = (mask == cv2.GC_FGD) | (mask == cv2.GC_PR_FGD)
        return fg.astype(np.float32)

    def __call__(self, images):
        """(N, H, W, 3) uint8 tensor -> (N, H, W) float32 tensor."""
        return torch.from_numpy(np.stack(
            [self._one(img) for img in images.cpu().numpy()]))


class GraphonomyBackend:
    """Graphonomy on ``device``: (N, H, W, 3) uint8 tensor -> (N, H, W)
    float32 person probability."""

    def __init__(self, weights_path, device="cuda"):
        from latentpose_tpu_torch.preprocess.graphonomy import (Graphonomy,
                                                                person_mask)
        self.device = torch.device(device)
        self.model = load_flax_weights(
            empty_module(Graphonomy, self.device), weights_path).eval()
        self._person_mask = person_mask
        logger.info("Graphonomy backend active (%s)", weights_path)

    def __call__(self, images):
        x = images.to(self.device).permute(0, 3, 1, 2).float() / 255.0
        with torch.no_grad():
            return self._person_mask(self.model(x.contiguous()))


def tta_probabilities(backend, images, scales=TTA_SCALES):
    """The test-time scales' average person probability: at each scale the
    frames resized to (max(8, int(w * s)), max(8, int(h * s))), the
    backend's probability resized back, summed in f32 and divided by the
    number of scales.  images: (N, H, W, 3) uint8 RGB of one size (numpy
    or tensor).  Returns an (N, H, W) float32 tensor on the backend's
    device."""
    x = torch.as_tensor(np.asarray(images)).to(backend.device)
    h, w = x.shape[1:3]
    acc = torch.zeros(x.shape[:3], dtype=torch.float32, device=x.device)
    for s in scales:
        scaled = resize_linear(x, (max(8, int(w * s)), max(8, int(h * s))))
        prob = backend(scaled).float().to(x.device)
        acc += resize_linear(prob, (w, h))
    acc /= len(scales)
    return acc


def segment_with_tta(backend, images, scales=TTA_SCALES, threshold=0.5):
    """Masks of 0 and 1 where :func:`tta_probabilities` exceeds
    ``threshold``.  images: (H, W, 3) or (N, H, W, 3) uint8 RGB of one
    size.  Returns float32 (H, W) or (N, H, W)."""
    single = np.ndim(images) == 3
    batch = np.asarray(images)[None] if single else images
    acc = tta_probabilities(backend, batch, scales)
    mask = (acc > threshold).float().cpu().numpy()
    return mask[0] if single else mask


def make_segmentation_backend(weights_dir=None, device="cuda"):
    path = find_weights_file("graphonomy.npz", weights_dir)
    if path is not None:
        return GraphonomyBackend(path, device)
    return GrabCutBackend()
