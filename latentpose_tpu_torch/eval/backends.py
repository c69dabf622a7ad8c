"""Descriptor and landmark backends of the eval harness (port of
``latentpose_tpu/eval/backends.py``).

Real backends (ArcFace-r100, FAN) run when their converted weights are found
(``--eval_weights_dir``, ``$LATENTPOSE_WEIGHTS_DIR``, ``<repo>/weights/``).
Without them the factories raise unless ``allow_proxy=True``
(``--allow_proxy_eval``), which takes the deterministic proxies: the same
functions as the JAX package's, whose numbers are NOT comparable to the
paper's.

Every backend takes frames as the JAX harness hands them over (uint8, in the
channel order it reads them: BGR) and is channel-agnostic itself.  The face
crops are resized as cv2 does there (``ops/resize.py``), on ``device``.
Each backend times its parts in a :class:`StageTimer`, its own or the
caller's.

ArcFace's and FAN's convolutions run in full f32 on the card: cuDNN's default
TF32 moves the protocol's numbers above the card-vs-CPU gate (ROADMAP C.6,
PERF.md).  The setting is scoped to the nets' forward passes
(:func:`full_f32`); nothing process-wide changes.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import time

import numpy as np
import torch

from latentpose_tpu_torch.ops.resize import (resize_area, resize_cubic,
                                             resize_linear)
from latentpose_tpu_torch.utils.weights import (empty_module,
                                                find_weights_file,
                                                load_flax_weights,
                                                missing_weights_error)

logger = logging.getLogger("latentpose_tpu_torch.eval.backends")

FACE_DESCRIPTOR_DIM = 512


class StageTimer:
    """Wall seconds and calls of each stage of the harness ("decode",
    "crop_resize", "arcface", "fan", "metrics")."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)
        self.calls = collections.Counter()

    @contextlib.contextmanager
    def __call__(self, name, device=None):
        """Time the block as stage ``name``, the card (when ``device`` is
        one) synchronised at both ends."""
        cuda = device is not None and torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
        start = time.perf_counter()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize(device)
            self.seconds[name] += time.perf_counter() - start
            self.calls[name] += 1


@contextlib.contextmanager
def full_f32():
    """cuDNN's TF32 off inside, restored after.  (Not
    ``torch.backends.cudnn.flags``, which also resets cuDNN's other flags
    to its own defaults, ``enabled=False`` among them.)"""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def get_default_bbox(kind):
    """Crop-type-aware rough face bbox (t, l, b, r pixels clipped from a
    256² image) for when detection fails (reference ``:38-61``)."""
    if kind == "ffhq":
        return (0, 30, 60, 30)
    if kind == "x2face":
        return (37, (37 + 45) // 2, 45, (37 + 45) // 2)
    if kind == "latentpose":
        return (42, (42 + 64) // 2, 64, (42 + 64) // 2)
    raise ValueError(f"Wrong crop type: {kind}")


def procedural_mean_face(image_size=256):
    """The canonical 68-landmark layout of the JAX package (standard facial
    proportions), used when detection fails."""
    s = image_size / 256.0
    pts = []
    # jaw: 17 points along a lower half-ellipse
    for i in range(17):
        a = np.pi * (1.0 - i / 16.0)
        pts.append((128 + 52 * np.cos(a), 130 + 66 * np.sin(a) * 0.95))
    # brows: 5 points each
    for x0, x1 in ((86, 118), (138, 170)):
        for i in range(5):
            x = x0 + (x1 - x0) * i / 4
            pts.append((x, 108 - 6 * np.sin(np.pi * i / 4)))
    # nose bridge 4 + nostrils 5
    for i in range(4):
        pts.append((128, 116 + 10 * i))
    for i in range(5):
        pts.append((116 + 6 * i, 152))
    # eyes: 6 points each; index 36 = left-eye outer corner (leftmost),
    # index 45 = right-eye outer corner (rightmost) — standard iBUG-68
    for cx, a0 in ((102, np.pi), (154, np.pi)):
        for i in range(6):
            a = a0 + 2 * np.pi * i / 6
            pts.append((cx + 12 * np.cos(a), 122 - 5 * np.sin(a)))
    # outer lips 12 + inner lips 8
    for i in range(12):
        a = 2 * np.pi * i / 12
        pts.append((128 + 24 * np.cos(a), 172 - 10 * np.sin(a)))
    for i in range(8):
        a = 2 * np.pi * i / 8
        pts.append((128 + 14 * np.cos(a), 172 - 5 * np.sin(a)))
    return (np.array(pts[:68], np.float32) * s)


def face_crops(images, default_bbox, size, resize, device):
    """The default-bbox crop of each (H, W, 3) uint8 frame (bbox scaled by
    H / 256), resized to ``size`` by ``resize``: (N, h, w, 3) uint8 on
    ``device``, one batch for each frame size."""
    out = [None] * len(images)
    groups = {}
    for i, image in enumerate(images):
        groups.setdefault(np.shape(image), []).append(i)
    for shape, idx in groups.items():
        h, w = shape[:2]
        t, l, b, r = (int(v * h / 256) for v in default_bbox)
        batch = torch.from_numpy(np.stack([images[i] for i in idx]))
        crops = resize(batch.to(device)[:, t:h - b, l:w - r].contiguous(),
                       size)
        for j, i in enumerate(idx):
            out[i] = crops[j]
    return torch.stack(out)


class ProxyDescriptorBackend:
    """Deterministic stand-in: the default-bbox crop, INTER_AREA to 16²,
    standardized, projected to 512-d by a seeded Gaussian matrix (drawn as
    the JAX package draws it) and L2-normalized."""

    def __init__(self, seed=0, device="cpu", timer=None):
        rng = np.random.RandomState(seed)
        self.projection = rng.randn(16 * 16 * 3, FACE_DESCRIPTOR_DIM) \
            .astype(np.float32) / np.sqrt(16 * 16 * 3)
        self.device = torch.device(device)
        self.timer = timer or StageTimer()
        logger.warning(
            "Using the PROXY identity-descriptor backend (no ArcFace "
            "weights found). Identity-error numbers are only comparable "
            "within this framework, not to the paper.")

    def __call__(self, images, default_bbox):
        with self.timer("crop_resize", self.device):
            crops = face_crops(images, default_bbox, (16, 16), resize_area,
                               self.device).cpu().numpy()
        feats = []
        for crop in crops:
            v = crop.astype(np.float32).reshape(-1)
            v = (v - v.mean()) / (v.std() + 1e-6)
            feats.append(v @ self.projection)
        feats = np.stack(feats)
        feats /= np.maximum(np.linalg.norm(feats, axis=-1, keepdims=True),
                            1e-12)
        return feats, 0


class ArcFaceBackend:
    """ArcFace-r100 on ``device``: the default-bbox crop, INTER_CUBIC to
    112², the descriptor of the crop plus that of its mirror image,
    normalized once."""

    def __init__(self, weights_path, flip=True, device="cuda", timer=None):
        from latentpose_tpu_torch.eval.arcface import ArcFaceR100
        self.device = torch.device(device)
        self.timer = timer or StageTimer()
        self.model = load_flax_weights(
            empty_module(ArcFaceR100, self.device), weights_path).eval()
        self.flip = flip
        logger.info("ArcFace backend active (%s)", weights_path)

    def embed(self, crops):
        """(N, 112, 112, 3) uint8 crops on the device -> (N, 512)
        normalized descriptors; the mirror images (``crops[:, :, ::-1]``)
        run in the same batch."""
        from latentpose_tpu_torch.eval.arcface import normalize_embeddings
        n = crops.shape[0]
        with torch.no_grad(), full_f32():
            if self.flip:
                e = self.model(torch.cat([crops, torch.flip(crops, [2])]))
                e = e[:n] + e[n:]
            else:
                e = self.model(crops)
            return normalize_embeddings(e)

    def __call__(self, images, default_bbox):
        with self.timer("crop_resize", self.device):
            crops = face_crops(images, default_bbox, (112, 112),
                               resize_cubic, self.device)
        with self.timer("arcface", self.device):
            emb = self.embed(crops).cpu().numpy()
        return emb, 0


class ProxyLandmarkBackend:
    """Stand-in landmarks: the canonical mean face shifted to the
    brightness-weighted centre of the frame."""

    def __init__(self):
        self.mean_face = procedural_mean_face()
        logger.warning(
            "Using the PROXY landmark backend (no FAN weights found). "
            "Pose-error numbers are only comparable within this framework.")

    def _one(self, image):
        gray = image.astype(np.float32).mean(-1)
        mass = gray / max(gray.sum(), 1e-6)
        ys = (mass.sum(1) * np.arange(image.shape[0])).sum()
        xs = (mass.sum(0) * np.arange(image.shape[1])).sum()
        shift = np.array([xs - 128.0, ys - 128.0], np.float32)
        return self.mean_face + shift

    def __call__(self, images):
        """images: (H, W, 3) or (N, H, W, 3) uint8.  Returns (landmarks
        (68, 2) or (N, 68, 2) float32, True)."""
        if np.ndim(images) == 3:
            return self._one(np.asarray(images)), True
        return np.stack([self._one(np.asarray(im)) for im in images]), True


class FANBackend:
    """FAN on ``device``: frames -> 68 (x, y) landmarks in frame pixels.
    Each frame is resized to 256² (cv2's INTER_LINEAR on uint8), and the
    landmarks scaled back by width / 256 on both axes, as the JAX package
    has it."""

    def __init__(self, weights_path, device="cuda", timer=None):
        from latentpose_tpu_torch.eval.fan import FAN, heatmaps_to_landmarks
        self.device = torch.device(device)
        self.timer = timer or StageTimer()
        self.model = load_flax_weights(
            empty_module(FAN, self.device), weights_path).eval()
        self._to_landmarks = heatmaps_to_landmarks
        logger.info("FAN backend active (%s)", weights_path)

    def heatmaps(self, images):
        """The heatmap stacks of (N, H, W, 3) uint8 frames (numpy or
        tensor)."""
        with self.timer("crop_resize", self.device):
            x = torch.as_tensor(np.asarray(images)).to(self.device)
            x = resize_linear(x, (256, 256)).float() / 255.0
        with self.timer("fan", self.device), torch.no_grad(), full_f32():
            return self.model(x.permute(0, 3, 1, 2).contiguous())

    def __call__(self, images):
        """images: (H, W, 3) or (N, H, W, 3) uint8.  Returns (landmarks
        (68, 2) or (N, 68, 2) float32, True)."""
        single = np.ndim(images) == 3
        batch = np.asarray(images)[None] if single else images
        lm = self._to_landmarks(self.heatmaps(batch)[-1]).cpu().numpy()
        lm = lm * (np.shape(batch)[2] / 256.0)
        return (lm[0] if single else lm), True


def make_descriptor_backend(weights_dir, allow_proxy=False, device="cuda",
                            timer=None):
    path = find_weights_file("arcface_r100.npz", weights_dir)
    if path is not None:
        return ArcFaceBackend(path, device=device, timer=timer)
    if not allow_proxy:
        raise missing_weights_error(
            "arcface_r100.npz", "identity-descriptor backend",
            "--allow_proxy_eval", weights_dir)
    return ProxyDescriptorBackend(device=device, timer=timer)


def make_landmark_backend(weights_dir, allow_proxy=False, device="cuda",
                          timer=None):
    path = find_weights_file("fan_2d.npz", weights_dir)
    if path is not None:
        return FANBackend(path, device, timer)
    if not allow_proxy:
        raise missing_weights_error(
            "fan_2d.npz", "landmark backend", "--allow_proxy_eval",
            weights_dir)
    return ProxyLandmarkBackend()
