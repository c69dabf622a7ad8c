"""Procedural "talking head" frames for hermetic driving (``synthetic://K``),
numpy only: the renderer of ``latentpose_tpu/data/synthetic.py``, bit for bit,
without its training-time cache and augmentation.

Each (identity, frame) renders an elliptical head whose colour and size
encode identity and whose offset, eyes and mouth encode a pose that varies
smoothly with the frame index (period 32).
"""

from __future__ import annotations

import numpy as np


def _identity_style(label: int):
    rng = np.random.RandomState(1000 + label)
    skin = 0.35 + 0.55 * rng.rand(3)
    bg = 0.1 + 0.3 * rng.rand(3)
    size = 0.28 + 0.10 * rng.rand()
    eye_sep = 0.30 + 0.15 * rng.rand()
    return skin, bg, size, eye_sep


def _pose_of_frame(frame: int, period: int = 32):
    t = 2 * np.pi * (frame % period) / period
    yaw = 0.35 * np.sin(t)            # [-0.35, 0.35] horizontal shift
    pitch = 0.2 * np.sin(2 * t + 1.0)
    mouth = 0.5 + 0.5 * np.sin(3 * t)
    return yaw, pitch, mouth


def render_face(label: int, frame: int, image_size: int):
    """Render (image, segm) float32 in [0, 1]; (H, W, 3) and (H, W, 1)."""
    skin, bg, size, eye_sep = _identity_style(label)
    yaw, pitch, mouth = _pose_of_frame(frame)
    h = w = image_size

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy = yy / h - 0.5
    xx = xx / w - 0.5

    cx = 0.5 * yaw * size
    cy = 0.5 * pitch * size
    # head ellipse
    d2 = ((xx - cx) / size) ** 2 + ((yy - cy) / (1.25 * size)) ** 2
    head = (d2 < 1.0).astype(np.float32)

    img = np.empty((h, w, 3), np.float32)
    img[:] = bg
    img = img * (1 - head[..., None]) + skin * head[..., None]

    # eyes: dark circles, horizontal position shifts with yaw (the "pose")
    for side in (-1, 1):
        ex = cx + side * eye_sep * size * 0.5 + 0.3 * yaw * size
        ey = cy - 0.35 * size + 0.2 * pitch * size
        e2 = ((xx - ex) / (0.12 * size)) ** 2 + ((yy - ey) / (0.12 * size)) ** 2
        eye = (e2 < 1.0).astype(np.float32)
        img = img * (1 - eye[..., None]) + 0.05 * eye[..., None]

    # mouth: dark ellipse whose openness encodes `mouth`
    mx, my = cx, cy + 0.55 * size
    m2 = ((xx - mx) / (0.3 * size)) ** 2 + \
         ((yy - my) / (0.05 * size + 0.12 * size * mouth)) ** 2
    mo = (m2 < 1.0).astype(np.float32)
    img = img * (1 - mo[..., None]) + 0.1 * mo[..., None]

    # the style scalars are float64, so the math above upcasts; cast once
    return (img.astype(np.float32), np.ascontiguousarray(
        head[..., None], dtype=np.float32))
