"""Paper metrics (port of ``latentpose_tpu/eval/metrics.py``; reference
``compute_pose_identity_error.py:254-292``), in numpy and f64 as there.

- identity error = 1 − mean cosine similarity between each identity's
  ground-truth average ArcFace descriptor and the descriptors of its
  reenactments under *other* people's driving (self-driving excluded);
- pose reconstruction error = mean inter-ocular-normalized L2 distance of 68
  landmarks on self-driving, optionally after the optimal per-frame
  scale+shift alignment (the reference solves a 136x3 lstsq per frame; the
  closed form below is the same least-squares optimum, vectorized).
"""

from __future__ import annotations

import numpy as np


def identity_error(gt_descriptors, our_descriptors):
    """gt: (N, D) L2-normalized; ours: (N identities, N drivers, F, D)."""
    n, d = gt_descriptors.shape
    assert our_descriptors.shape[:2] == (n, n)
    f = our_descriptors.shape[2]
    cos = (gt_descriptors[:, None, None] * our_descriptors).sum(-1)
    cos = cos.astype(np.float64)
    idx = np.arange(n)
    cos[idx, idx] = 0.0  # exclude self-driving
    return 1.0 - cos.sum() / (n * (n - 1) * f)


def optimal_scale_shift(our, gt):
    """Per-frame lstsq optimum of || s*our + t - gt ||² over (s, tx, ty).

    our/gt: (..., 68, 2).  Returns (s (...,1,1), t (...,1,2)).
    s = Σ<x-x̄, y-ȳ> / Σ|x-x̄|²  (x, y flattened over the 136 coords with the
    shift applied per axis — the per-axis means absorb t).
    """
    x = our.astype(np.float64)
    y = gt.astype(np.float64)
    x_mean = x.mean(axis=-2, keepdims=True)  # per-axis mean
    y_mean = y.mean(axis=-2, keepdims=True)
    xc = x - x_mean
    yc = y - y_mean
    num = (xc * yc).sum(axis=(-1, -2), keepdims=True)  # (..., 1, 1)
    den = (xc * xc).sum(axis=(-1, -2), keepdims=True)
    s = num / np.maximum(den, 1e-12)                    # (..., 1, 1)
    t = y_mean - s * x_mean                             # (..., 1, 2)
    return s, t


def pose_reconstruction_error(gt_landmarks, our_landmarks,
                              apply_optimal_alignment=False):
    """gt/our: (N, F, 68, 2) pixel landmarks."""
    assert gt_landmarks.shape == our_landmarks.shape
    our = our_landmarks.astype(np.float64)
    gt = gt_landmarks.astype(np.float64)
    if apply_optimal_alignment:
        s, t = optimal_scale_shift(our, gt)
        our = our * s + t
    interocular = np.linalg.norm(gt[:, :, 36] - gt[:, :, 45],
                                 axis=-1).clip(min=1e-2)
    dist = np.linalg.norm(gt - our, axis=-1) / interocular[:, :, None]
    return dist.mean()
