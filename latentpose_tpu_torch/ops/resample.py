"""Axis-aligned bilinear resampling as two small matrix products (port of
``affine_resample`` and ``crop_and_resize`` in
``latentpose_tpu/ops/resample.py``).

Per sample, ``out = W_y @ img @ W_xᵀ`` per channel, with W_y (H_out, H_in)
and W_x (W_out, W_in) holding the two bilinear taps of each output row or
column; borders reflect as ``grid_sample(padding_mode='reflection',
align_corners=False)``.  Differentiable in the image.  NHWC tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _reflect(coords, size: float):
    """Fold pixel coordinates into [0, size - 1] about the -0.5 and
    size - 0.5 borders."""
    period = 2.0 * size
    t = torch.remainder(coords + 0.5, period)
    t = torch.where(t >= size, period - t, t)
    return torch.clamp(t - 0.5, 0.0, size - 1.0)


def _interp_matrix(coords, in_size: int):
    """(B, N_out) source coordinates -> (B, N_out, in_size) taps."""
    c0 = torch.floor(coords)
    frac = coords - c0
    i0 = torch.clamp(c0, 0, in_size - 1).long()
    i1 = torch.clamp(c0 + 1, 0, in_size - 1).long()
    return (F.one_hot(i0, in_size).to(coords.dtype) * (1.0 - frac)[..., None]
            + F.one_hot(i1, in_size).to(coords.dtype) * frac[..., None])


def resample_axis_aligned(images, src_y, src_x):
    """images (B, H, W, C); src_y (B, H_out), src_x (B, W_out): source pixel
    coordinates of each output row and column, before reflection."""
    _, h, w, _ = images.shape
    wy = _interp_matrix(_reflect(src_y, float(h)), h)
    wx = _interp_matrix(_reflect(src_x, float(w)), w)
    tmp = torch.einsum("bih,bhwc->biwc", wy, images.to(src_y.dtype))
    return torch.einsum("bkw,biwc->bikc", wx, tmp).to(images.dtype)


def _output_centers(n_out, device):
    """Normalised [-1, 1] centres of the output pixels (align_corners
    False)."""
    return (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        / n_out * 2.0 - 1.0


def _to_pixels(norm_coords, size: float):
    return ((norm_coords + 1.0) * size - 1.0) / 2.0


def affine_resample(images, sx, sy, tx, ty):
    """Per-sample axis-aligned affine warp (the affine augmentations): each
    (B,) scale > 1 zooms in, each shift is in [-1, 1] grid units."""
    _, h, w, _ = images.shape
    gy = _output_centers(h, images.device)
    gx = _output_centers(w, images.device)
    src_y = gy[None, :] / sy[:, None] - ty[:, None]
    src_x = gx[None, :] / sx[:, None] - tx[:, None]
    return resample_axis_aligned(images, _to_pixels(src_y, float(h)),
                                 _to_pixels(src_x, float(w)))


def crop_and_resize(images, bboxes):
    """Crop each image to its box (t, b, l, r) in pixels and resize it back
    to the image's size, bilinearly."""
    _, h, w, _ = images.shape
    t, bb, l, r = (bboxes[:, i].float() for i in range(4))
    sy, sx = (bb - t) / h, (r - l) / w
    ty, tx = (t + bb) / h - 1.0, (l + r) / w - 1.0
    gy = _output_centers(h, images.device)
    gx = _output_centers(w, images.device)
    src_y = _to_pixels(gy[None, :] * sy[:, None] + ty[:, None], float(h))
    src_x = _to_pixels(gx[None, :] * sx[:, None] + tx[:, None], float(w))
    return resample_axis_aligned(images, src_y, src_x)
