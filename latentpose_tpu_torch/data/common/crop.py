"""The dataset's bounding-box math (port of the bbox half of
``latentpose_tpu/data/common/crop.py``; the blur-faded padded crop itself
runs in C++, ``csrc/lpr_loader.cpp``, for frames and masks alike):

- the raw detector bbox (l, t, r, b in [0, 1] of the source image) is
  squared around its centre and scaled by 1.8;
- integer pixel coords: floor(l, t), ceil(r, b), re-squared, then +1 to make
  b and r exclusive.
"""

from __future__ import annotations

import math

BBOX_SCALE = 1.8


def square_and_scale_bbox(l, t, r, b, scale=BBOX_SCALE):
    """Square the bbox around its centre and scale it."""
    cx, cy = (l + r) * 0.5, (t + b) * 0.5
    size = max(b - t, r - l) * scale
    half = size / 2
    return cx - half, cy - half, cx + half, cy + half


def bbox_to_integer_coords(t, l, b, r, image_h, image_w):
    """[0, 1]-space bbox -> integer pixel coords, exactly square, exclusive.

    All four coordinates are scaled by ``image_h``, not w, as the reference
    does (VoxCeleb2.1 frames are square, where it is the same)."""
    t, l, b, r = (v * image_h for v in (t, l, b, r))
    l, t = math.floor(l), math.floor(t)
    r, b = math.ceil(r), math.ceil(b)
    b += (r - l) - (b - t)  # restore exact squareness after rounding
    return t, l, b + 1, r + 1
