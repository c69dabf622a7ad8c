"""Nearest 2x upsampling and 2x2 average pooling (port of the first two ops
of ``latentpose_tpu/ops/image.py``).

These act on the modules' internal NCHW tensors (``channels_last`` memory
format is kept).  The JAX package's polyphase upsample+conv is not ported:
nearest-up followed by a 3x3 conv is the same math, and that layout trick
was for the TPU's matrix unit.
"""

from __future__ import annotations

import torch.nn.functional as F


def upsample_nearest_2x(x):
    """(B, C, H, W) -> (B, C, 2H, 2W), nearest."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def avg_pool_2x(x):
    """AvgPool2d(kernel=2, stride=2)."""
    return F.avg_pool2d(x, 2)
