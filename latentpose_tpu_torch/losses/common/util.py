"""Shared helpers for the criteria (port of
``latentpose_tpu/losses/common/util.py``)."""

from __future__ import annotations


def strip_time(x):
    """Drop the singleton time axis: (B, 1, H, W, C) -> (B, H, W, C)."""
    if x is not None and x.dim() > 4:
        return x[:, 0]
    return x
