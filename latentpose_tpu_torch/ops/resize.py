"""cv2.resize(..., INTER_LINEAR) in PyTorch, batched, on any device: the
preprocessing path's resizes (FAN's 256² input, the segmentation's test-time
scales and its probabilities back to the crop), which the JAX package
computes with cv2 on the host.

cv2's arithmetic: source coordinates ``(d + 0.5) * scale - 0.5`` in f32 with
``scale = 1 / (dst / src)``; the column's coordinate clamped to the image,
the row's rows clipped; for uint8 11-bit fixed-point weights, the horizontal
pass in integers and the vertical one as cv2's SIMD path computes it
(``((b0 * (S0 >> 4)) >> 16 + (b1 * (S1 >> 4)) >> 16 + 2) >> 2``, as
``csrc/lpr_loader.cpp`` ``resize_linear_u8``); for float32 two passes in
f32.
"""

from __future__ import annotations

import numpy as np
import torch

_COEF_BITS = 11


def _coefs(n_dst, n_src, clamp):
    """(first source index, next source index, weight of the next) of cv2's
    linear resize along one axis, as numpy arrays."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    if clamp:       # columns: cv2 clamps the coordinate itself
        low, high = s < 0, s >= n_src - 1
        f[low | high] = 0.0
        s[low] = 0
        s[high] = n_src - 1
    s0 = np.clip(s, 0, n_src - 1)
    s1 = np.clip(s + 1, 0, n_src - 1)
    return s0, s1, f


def resize_linear(images, size):
    """images: (B, H, W, C) or (B, H, W), uint8 or float32; size: (out_w,
    out_h) as cv2 takes it.  Returns the resized batch in the same dtype."""
    out_w, out_h = size
    squeeze = images.dim() == 3
    x = images.unsqueeze(-1) if squeeze else images
    _, h, w, _ = x.shape
    dev = x.device
    xs0, xs1, fx = _coefs(out_w, w, clamp=True)
    ys0, ys1, fy = _coefs(out_h, h, clamp=False)

    def idx(a):
        return torch.from_numpy(a).to(dev)

    if x.dtype == torch.uint8:
        one = 1 << _COEF_BITS

        def fixed(f):
            a1 = np.rint(f * one).astype(np.int32)
            a0 = np.rint((1.0 - f).astype(np.float32) * one).astype(np.int32)
            return idx(a0), idx(a1)

        a0, a1 = (a.view(1, 1, -1, 1) for a in fixed(fx))
        xi = x.int()
        rows = xi[:, :, idx(xs0)] * a0 + xi[:, :, idx(xs1)] * a1
        b0, b1 = (b.view(1, -1, 1, 1) for b in fixed(fy))
        v = ((b0 * (rows[:, idx(ys0)] >> 4)) >> 16) \
            + ((b1 * (rows[:, idx(ys1)] >> 4)) >> 16)
        out = ((v + 2) >> 2).clamp(0, 255).to(torch.uint8)
    elif x.dtype == torch.float32:
        a1 = idx(fx).view(1, 1, -1, 1)
        a0 = idx((1.0 - fx).astype(np.float32)).view(1, 1, -1, 1)
        rows = x[:, :, idx(xs0)] * a0 + x[:, :, idx(xs1)] * a1
        b1 = idx(fy).view(1, -1, 1, 1)
        b0 = idx((1.0 - fy).astype(np.float32)).view(1, -1, 1, 1)
        out = rows[:, idx(ys0)] * b0 + rows[:, idx(ys1)] * b1
    else:
        raise TypeError(f"resize_linear takes uint8 or float32, got "
                        f"{x.dtype}")
    return out.squeeze(-1) if squeeze else out
