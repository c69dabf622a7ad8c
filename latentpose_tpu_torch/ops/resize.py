"""cv2.resize(...) in PyTorch, batched, on any device: INTER_LINEAR for the
preprocessing path's resizes (FAN's 256² input, the segmentation's test-time
scales and its probabilities back to the crop), INTER_CUBIC and INTER_AREA on
uint8 for the eval harness's face crops (ArcFace's 112², the proxy
descriptor's 16²), all of which the JAX package computes with cv2 on the
host.

INTER_LINEAR: source coordinates ``(d + 0.5) * scale - 0.5`` in f32 with
``scale = 1 / (dst / src)``; the column's coordinate clamped to the image,
the row's rows clipped; for uint8 11-bit fixed-point weights, the horizontal
pass in integers and the vertical one as cv2's SIMD path computes it
(``((b0 * (S0 >> 4)) >> 16 + (b1 * (S1 >> 4)) >> 16 + 2) >> 2``, as
``csrc/lpr_loader.cpp`` ``resize_linear_u8``); for float32 two passes in
f32.

INTER_CUBIC (A = -0.75, out-of-image taps replicate the edge): cv2's x86
builds resize uint8 through IPP, which computes in f32 and rounds once, and
so does this (weights evaluated in f64 from the exact fraction, rounded to
f32; the horizontal then the vertical pass, each a left-to-right f32 sum of
four products; round half to even).  It gives IPP's values except on exact
.5 ties, which IPP's own rounding of its weights decides (~1e-5 of the
values).  cv2's own code (IPP off, or a build without it) is another
function: 11-bit fixed-point weights, which move ~5 % of the values of
noise by one level.

INTER_AREA (downscaling): an integer factor sums each block exactly, then
``(s + 2) >> 2`` for 2x2 and ``rint(f32(s) * f32(1 / area))`` otherwise; a
non-integer factor is cv2's ``computeResizeAreaTab`` weights, each row's
taps summed left to right in f32, then the rows' in the same way, rounded
half to even.
"""

from __future__ import annotations

import functools
import math

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


def _index(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _as_nhwc(images):
    """(B, H, W, C) view of a (B, H, W, C) or (B, H, W) batch, and whether
    to squeeze the channel back."""
    squeeze = images.dim() == 3
    return (images.unsqueeze(-1) if squeeze else images), squeeze


def _cubic_weights(x):
    """cv2's ``interpolateCubic`` (A = -0.75) at fractions ``x``: (...,
    4)."""
    a = -0.75
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    return np.stack([c0, c1, c2, 1 - c0 - c1 - c2], axis=-1)


@functools.lru_cache(maxsize=64)
def _cubic_coefs(n_dst, n_src):
    """(source indices (n_dst, 4), f32 weights (n_dst, 4)) of one axis."""
    f = (np.arange(n_dst) + 0.5) * (1.0 / (n_dst / n_src)) - 0.5
    s = np.floor(f).astype(np.int64)
    idx = np.clip(s[:, None] - 1 + np.arange(4)[None], 0, n_src - 1)
    return idx, _cubic_weights(f - s).astype(np.float32)


def resize_cubic(images, size):
    """cv2.resize(..., INTER_CUBIC) of a uint8 batch (B, H, W, C) or (B, H,
    W); size: (out_w, out_h) as cv2 takes it.  Returns uint8."""
    if images.dtype != torch.uint8:
        raise TypeError(f"resize_cubic takes uint8, got {images.dtype}")
    out_w, out_h = size
    x, squeeze = _as_nhwc(images)
    _, h, w, _ = x.shape
    if (h, w) == (out_h, out_w):
        return images.clone()
    dev = x.device
    xi, xw = (_index(a, dev) for a in _cubic_coefs(out_w, w))
    yi, yw = (_index(a, dev) for a in _cubic_coefs(out_h, h))
    xf = x.float()
    rows = xf[:, :, xi[:, 0]] * xw[:, 0].view(1, 1, -1, 1)
    for k in (1, 2, 3):
        rows = rows + xf[:, :, xi[:, k]] * xw[:, k].view(1, 1, -1, 1)
    acc = rows[:, yi[:, 0]] * yw[:, 0].view(1, -1, 1, 1)
    for k in (1, 2, 3):
        acc = acc + rows[:, yi[:, k]] * yw[:, k].view(1, -1, 1, 1)
    out = torch.round(acc).clamp(0, 255).to(torch.uint8)
    return out.squeeze(-1) if squeeze else out


@functools.lru_cache(maxsize=64)
def _area_taps(n_src, n_dst):
    """cv2's ``computeResizeAreaTab`` along one axis, padded to a table:
    (source indices (n_dst, T), f32 weights (n_dst, T)); a padded tap has
    weight 0 and index 0."""
    scale = n_src / n_dst
    taps = []
    for d in range(n_dst):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, n_src - fs1)
        s2 = min(math.floor(fs2), n_src - 1)
        s1 = min(math.ceil(fs1), s2)
        row = []
        if s1 - fs1 > 1e-3:
            row.append((s1 - 1, (s1 - fs1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if fs2 - s2 > 1e-3:
            row.append((s2, min(min(fs2 - s2, 1.0), cell) / cell))
        taps.append(row)
    width = max(len(row) for row in taps)
    idx = np.zeros((n_dst, width), np.int64)
    alpha = np.zeros((n_dst, width), np.float32)
    for d, row in enumerate(taps):
        for t, (s, a) in enumerate(row):
            idx[d, t], alpha[d, t] = s, np.float32(a)
    return idx, alpha


def resize_area(images, size):
    """cv2.resize(..., INTER_AREA) of a uint8 batch (B, H, W, C) or (B, H,
    W) to a size no larger on either axis; size: (out_w, out_h) as cv2
    takes it.  Returns uint8."""
    if images.dtype != torch.uint8:
        raise TypeError(f"resize_area takes uint8, got {images.dtype}")
    out_w, out_h = size
    x, squeeze = _as_nhwc(images)
    b, h, w, c = x.shape
    if out_w > w or out_h > h:
        raise ValueError(f"resize_area downscales only: ({h}, {w}) -> "
                         f"({out_h}, {out_w})")
    if (h, w) == (out_h, out_w):
        return images.clone()
    dev = x.device
    if w % out_w == 0 and h % out_h == 0:
        sx, sy = w // out_w, h // out_h
        s = x.int().reshape(b, out_h, sy, out_w, sx, c).sum(dim=(2, 4))
        if sx == sy == 2 and c in (1, 3, 4):
            out = (s + 2) >> 2
        else:
            scale = np.float32(1) / np.float32(sx * sy)
            out = torch.round(s.float() * float(scale)).clamp(0, 255)
    else:
        xi, xa = (_index(a, dev) for a in _area_taps(w, out_w))
        yi, ya = (_index(a, dev) for a in _area_taps(h, out_h))
        xf = x.float()
        rows = torch.zeros((b, h, out_w, c), dtype=torch.float32, device=dev)
        for t in range(xi.shape[1]):
            rows = rows + xf[:, :, xi[:, t]] * xa[:, t].view(1, 1, -1, 1)
        acc = rows[:, yi[:, 0]] * ya[:, 0].view(1, -1, 1, 1)
        for t in range(1, yi.shape[1]):
            acc = acc + rows[:, yi[:, t]] * ya[:, t].view(1, -1, 1, 1)
        out = torch.round(acc).clamp(0, 255)
    out = out.to(torch.uint8)
    return out.squeeze(-1) if squeeze else out
