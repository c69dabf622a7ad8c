"""LPIPS (Zhang et al. 2018, PerceptualSimilarity v0.1, net='alex'), port
of ``latentpose_tpu/eval/lpips.py``.

Inputs scaled to [-1, 1] and by the ScalingLayer's shift and scale; the
AlexNet ``features`` tower's five post-ReLU taps (64/192/384/256/256
channels), each unit-normalized along channels; the squared difference
through the non-negative 1x1 'lin' heads, the spatial mean, summed over the
taps.

The weights are ``lpips_alex.npz``, the JAX package's flat file
(``conv{i}/kernel`` HWIO, ``conv{i}/bias``, ``lin{i}/weight``), read by
:func:`load_lpips_params`.  Without it, ``allow_random`` draws the JAX
package's deterministic random tower (``RandomState(0)`` in its order), the
same function in both packages but NOT the LPIPS metric.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

logger = logging.getLogger("latentpose_tpu_torch.lpips")

# ScalingLayer constants (PerceptualSimilarity lpips/lpips.py ScalingLayer)
LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# AlexNet features plan: (out_ch, kernel, stride, pad, maxpool_before)
_ALEX_PLAN = (
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
)
ALEX_CHANNELS = tuple(p[0] for p in _ALEX_PLAN)

WEIGHTS_FILE = "lpips_alex.npz"


def _params(flat, device):
    """{conv{i}: {weight OIHW, bias}, lin{i}: (C,)} on ``device`` from the
    flat arrays (kernels HWIO)."""
    params = {}
    for i in range(len(_ALEX_PLAN)):
        kernel = np.asarray(flat[f"conv{i}/kernel"], np.float32)
        params[f"conv{i}"] = {
            "weight": torch.from_numpy(
                np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))).to(device),
            "bias": torch.from_numpy(
                np.asarray(flat[f"conv{i}/bias"], np.float32)).to(device),
        }
        params[f"lin{i}"] = torch.from_numpy(
            np.asarray(flat[f"lin{i}/weight"], np.float32)).to(device)
    return params


def load_lpips_params(weights_dir, allow_random=False, device="cuda"):
    """The LPIPS weights on ``device``; the deterministic random tower only
    with ``allow_random`` (testing).  Returns (params, armed: bool)."""
    path = Path(weights_dir or "") / WEIGHTS_FILE
    if path.is_file():
        with np.load(str(path)) as raw:
            return _params({k: raw[k] for k in raw.files}, device), True
    if not allow_random:
        raise FileNotFoundError(
            f"LPIPS weights not found at {path} — convert the official "
            f"PerceptualSimilarity v0.1 alex weights with "
            f"`python tools/convert_torch_weights.py lpips "
            f"ALEX_PTH:LIN_PTH {Path(weights_dir or '.')}` (see "
            f"WEIGHTS.md), or pass allow_random for a NON-LPIPS test tower")
    logger.warning(
        "LPIPS: no weights under %r — deterministic RANDOM tower "
        "(testing only; the number produced is not LPIPS)", weights_dir)
    rng = np.random.RandomState(0)
    flat = {}
    in_ch = 3
    for i, (out_ch, k, _s, _p, _pool) in enumerate(_ALEX_PLAN):
        flat[f"conv{i}/kernel"] = (rng.randn(k, k, in_ch, out_ch)
                                   .astype(np.float32)
                                   * np.sqrt(2.0 / (k * k * in_ch)))
        flat[f"conv{i}/bias"] = np.zeros((out_ch,), np.float32)
        flat[f"lin{i}/weight"] = (np.abs(rng.randn(out_ch))
                                  .astype(np.float32) / out_ch)
        in_ch = out_ch
    return _params(flat, device), False


def _alex_features(params, x):
    """x: (B, 3, H, W) in LPIPS-normalized space -> the 5 post-ReLU taps."""
    taps = []
    h = x
    for i, (_out, _k, stride, pad, pool) in enumerate(_ALEX_PLAN):
        if pool:
            h = F.max_pool2d(h, 3, 2)   # floor mode, no padding: VALID
        conv = params[f"conv{i}"]
        h = F.relu(F.conv2d(h, conv["weight"], conv["bias"], stride=stride,
                            padding=pad))
        taps.append(h)
    return taps


def lpips(params, a, b):
    """LPIPS distance per pair.  a, b: (B, H, W, 3) float RGB in [0, 1]."""
    dev = params["lin0"].device
    shift = torch.from_numpy(LPIPS_SHIFT).to(dev).view(1, 3, 1, 1)
    scale = torch.from_numpy(LPIPS_SCALE).to(dev).view(1, 3, 1, 1)

    def prep(x):
        x = x.float().permute(0, 3, 1, 2) * 2.0 - 1.0
        return (x - shift) / scale

    def unit(f):
        return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True))
                    + 1e-10)

    total = 0.0
    for i, (fa, fb) in enumerate(zip(_alex_features(params, prep(a)),
                                     _alex_features(params, prep(b)))):
        diff2 = (unit(fa) - unit(fb)) ** 2
        w = params[f"lin{i}"].clamp_min(0.0).view(1, -1, 1, 1)  # non-negative
        total = total + torch.mean(torch.sum(diff2 * w, dim=1), dim=(1, 2))
    return total


def lpips_fn(weights_dir, allow_random=False, device="cuda"):
    """(distance fn, armed) — armed=False means the random tower."""
    params, armed = load_lpips_params(weights_dir, allow_random, device)

    def fn(a, b):
        with torch.no_grad():
            return lpips(params, torch.as_tensor(a, device=device),
                         torch.as_tensor(b, device=device))
    return fn, armed
