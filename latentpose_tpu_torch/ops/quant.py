"""int8 convolutions for drive's ``--quantize int8|int8_static`` (port of
``latentpose_tpu/ops/quant.py``).

Two schemes, rounded as the JAX package rounds them, bit for bit:

1. **Dynamic** (``int8``): the activation's scale is ``max|x| / 127`` over
   the whole tensor, taken in each call; x is divided by it.
2. **Static** (``int8_static``): the scale is the largest of the
   per-input-channel maxima that a calibration pass recorded
   (:func:`act_absmax_per_channel`), reduced to one number; x is multiplied
   by its reciprocal, and saturates beyond the calibrated range.

The weights get one scale per output channel, taken on the spectral-norm
weight W/σ in the compute dtype.  Values round half to even and clip to
±127.  The product is int8 x int8 -> int32, exact; its epilogue is bf16:
``acc.to(bf16) * (s_x * s_k).to(bf16)``, the scales' product in f32 first.

Layout: NCHW activations (``channels_last`` in memory), OIHW kernels; the
kernel's scales run over O.

The product (:func:`int8_conv`): a CPU tensor takes the plain route, a
float64 convolution of the int8 values, exact because every partial sum is
an integer below 2^27; a CUDA tensor takes the card's route, an im2col of
the zero-padded NHWC activation built from shifted slices and
``torch._int_mm`` (cuBLASLt on the int8 tensor cores), with no fallback.
The JAX package computes this product with XLA outside any Pallas kernel, so
the card's route is a library GEMM.  ``int8_conv.launches`` counts the calls
that took the card's route (one per convolution, however many row chunks).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

QMAX = 127.0
# the im2col of one chunk of samples, at most (the flagship's 256² conv1 at
# batch 32 is 1.2 GB)
IM2COL_BYTES = 1 << 30


def quantize_dynamic(x):
    """x (any float dtype) -> (int8 tensor, f32 scalar scale)."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax() / QMAX, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -QMAX, QMAX)
    return q.to(torch.int8), scale


def quantize_static(x, act_absmax):
    """x -> (int8 tensor, f32 scalar scale) with the per-tensor scale of
    the calibrated per-input-channel maxima ``act_absmax`` (C,)."""
    scale = torch.clamp(act_absmax.float().amax() / QMAX, min=1e-12)
    q = torch.clamp(torch.round(x.float() * (1.0 / scale)), -QMAX, QMAX)
    return q.to(torch.int8), scale


def quantize_kernel_per_channel(kernel):
    """OIHW float kernel -> (int8 kernel, f32 per-output-channel scales)."""
    k32 = kernel.float()
    scales = torch.clamp(k32.abs().amax(dim=(1, 2, 3)) / QMAX, min=1e-12)
    q = torch.clamp(torch.round(k32 / scales[:, None, None, None]),
                    -QMAX, QMAX)
    return q.to(torch.int8), scales


def act_absmax_per_channel(x):
    """(B, C, H, W) -> (C,) f32 absolute maxima, for calibration."""
    return x.float().abs().amax(dim=(0, 2, 3))


def int8_conv_reference(xq, kq, padding: int):
    """The plain route: int8 (B, C, H, W) x int8 (O, C, kh, kw) -> int32
    (B, O, H', W'), zero padding, stride 1, through an exact float64
    convolution."""
    return F.conv2d(xq.double(), kq.double(), padding=padding).to(torch.int32)


def int8_conv(xq, kq, padding: int):
    """int8 x int8 -> int32 convolution, zero padding, stride 1: the plain
    route on a CPU tensor, the card's im2col + ``torch._int_mm`` on a CUDA
    tensor.  Returns NCHW (``channels_last`` in memory on the card)."""
    if xq.dtype != torch.int8 or kq.dtype != torch.int8:
        raise TypeError(f"int8_conv takes int8 tensors, got {xq.dtype} and "
                        f"{kq.dtype}")
    if xq.device != kq.device:
        raise ValueError(f"int8_conv: x on {xq.device}, kernel on "
                         f"{kq.device}")
    if xq.device.type == "cpu":
        return int8_conv_reference(xq, kq, padding)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {xq.device}")
    out = _im2col_int_mm(xq, kq, padding)
    int8_conv.launches += 1
    return out


int8_conv.launches = 0


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _im2col_int_mm(xq, kq, padding):
    """The card's route.  Each chunk of samples: an im2col (rows: output
    pixels, columns: (kh, kw, C)) from kh x kw shifted slices of the padded
    NHWC activation, then one ``torch._int_mm`` against the kernel's (K, O)
    view.  cuBLASLt takes more than 16 rows and K, O multiples of 8, so the
    rows and columns are padded with zeros, which leaves the sums exact."""
    b, c, h, w = xq.shape
    o, ck, kh, kw = kq.shape
    if ck != c:
        raise ValueError(f"int8_conv: kernel takes {ck} channels, x has {c}")
    xh = xq.permute(0, 2, 3, 1)                          # NHWC
    if padding:
        xh = F.pad(xh, (0, 0, padding, padding, padding, padding))
    ho, wo = xh.shape[1] - kh + 1, xh.shape[2] - kw + 1
    k, kp, op = kh * kw * c, _round_up(kh * kw * c, 8), _round_up(o, 8)
    weight = kq.permute(0, 2, 3, 1).reshape(o, k)       # (O, K), (kh, kw, C)
    if kp != k or op != o:
        weight = F.pad(weight, (0, kp - k, 0, op - o))
    weight = weight.contiguous().t()                    # (K, O), column-major
    out = torch.empty((b, ho, wo, o), dtype=torch.int32, device=xq.device)
    per_sample = ho * wo * kp
    step = max(1, IM2COL_BYTES // per_sample)
    for s in range(0, b, step):
        e = min(b, s + step)
        if kh == kw == 1 and kp == k:
            cols = xh[s:e].reshape(-1, k)
        else:
            taps = [xh[s:e, i:i + ho, j:j + wo, :]
                    for i in range(kh) for j in range(kw)]
            if kp != k:
                taps.append(xh.new_zeros((e - s, ho, wo, kp - k)))
            cols = torch.cat(taps, dim=-1).reshape(-1, kp)
        rows = cols.shape[0]
        if rows <= 16:
            cols = F.pad(cols, (0, 0, 0, 17 - rows))
        acc = torch._int_mm(cols, weight)
        out[s:e] = acc[:rows, :o].view(e - s, ho, wo, o)
    return out.permute(0, 3, 1, 2)


def epilogue(acc, s_x, s_k, out_dtype):
    """bf16 epilogue: the accumulators and the scales' f32 product, each
    cast to bf16, multiplied in bf16."""
    scale = (s_x * s_k).to(torch.bfloat16)[None, :, None, None]
    return (acc.to(torch.bfloat16) * scale).to(out_dtype)


def conv2d_int8(x, kernel, padding: int = 1, out_dtype=torch.bfloat16):
    """Dynamic-scale quantized conv: float NCHW x, float OIHW kernel, float
    out; ``conv(x, kernel)`` up to the symmetric quantization's rounding."""
    xq, s_x = quantize_dynamic(x)
    kq, s_k = quantize_kernel_per_channel(kernel)
    return epilogue(int8_conv(xq, kq, padding), s_x, s_k, out_dtype)


def conv2d_int8_static(x, kernel, act_absmax, padding: int = 1,
                       out_dtype=torch.bfloat16):
    """Static-calibration quantized conv: the activation's scale from the
    calibrated per-input-channel maxima ``act_absmax`` (C,), reduced to the
    per-tensor max."""
    xq, s_x = quantize_static(x, act_absmax)
    kq, s_k = quantize_kernel_per_channel(kernel)
    return epilogue(int8_conv(xq, kq, padding), s_x, s_k, out_dtype)
