"""Fused AdaIN + ReLU: the wrapper of the CUDA kernel and its plain version.

The kernel (``csrc/adain_fused.cu``) replaces the TPU kernel
``latentpose_tpu/ops/pallas/adain_fused.py`` (``adain_fused``).  It is bound
by device-memory bandwidth: per call it reads x twice and writes it once.
The TPU kernel carried its sums along a sequential grid; on the card blocks
run in no order, so a first pass writes f32 partial sums per (sample, pixel
chunk), a tiny pass folds them into per-channel scale and shift, and a second
pass streams x again and applies them with the ReLU fused.  The chunk plan
(:func:`plan_chunks`) is chosen here, in Python, so the CPU tests reach it.

A CPU tensor goes to :func:`adain_reference`; a CUDA tensor launches the
kernel or raises.  ``adain.launches`` counts the calls that launched the
kernel (three CUDA launches each), so a run can show that its main path went
through it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from latentpose_tpu_torch.ops import norms

THREADS = 256           # csrc/adain_fused.cu kThreads
TARGET_BLOCKS = 1024    # ~8 resident 256-thread blocks on each of 132 SMs
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LIBRARY = ("adain_fused", ("adain_fused.cu",))   # name, sources under csrc/


def adain_reference(x, weight, bias, relu: bool = True, eps: float = 1e-4):
    """Plain version: ``norms.adain`` on f32 copies (f32 statistics and
    affine, as the kernel computes them), optional ReLU, cast to x's dtype."""
    y = norms.adain(x.float(), weight.float(), bias.float(), eps)
    return (torch.relu(y) if relu else y).to(x.dtype)


def plan_chunks(batch: int, hw: int, c: int, itemsize: int):
    """Pixels per chunk and chunk count for a (batch, hw, c) call.

    Each thread owns one 16-byte vector of channels; a 256-thread block
    covers ``rows`` pixels per step.  Chunks are sized so the grid has about
    TARGET_BLOCKS blocks (one wave on the card) when the tensor allows it.
    """
    vec = 16 // itemsize
    rows = THREADS // (c // vec)
    per_sample = -(-TARGET_BLOCKS // batch)
    chunk_pixels = max(rows, -(-hw // per_sample))
    chunk_pixels = -(-chunk_pixels // rows) * rows
    return chunk_pixels, -(-hw // chunk_pixels)


def _check(x, weight, bias):
    if x.dtype not in _DTYPES:
        raise TypeError(f"adain: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"adain: x must be (B, H, W, C), got {tuple(x.shape)}")
    b, _, _, c = x.shape
    if not x.is_contiguous():
        raise ValueError("adain: x must be a contiguous NHWC buffer "
                         "(an NCHW tensor in channels_last, permuted)")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"adain: {name} must match x's dtype and device, "
                            f"got {t.dtype} on {t.device}")
        if t.dim() != 2 or tuple(t.shape) != (b, c) or t.stride(1) != 1:
            raise ValueError(f"adain: {name} must be (B, C) = {(b, c)} with "
                             f"unit channel stride, got {tuple(t.shape)} "
                             f"strides {t.stride()}")


def check_kernel_layout(x):
    """What the kernel adds to :func:`_check`: 16-byte vectors of channels,
    at most one per thread of a block."""
    c, vec = x.shape[-1], 16 // x.element_size()
    if c % vec or c // vec > THREADS:
        raise ValueError(f"adain: C={c} must be a multiple of {vec} and at "
                         f"most {THREADS * vec} for {x.dtype} on the card")
    if x.data_ptr() % 16:
        raise ValueError("adain: x must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def kernel_entry():
    """Build (at first use) and bind the kernel's C entry point."""
    from latentpose_tpu_torch.ops.cuda_build import load_library
    fn = load_library(*LIBRARY).adain_fused_forward
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, p, ll, p, ll, p, p, p, i, i, i, i, i, i, i,
                   ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def adain(x, weight, bias, relu: bool = True, eps: float = 1e-4):
    """IN(x) * weight + bias [+ ReLU] for x (B, H, W, C) contiguous NHWC,
    weight and bias (B, C) in x's dtype; returns a new (B, H, W, C) tensor."""
    _check(x, weight, bias)
    if x.device.type == "cpu":
        return adain_reference(x, weight, bias, relu, eps)
    if x.device.type != "cuda":
        raise ValueError(f"adain: unsupported device {x.device}")
    check_kernel_layout(x)
    b, h, w, c = x.shape
    chunk_pixels, chunks = plan_chunks(b, h * w, c, x.element_size())
    fn = kernel_entry()
    out = torch.empty_like(x)
    partial = torch.empty((b, chunks, 2, c), dtype=torch.float32,
                          device=x.device)
    coef = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):   # the launch goes to the current device
        err = fn(x.data_ptr(), weight.data_ptr(), weight.stride(0),
                 bias.data_ptr(), bias.stride(0), out.data_ptr(),
                 partial.data_ptr(), coef.data_ptr(), b, h * w, c,
                 chunk_pixels, chunks, _DTYPES[x.dtype], int(relu),
                 float(eps), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"adain_fused_forward failed: cudaError_t {err}")
    adain.launches += 1
    return out


adain.launches = 0
