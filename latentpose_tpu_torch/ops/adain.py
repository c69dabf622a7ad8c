"""Fused AdaIN + ReLU: the wrapper of the CUDA kernel and its plain version.

The kernel (``csrc/adain_fused.cu``) replaces the TPU kernel
``latentpose_tpu/ops/pallas/adain_fused.py`` (``adain_fused``).  It is bound
by device-memory bandwidth: one read and one write of x per call.  The TPU
kernel carried its sums along a sequential grid; on the card one launch runs
a thread-block cluster per sample: each block holds its slice of the sample's
pixels in shared memory (TMA bulk copies) while it sums them, the blocks
exchange partial sums through distributed shared memory in a fixed order, and
each block writes its slice normalised, with the ReLU fused.  The launch plan
(:func:`plan_launch`) is chosen here, in Python, so the CPU tests reach it.

The forward is one PyTorch operator, ``torch.ops.latentpose.adain_fused(x,
weight, bias, relu, eps)``, registered with ``torch.library``: both its CPU
implementation (:func:`adain_reference`) and its CUDA implementation (the
kernel, or raise) first check the inputs' dtypes, shapes and layout, and its
fake implementation gives the output's shape and dtype.  So ``torch.export`` keeps the operator itself in a graph, and the
kernel binds when the exported program runs.  The library is built at the
first launch, never at import.  ``adain.launches`` counts the calls that
launched the kernel (one CUDA launch each), so a run can show that its main
path went through it.  Training differentiates through a
``torch.autograd.Function`` whose forward is the operator and whose backward
(:func:`adain_backward`) is plain PyTorch in f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from latentpose_tpu_torch.ops import norms

THREADS = 256           # csrc/adain_fused.cu kThreads
SMEM_LIMIT = 232448     # shared memory a block may opt into on sm_90
MAX_CLUSTER = 16        # blocks per cluster (above 8: a non-portable size)
SLICE_BYTES = 128 << 10  # bytes of a sample per block, aimed at
# Where a sample cannot stay on chip, each block keeps this much of its slice
# resident, so that two or three blocks share an SM and more clusters run at
# once (faster on the H100 than filling shared memory: PERF.md, PR 3).
STREAMED_RESIDENT_BYTES = 64 << 10
CHUNKS = 8              # bulk copies (mbarriers) per block's resident part
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LIBRARY = ("adain_fused", ("adain_fused.cu",))   # name, sources under csrc/


class Plan(NamedTuple):
    """One launch: ``cluster`` blocks per sample, each over
    ``block_pixels`` consecutive pixels, of which at most ``resident``
    stay in shared memory (copied in chunks of ``chunk_pixels``);
    ``smem`` bytes of dynamic shared memory per block."""
    cluster: int
    block_pixels: int
    resident: int
    chunk_pixels: int
    smem: int

    @property
    def holds_sample(self) -> bool:
        """x is read from device memory once: every pixel stays on chip."""
        return self.resident >= self.block_pixels


def smem_bytes(c: int, itemsize: int, resident: int) -> int:
    """Shared memory of one block (csrc/adain_fused.cu layout): 16
    mbarriers, the (2, C) f32 block partials, the f32 row partials of every
    thread, then ``resident`` pixels of x."""
    vec = 16 // itemsize
    return 128 + 8 * c + 2 * 4 * THREADS * vec + resident * c * itemsize


def plan_launch(hw: int, c: int, itemsize: int,
                max_cluster: int = MAX_CLUSTER) -> Plan:
    """The launch plan for samples of (hw, c) in one dtype (the batch only
    sets the grid's second dimension).  A sample is cut into slices of about
    SLICE_BYTES, one block each, at most ``max_cluster`` blocks.  A block
    keeps its whole slice in shared memory where it fits beside the block's
    fixed buffers; otherwise it keeps STREAMED_RESIDENT_BYTES of it and
    streams the rest twice."""
    row = c * itemsize
    cluster = max(1, min(max_cluster, -(-hw * row // SLICE_BYTES), hw))
    block_pixels = -(-hw // cluster)
    cluster = -(-hw // block_pixels)          # no block without pixels
    fits = (SMEM_LIMIT - smem_bytes(c, itemsize, 0)) // row
    resident = block_pixels if block_pixels <= fits else \
        max(1, min(fits, STREAMED_RESIDENT_BYTES // row))
    chunk_pixels = max(1, -(-resident // CHUNKS))
    return Plan(cluster, block_pixels, resident, chunk_pixels,
                smem_bytes(c, itemsize, resident))


def adain_reference(x, weight, bias, relu: bool = True, eps: float = 1e-4):
    """Plain version: ``norms.adain`` on f32 copies (f32 statistics and
    affine, as the kernel computes them), optional ReLU, cast to x's dtype."""
    y = norms.adain(x.float(), weight.float(), bias.float(), eps)
    return (torch.relu(y) if relu else y).to(x.dtype)


def _check(x, weight, bias):
    # (written for host time: the wrapper runs 17 times a generator forward)
    dtype, shape = x.dtype, x.shape
    if dtype not in _DTYPES:
        raise TypeError(f"adain: x must be float32 or bfloat16, got {dtype}")
    if len(shape) != 4:
        raise ValueError(f"adain: x must be (B, H, W, C), got {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError("adain: x must be a contiguous NHWC buffer "
                         "(an NCHW tensor in channels_last, permuted)")
    bc, device = (shape[0], shape[3]), x.device
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != dtype or t.device != device:
            raise TypeError(f"adain: {name} must match x's dtype and device, "
                            f"got {t.dtype} on {t.device}")
        if t.shape != bc or t.stride(1) != 1:
            raise ValueError(f"adain: {name} must be (B, C) = {bc} with "
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
    lib = load_library(*LIBRARY)
    fn = lib.adain_fused_forward
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, p, ll, p, ll, p, i, p, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    occupancy = lib.adain_max_active_clusters
    occupancy.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    occupancy.restype = ctypes.c_int
    return fn, occupancy


@functools.lru_cache(maxsize=None)
def card_plan(hw: int, c: int, dtype: torch.dtype):
    """:func:`plan_launch` for the card, cached per (HW, C, dtype): the
    largest cluster (16, 8, ... 1) that the card can hold at least once.
    Returns the plan and its C form (hw, c, the plan's fields, dtype) as an
    int array, so that a launch passes it as one pointer."""
    _, occupancy = kernel_entry()
    for max_cluster in (16, 8, 4, 2, 1):
        plan = plan_launch(hw, c, torch.finfo(dtype).bits // 8, max_cluster)
        count = ctypes.c_int(0)
        err = occupancy(plan.cluster, plan.smem, _DTYPES[dtype],
                        ctypes.byref(count))
        if err == 0 and count.value > 0:
            return plan, (ctypes.c_int * 8)(hw, c, *plan, _DTYPES[dtype])
    raise RuntimeError(f"adain: no cluster fits the card for HW={hw} C={c} "
                       f"{dtype} (cudaError_t {err})")


def adain(x, weight, bias, relu: bool = True, eps: float = 1e-4):
    """IN(x) * weight + bias [+ ReLU] for x (B, H, W, C) contiguous NHWC,
    weight and bias (B, C) in x's dtype; returns a new (B, H, W, C) tensor.

    Differentiable in x, weight and bias: the forward is the kernel (or the
    plain version on the CPU), the backward :func:`adain_backward`."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"adain: unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _AdaIN.apply(x, weight, bias, relu, eps)
    return _forward(x, weight, bias, relu, eps)     # no graph to record


def adain_backward(x, weight, bias, grad, relu: bool, eps: float):
    """Gradients of :func:`adain_reference` for ``grad`` (B, H, W, C), in
    plain PyTorch and f32: mean and rstd are recomputed from x, the ReLU mask
    from the pre-activation.  Returns (dx, dweight, dbias) in the inputs'
    dtypes."""
    x32 = x.float()
    n = x.shape[1] * x.shape[2]
    mean, var = norms.moments(x32)     # as the plain forward computes them
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * rstd
    w32 = weight.float()[:, None, None, :]
    g = grad.float()
    if relu:
        g = g * (xhat * w32 + bias.float()[:, None, None, :] > 0)
    dweight = (g * xhat).sum(dim=(1, 2))
    dbias = g.sum(dim=(1, 2))
    gx = g * w32
    dx = rstd * (gx - gx.sum(dim=(1, 2), keepdim=True) / n
                 - xhat * (gx * xhat).sum(dim=(1, 2), keepdim=True) / n)
    return dx.to(x.dtype), dweight.to(weight.dtype), dbias.to(bias.dtype)


class _AdaIN(torch.autograd.Function):
    """The kernel's forward under autograd; the backward is plain PyTorch
    (the TPU package trains through XLA's ``norms.adain`` and has no backward
    kernel either)."""

    @staticmethod
    def forward(ctx, x, weight, bias, relu, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.relu, ctx.eps = relu, eps
        return _forward(x, weight, bias, relu, eps)

    @staticmethod
    def backward(ctx, grad):
        x, weight, bias = ctx.saved_tensors
        return (*adain_backward(x, weight, bias, grad, ctx.relu, ctx.eps),
                None, None)


def _forward(x, weight, bias, relu, eps):
    return ADAIN_OP(x, weight, bias, relu, eps)


def _plain(x, weight, bias, relu, eps):
    """The operator's CPU implementation: :func:`adain_reference` on what
    the kernel takes."""
    _check(x, weight, bias)
    return adain_reference(x, weight, bias, relu, eps)


def _launch(x, weight, bias, relu, eps):
    """The operator's CUDA implementation: one launch, no scratch."""
    _check(x, weight, bias)
    check_kernel_layout(x)
    b, h, w, c = x.shape
    _, plan = card_plan(h * w, c, x.dtype)
    fn, _ = kernel_entry()
    out = torch.empty_like(x)
    args = (x.data_ptr(), weight.data_ptr(), weight.stride(0),
            bias.data_ptr(), bias.stride(0), out.data_ptr(), b, plan,
            int(relu), float(eps))
    # the launch goes to the current device, on its current stream (the raw
    # handle: a Stream object per call costs microseconds of host time)
    if x.device.index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(x.device.index))
    else:
        with torch.cuda.device(x.device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(x.device.index))
    if err:
        raise RuntimeError(f"adain_fused_forward failed: cudaError_t {err}")
    adain.launches += 1
    return out


adain.launches = 0

# The operator (``latentpose::adain_fused``).  ``Library`` with ``impl`` per
# dispatch key, not ``torch.library.custom_op``: the wrapper runs 17 times a
# generator forward, and the lower-level registration adds less host time a
# call (PERF.md).
LIBRARY_OPS = torch.library.Library("latentpose", "DEF")
LIBRARY_OPS.define("adain_fused(Tensor x, Tensor weight, Tensor bias, "
                   "bool relu, float eps) -> Tensor")
LIBRARY_OPS.impl("adain_fused", _plain, "CPU")
LIBRARY_OPS.impl("adain_fused", _launch, "CUDA")


@torch.library.register_fake("latentpose::adain_fused", lib=LIBRARY_OPS)
def _adain_fake(x, weight, bias, relu, eps):
    return torch.empty_like(x)


# the overload itself: the packet's overload lookup costs host time a call
ADAIN_OP = torch.ops.latentpose.adain_fused.default
