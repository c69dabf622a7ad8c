"""Fused BN-apply -> ReLU -> 1x1 conv -> BN statistics: the wrapper of the CUDA
kernel, its plain version, and ``fold_bn``.

The kernel (``csrc/conv_bn_fused.cu``) replaces the TPU kernel
``latentpose_tpu/ops/pallas/conv_bn_fused.py`` (``bn_relu_conv1x1_stats``).
On rows flattened to (M, Cin) it computes ``y = relu(x * scale + offset) @ W``
and the per-channel (Σy, Σy²) over all M rows, which a train-mode BatchNorm
after it would take as its batch statistics.  The ResNeXt-50 identity tower
runs its bottleneck's bn2 -> ReLU -> conv3 link through it (``scale`` and
``offset`` fold bn2's running statistics; the eval form).

On the card it is a persistent Hopper GEMM: TMA loads x and W into a ring of
shared-memory stages, the BN apply and ReLU run on the x fragment in
registers, and ``wgmma`` multiplies (bf16 directly; f32 as 3xTF32 on the
split :func:`split_tf32`, so the result keeps f32 accuracy).  The tile plan
(:func:`plan_tiles`) is chosen here, in Python, so the CPU tests reach it.

A CPU tensor goes to :func:`bn_relu_conv1x1_stats_reference`; a CUDA tensor
launches the kernel or raises.  Gradients flow through a
``torch.autograd.Function`` (meta-train runs ResNeXt-50's train form through
it, where bn3 takes its batch statistics from the returned (Σy, Σy²)): its
forward is that kernel or that plain version, its backward plain PyTorch on
either device (the JAX package differentiates the link through XLA, outside
any Pallas kernel).  ``bn_relu_conv1x1_stats.launches`` counts the forward
calls that launched the kernel (two CUDA launches each: the product, then
the in-order sum of the statistics' row-tile partials).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

BLOCK_M = 128            # csrc/conv_bn_fused.cu kBM: rows of y per tile
BLOCK_N = {2: 256, 4: 128}   # Traits::kBN by itemsize: columns of y per tile
STAGE_COLS = 128         # kStageCols: columns of y staged at a time
SLICE_BYTES = 128        # kSliceBytes: Cin bytes a stage (the swizzle span)
MAX_STAGES = 6
SMEM_LIMIT = 232448      # shared memory a block may opt into on sm_90
TF32_MASK = -(1 << 13)   # keeps sign, exponent and 10 mantissa bits
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LIBRARY = ("conv_bn_fused", ("conv_bn_fused.cu",))   # name, sources under csrc/


class TilePlan(NamedTuple):
    """One launch of the kernel: row_tiles x col_tiles tiles of y, each
    BLOCK_M x block_n, walked by a persistent grid (one block an SM);
    block_k channels a stage, ``stages`` of them in the ring; ``smem`` bytes
    of dynamic shared memory."""
    block_n: int
    block_k: int
    stages: int
    row_tiles: int
    col_tiles: int
    smem: int
    row_bytes: int       # the row stride of both TMA maps (x and W)


def staging_bytes(itemsize: int) -> int:
    """The epilogue's staged y, STAGE_COLS columns of a tile's rows, padded
    by 16 bytes a row."""
    return BLOCK_M * (STAGE_COLS * itemsize + 16)


def plan_tiles(m: int, cin: int, cout: int, itemsize: int) -> TilePlan:
    """The tile plan for (M, Cin) @ (Cin, Cout) in one dtype.  A stage holds
    the x slice (128 rows x 128 bytes), one (bf16) or two (f32: w_big,
    w_small) W slices (block_n rows x 128 bytes), the stage's slices of
    scale and offset and two mbarriers; beside the ring sit the staged y and
    the per-warp column sums; the ring takes as many stages as the block's
    shared memory allows."""
    w_tiles = 2 if itemsize == 4 else 1
    block_n = BLOCK_N[itemsize]
    stage = (BLOCK_M + w_tiles * block_n) * SLICE_BYTES + 16 \
        + 2 * 4 * SLICE_BYTES // itemsize
    # alignment slack, staged y, per-warp column sums
    fixed = 1024 + staging_bytes(itemsize) + 8 * 2 * block_n * 4
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // stage)
    return TilePlan(block_n, SLICE_BYTES // itemsize, stages,
                    -(-m // BLOCK_M), -(-cout // block_n),
                    fixed + stages * stage, cin * itemsize)


def split_tf32(w):
    """(w_big, w_small) for f32 ``w``: w_big keeps w's top 10 mantissa bits
    (TF32, truncated), w_small the same of the remainder; w_big + w_small is
    w to about 2^-21 relative."""
    big = (w.view(torch.int32) & TF32_MASK).view(torch.float32)
    small = ((w - big).view(torch.int32) & TF32_MASK).view(torch.float32)
    return big, small


def fold_bn(mean, var, gamma, beta, eps: float = 1e-5):
    """BN(x) = x * scale + offset, with scale and offset per channel."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


def _acc(dtype):
    """The arithmetic's dtype: f32, or f64 for f64 inputs (the CPU's
    gradient check calls :class:`_Link` directly in f64)."""
    return torch.promote_types(dtype, torch.float32)


def bn_relu_conv1x1_stats_reference(x, scale, offset, w, relu: bool = True):
    """Plain version: the BN apply and ReLU in f32, rounded to W's dtype
    before the product (as the TPU kernel rounds), the product and the
    statistics in f32, y cast to x's dtype."""
    cin, acc = x.shape[-1], _acc(x.dtype)
    h = x.reshape(-1, cin).to(acc) * scale.to(acc) + offset.to(acc)
    if relu:
        h = torch.relu(h)
    y32 = torch.matmul(h.to(w.dtype).to(acc), w.to(acc))
    stats = torch.stack([y32.sum(0), y32.square().sum(0)])
    return y32.to(x.dtype).reshape(*x.shape[:-1], w.shape[-1]), stats


def _check(x, scale, offset, w):
    if x.dtype not in _DTYPES:
        raise TypeError(f"bn_relu_conv1x1_stats: x must be float32 or "
                        f"bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("bn_relu_conv1x1_stats: x must be contiguous (..., "
                         "Cin): an NCHW tensor in channels_last, permuted")
    cin = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != cin:
        raise ValueError(f"bn_relu_conv1x1_stats: w must be (Cin, Cout) with "
                         f"Cin={cin}, got {tuple(w.shape)}")
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError(f"bn_relu_conv1x1_stats: w must match x's dtype and "
                        f"device, got {w.dtype} on {w.device}")
    for name, t in (("scale", scale), ("offset", offset)):
        if tuple(t.shape) != (cin,) or t.dtype != torch.float32 \
                or t.device != x.device:
            raise ValueError(f"bn_relu_conv1x1_stats: {name} must be ({cin},) "
                             f"float32 on {x.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")


def check_kernel_layout(x, w):
    """What the kernel adds to :func:`_check`: Cin and Cout in whole 16-byte
    vectors (the TMA maps' row strides) and aligned x and w."""
    cin, cout = w.shape
    vec = 16 // x.element_size()
    if cin % vec or cout % vec:
        raise ValueError(f"bn_relu_conv1x1_stats: Cin={cin} and Cout={cout} "
                         f"must be multiples of {vec} for {x.dtype} on the "
                         f"card")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("bn_relu_conv1x1_stats: x and w must be 16-byte "
                         "aligned")


@functools.lru_cache(maxsize=None)
def kernel_entry():
    """Build (at first use) and bind the kernel's C entry point."""
    from latentpose_tpu_torch.ops.cuda_build import load_library
    fn = load_library(*LIBRARY).bn_relu_conv1x1_stats_forward
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_longlong, i, i, i, i, i,
                   i, p]
    fn.restype = ctypes.c_int
    return fn


def _forward(x, scale, offset, w, relu):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return bn_relu_conv1x1_stats_reference(x, scale, offset, w, relu)
    if x.device.type != "cuda":
        raise ValueError(f"bn_relu_conv1x1_stats: unsupported device "
                         f"{x.device}")
    check_kernel_layout(x, w)
    cin, cout = w.shape
    m = x.numel() // cin
    plan = plan_tiles(m, cin, cout, x.element_size())
    w_rows = w.t().contiguous()          # (Cout, Cin): a view for conv3's weight
    w_small = w_rows
    if x.dtype == torch.float32:
        w_rows, w_small = split_tf32(w_rows)
    # bulk copies read scale and offset in 16-byte pieces
    scale, offset = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                     else t.clone(memory_format=torch.contiguous_format)
                     for t in (scale, offset))
    fn = kernel_entry()
    y = torch.empty((*x.shape[:-1], cout), dtype=x.dtype, device=x.device)
    partial = torch.empty((plan.row_tiles, 2, cout), dtype=torch.float32,
                          device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):   # the launch goes to the current device
        err = fn(x.data_ptr(), scale.data_ptr(), offset.data_ptr(),
                 w_rows.data_ptr(), w_small.data_ptr(), y.data_ptr(),
                 partial.data_ptr(), stats.data_ptr(), m, cin, cout,
                 plan.stages, plan.smem, _DTYPES[x.dtype], int(relu),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"bn_relu_conv1x1_stats_forward failed: "
                           f"cudaError_t {err}")
    bn_relu_conv1x1_stats.launches += 1
    return y, stats


class _Link(torch.autograd.Function):
    """(x, scale, offset, w) -> (y, stats) with a plain backward:

        g = dy + dΣy + 2·y·dΣy²     (the stats' gradient folded into y's)
        h = relu(x·scale + offset), rounded to w's dtype as the forward does
        dW = hᵀ·g,  dh = g·Wᵀ,  mask = x·scale + offset > 0
        dx = dh·mask·scale,  dscale = Σ dh·mask·x,  doffset = Σ dh·mask

    in f32 (f64 for f64 inputs).  dW is returned for the (Cin, Cout) view
    the forward took, so it reaches conv3's weight through the view, never
    the TF32 split the kernel multiplies."""

    @staticmethod
    def forward(ctx, x, scale, offset, w, relu):
        y, stats = _forward(x, scale, offset, w, relu)
        ctx.save_for_backward(x, scale, offset, w, y)
        ctx.relu = relu
        return y, stats

    @staticmethod
    def backward(ctx, dy, dstats):
        x, scale, offset, w, y = ctx.saved_tensors
        cin, cout = w.shape
        acc = _acc(x.dtype)
        y2 = y.reshape(-1, cout).to(acc)
        g = torch.zeros_like(y2) if dy is None \
            else dy.reshape(-1, cout).to(acc)
        if dstats is not None:
            ds = dstats.to(acc)
            g = g + ds[0] + 2.0 * y2 * ds[1]
        x2 = x.reshape(-1, cin).to(acc)
        pre = x2 * scale.to(acc) + offset.to(acc)
        h = torch.relu(pre) if ctx.relu else pre
        need_x, need_scale, need_offset, need_w = ctx.needs_input_grad[:4]
        dx = dscale = doffset = dw = None
        if need_w:
            dw = torch.matmul(h.to(w.dtype).to(acc).t(), g).to(w.dtype)
        if need_x or need_scale or need_offset:
            dh = torch.matmul(g, w.to(acc).t())
            if ctx.relu:
                dh = dh * (pre > 0)
            if need_x:
                dx = (dh * scale.to(acc)).to(x.dtype).reshape(x.shape)
            if need_scale:
                dscale = (dh * x2).sum(0).to(scale.dtype)
            if need_offset:
                doffset = dh.sum(0).to(offset.dtype)
        return dx, dscale, doffset, dw, None


def bn_relu_conv1x1_stats(x, scale, offset, w, relu: bool = True):
    """``(relu(x * scale + offset) @ w, (Σy, Σy²))`` for x (..., Cin)
    contiguous, scale and offset (Cin,) f32, w (Cin, Cout) in x's dtype
    (conv3's weight viewed as (Cout, Cin), transposed, is taken without a
    copy).  Returns y (..., Cout) in x's dtype and stats (2, Cout) f32;
    both carry gradients to all four inputs."""
    _check(x, scale, offset, w)
    return _Link.apply(x, scale, offset, w, relu)


bn_relu_conv1x1_stats.launches = 0
