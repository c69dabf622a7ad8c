"""Fused BN-apply -> ReLU -> 1x1 conv -> BN statistics: the wrapper of the CUDA
kernel, its plain version, and ``fold_bn``.

The kernel (``csrc/conv_bn_fused.cu``) replaces the TPU kernel
``latentpose_tpu/ops/pallas/conv_bn_fused.py`` (``bn_relu_conv1x1_stats``).
On rows flattened to (M, Cin) it computes ``y = relu(x * scale + offset) @ W``
and the per-channel (Σy, Σy²) over all M rows, which a train-mode BatchNorm
after it would take as its batch statistics.  The ResNeXt-50 identity tower
runs its bottleneck's bn2 -> ReLU -> conv3 link through it (``scale`` and
``offset`` fold bn2's running statistics; the eval form).

A CPU tensor goes to :func:`bn_relu_conv1x1_stats_reference`; a CUDA tensor
launches the kernel or raises.  The kernel has no backward yet, so the
wrapper refuses inputs that would need a gradient through it.
``bn_relu_conv1x1_stats.launches`` counts the calls that launched the kernel
(two CUDA launches each).
"""

from __future__ import annotations

import ctypes
import functools

import torch

BLOCK_M = 128            # csrc/conv_bn_fused.cu kBM: rows of y per block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LIBRARY = ("conv_bn_fused", ("conv_bn_fused.cu",))   # name, sources under csrc/


def fold_bn(mean, var, gamma, beta, eps: float = 1e-5):
    """BN(x) = x * scale + offset, with scale and offset per channel."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


def bn_relu_conv1x1_stats_reference(x, scale, offset, w, relu: bool = True):
    """Plain version: the BN apply and ReLU in f32, rounded to W's dtype
    before the product (as the TPU kernel rounds), the product and the
    statistics in f32, y cast to x's dtype."""
    cin = x.shape[-1]
    h = x.reshape(-1, cin).float() * scale.float() + offset.float()
    if relu:
        h = torch.relu(h)
    y32 = torch.matmul(h.to(w.dtype).float(), w.float())
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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, offset, w)):
        raise RuntimeError(
            "bn_relu_conv1x1_stats has no backward yet (it comes with the "
            "meta-train slice, ROADMAP.md A.11): call it under "
            "torch.no_grad() or on tensors that do not require grad")


def check_kernel_layout(x, w):
    """What the kernel adds to :func:`_check`: Cin and Cout in whole 16-byte
    vectors and an aligned x."""
    cin, cout = w.shape
    vec = 16 // x.element_size()
    if cin % vec or cout % vec:
        raise ValueError(f"bn_relu_conv1x1_stats: Cin={cin} and Cout={cout} "
                         f"must be multiples of {vec} for {x.dtype} on the "
                         f"card")
    if x.data_ptr() % 16:
        raise ValueError("bn_relu_conv1x1_stats: x must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def kernel_entry():
    """Build (at first use) and bind the kernel's C entry point."""
    from latentpose_tpu_torch.ops.cuda_build import load_library
    fn = load_library(*LIBRARY).bn_relu_conv1x1_stats_forward
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, ctypes.c_longlong, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def bn_relu_conv1x1_stats(x, scale, offset, w, relu: bool = True):
    """``(relu(x * scale + offset) @ w, (Σy, Σy²))`` for x (..., Cin)
    contiguous, scale and offset (Cin,) f32, w (Cin, Cout) in x's dtype
    (conv3's weight viewed as (Cout, Cin), transposed, is taken without a
    copy).  Returns y (..., Cout) in x's dtype and stats (2, Cout) f32."""
    _check(x, scale, offset, w)
    if x.device.type == "cpu":
        return bn_relu_conv1x1_stats_reference(x, scale, offset, w, relu)
    if x.device.type != "cuda":
        raise ValueError(f"bn_relu_conv1x1_stats: unsupported device "
                         f"{x.device}")
    check_kernel_layout(x, w)
    cin, cout = w.shape
    m = x.numel() // cin
    w_rows = w.t().contiguous()          # (Cout, Cin): a view for conv3's weight
    scale, offset = scale.contiguous(), offset.contiguous()
    fn = kernel_entry()
    y = torch.empty((*x.shape[:-1], cout), dtype=x.dtype, device=x.device)
    partial = torch.empty((-(-m // BLOCK_M), 2, cout), dtype=torch.float32,
                          device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):   # the launch goes to the current device
        err = fn(x.data_ptr(), scale.data_ptr(), offset.data_ptr(),
                 w_rows.data_ptr(), y.data_ptr(), partial.data_ptr(),
                 stats.data_ptr(), m, cin, cout, _DTYPES[x.dtype], int(relu),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"bn_relu_conv1x1_stats_forward failed: "
                           f"cudaError_t {err}")
    bn_relu_conv1x1_stats.launches += 1
    return y, stats


bn_relu_conv1x1_stats.launches = 0
