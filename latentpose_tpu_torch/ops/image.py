"""Nearest 2x upsampling, 2x2 average pooling, the polyphase kernel of
the int8 upsample conv and X2Face's bilinear warp (port of
``upsample_nearest_2x``, ``avg_pool_2x``, ``s2d_up_kernel``,
``depth_to_space`` and ``grid_sample_bilinear`` of
``latentpose_tpu/ops/image.py``).

These act on the modules' internal NCHW tensors (``channels_last`` memory
format is kept).  The float path upsamples and then convolves, the same math
as the JAX package's polyphase conv (ROADMAP A.20 weighs porting that
layout).  Only the int8 upsample conv uses :func:`s2d_up_kernel`, because
the JAX package quantizes the polyphase kernel's tap sums, which differ from
the 3x3 kernel's weights after quantization.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_nearest_2x(x):
    """(B, C, H, W) -> (B, C, 2H, 2W), nearest."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def avg_pool_2x(x):
    """AvgPool2d(kernel=2, stride=2)."""
    return F.avg_pool2d(x, 2)


def s2d_up_kernel(kernel):
    """(C', C, 3, 3) kernel -> the (4C', C, 3, 3) polyphase kernel whose
    pad-1 conv at the low resolution gives, for each output parity (py, px),
    nearest-up-2x + conv3x3; output channels ordered (py, px, c').  The tap
    sums are taken in the kernel's dtype, in the JAX package's order."""
    k = kernel.permute(2, 3, 1, 0)                       # HWIO
    c_in, c_out = k.shape[2], k.shape[3]
    r0 = torch.stack([k[0], k[1] + k[2]])                # (2, 3, C, C')
    r1 = torch.stack([k[0] + k[1], k[2]])

    def col_combo(r):
        return (torch.stack([r[:, 0], r[:, 1] + r[:, 2]], dim=1),
                torch.stack([r[:, 0] + r[:, 1], r[:, 2]], dim=1))

    k00, k01 = col_combo(r0)
    k10, k11 = col_combo(r1)
    out = k.new_zeros((3, 3, c_in, 2, 2, c_out))
    out[0:2, 0:2, :, 0, 0] = k00
    out[0:2, 1:3, :, 0, 1] = k01
    out[1:3, 0:2, :, 1, 0] = k10
    out[1:3, 1:3, :, 1, 1] = k11
    return out.reshape(3, 3, c_in, 4 * c_out).permute(3, 2, 0, 1).contiguous()


def depth_to_space(y, c_out: int):
    """(B, (py, px, c_out), H, W) -> (B, c_out, 2H, 2W) interleave, in
    ``channels_last`` memory."""
    b, _, h, w = y.shape
    y = y.reshape(b, 2, 2, c_out, h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(b, c_out, 2 * h, 2 * w).contiguous(
        memory_format=torch.channels_last)


def grid_sample_bilinear(images, grid_x, grid_y):
    """Bilinear sampling with reflection padding, ``align_corners=False``
    (torch's grid_sample convention: -1 is the left / top edge of the
    border pixels).  images (B, C, H, W); grid_x, grid_y (B, Ho, Wo) in
    normalised coordinates -> (B, C, Ho, Wo).  Out-of-range coordinates
    reflect about the image's border (-0.5 and size - 0.5) and are then
    clipped to the pixel centres, as the JAX function folds them."""
    grid = torch.stack([grid_x, grid_y], dim=-1).to(images.dtype)
    return F.grid_sample(images, grid, mode="bilinear",
                         padding_mode="reflection", align_corners=False)
