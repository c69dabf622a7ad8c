"""Compact pix2pix-style UNet of the X2Face family (port of
``latentpose_tpu/nn/unet.py``).

Down path: 4x4 convolutions, stride 2, padding 1, each followed by
LeakyReLU 0.2; up path: nearest 2x upsample, a 3x3 convolution, ReLU, then
the skip of that resolution concatenated after it ([h, skip]); a last
nearest 2x upsample and the 3x3 ``head``.  The convolutions carry the JAX
module's names (``down{i}``, ``up{i}``, ``head``).  Tensors are NCHW; the
module computes in f32 whatever its input's dtype (flax's Conv promotes a
bf16 input against its f32 kernel).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from latentpose_tpu_torch.ops import initializers as tinit
from latentpose_tpu_torch.ops.image import upsample_nearest_2x


def seeded_conv(in_features, features, kernel_size, stride=1, padding=0,
                generator=None):
    """An ``nn.Conv2d`` with a bias, both U(±1/sqrt(fan_in)) drawn from
    ``generator`` (torch's default init, seeded)."""
    conv = nn.Conv2d(in_features, features, kernel_size, stride, padding)
    fan_in = in_features * kernel_size * kernel_size
    with torch.no_grad():
        conv.weight.copy_(tinit.torch_conv_kernel_init(conv.weight.shape,
                                                       generator))
        conv.bias.copy_(tinit.torch_bias_init(fan_in, (features,),
                                              generator))
    return conv


def seeded_linear(in_features, features, generator=None):
    """An ``nn.Linear`` with torch's default init, seeded."""
    linear = nn.Linear(in_features, features)
    with torch.no_grad():
        linear.weight.copy_(tinit.torch_conv_kernel_init(
            (features, in_features), generator))
        linear.bias.copy_(tinit.torch_bias_init(in_features, (features,),
                                                generator))
    return linear


class UNet(nn.Module):
    """Encoder-decoder with skip connections; :meth:`bottleneck` runs the
    down path alone (X2Face's latent pose reads only it)."""

    WIDTHS = (64, 128, 256, 512, 512)

    def __init__(self, out_features, in_features=3, widths=WIDTHS,
                 generator=None):
        super().__init__()
        self.widths = tuple(widths)
        channels = in_features
        for i, width in enumerate(self.widths):
            self.add_module(f"down{i}", seeded_conv(channels, width, 4, 2, 1,
                                                    generator))
            channels = width
        for i, width in enumerate(reversed(self.widths[:-1])):
            self.add_module(f"up{i}", seeded_conv(channels, width, 3, 1, 1,
                                                  generator))
            channels = 2 * width
        self.head = seeded_conv(channels, out_features, 3, 1, 1, generator)

    def _down(self, x):
        skips, h = [], x.float()
        for i in range(len(self.widths)):
            h = F.leaky_relu(getattr(self, f"down{i}")(h), 0.2)
            skips.append(h)
        return skips

    def bottleneck(self, x):
        """(B, C, H, W) -> the down path's last map (B, widths[-1], H/32,
        W/32)."""
        return self._down(x)[-1]

    def forward(self, x, return_bottleneck: bool = False):
        """(B, C, H, W) -> (B, out_features, H, W) f32, and the bottleneck
        with ``return_bottleneck``."""
        skips = self._down(x)
        h = skips[-1]
        for i in range(len(self.widths) - 1):
            h = torch.relu(getattr(self, f"up{i}")(upsample_nearest_2x(h)))
            h = torch.cat([h, skips[len(self.widths) - 2 - i]], dim=1)
        out = self.head(upsample_nearest_2x(h))
        return (out, skips[-1]) if return_bottleneck else out
