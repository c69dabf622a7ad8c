"""VGG16/19 feature towers for the perceptual losses (port of
``latentpose_tpu/nn/vgg.py``): caffe-VGG19 (perceptual) and VGGFace-VGG16
(identity) feature stacks, every MaxPool swapped for AvgPool2d(2), cut after
30 torch layers (conv, ReLU and pool each count one), with the features
taken at every ReLU (13 maps for either net).  Convs are ``conv<i>`` with
bias, 3x3, zero padding 1; NCHW in, a list of NCHW maps out."""

from __future__ import annotations

from typing import List, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from latentpose_tpu_torch.ops import initializers as tinit
from latentpose_tpu_torch.ops.image import avg_pool_2x

VGG19_CFG: Sequence[Union[int, str]] = (
    64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
    512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
VGG16_CFG: Sequence[Union[int, str]] = (
    64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
    512, 512, 512, "M", 512, 512, 512, "M")


class VGGFeatures(nn.Module):
    def __init__(self, cfg=VGG19_CFG, num_layers=30, generator=None):
        super().__init__()
        self.plan = []           # ("conv", idx, relu_after) or ("pool",)
        layer_idx, conv_idx, in_ch = 0, 0, 3
        for item in cfg:
            if layer_idx >= num_layers:
                break
            if item == "M":
                self.plan.append(("pool",))
                layer_idx += 1
                continue
            conv = nn.utils.skip_init(nn.Conv2d, in_ch, int(item), 3,
                                      padding=1)
            with torch.no_grad():
                conv.weight.copy_(tinit.torch_conv_kernel_init(
                    tuple(conv.weight.shape), generator))
                conv.bias.copy_(tinit.torch_bias_init(
                    in_ch * 9, (int(item),), generator))
            self.add_module(f"conv{conv_idx}", conv)
            layer_idx += 1
            relu = layer_idx < num_layers
            layer_idx += int(relu)
            self.plan.append(("conv", conv_idx, relu))
            conv_idx, in_ch = conv_idx + 1, int(item)

    def forward(self, x) -> List[torch.Tensor]:
        feats, h = [], x
        for step in self.plan:
            if step[0] == "pool":
                h = avg_pool_2x(h)
                continue
            conv = getattr(self, f"conv{step[1]}")
            h = F.conv2d(h, conv.weight.to(h.dtype), conv.bias.to(h.dtype),
                         padding=1)
            if step[2]:
                h = torch.relu(h)
                feats.append(h)
        return feats
