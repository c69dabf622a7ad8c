"""Seeded weight initialisers matching PyTorch layer defaults (port of
``latentpose_tpu/ops/initializers.py``).

U(-1/sqrt(fan_in), +1/sqrt(fan_in)) for conv / linear weights and biases.
They draw from an explicit ``torch.Generator`` so that a seed gives the same
random weights on every run; only seeded smoke weights use them, since
served weights come from a checkpoint.
"""

from __future__ import annotations

import math

import torch


def _uniform(shape, bound, generator):
    t = torch.empty(shape, dtype=torch.float32)
    t.uniform_(-bound, bound, generator=generator)
    return t


def torch_conv_kernel_init(shape, generator=None):
    """OIHW conv or (out, in) linear weight; fan_in = in * kh * kw."""
    fan_in = math.prod(shape[1:])
    return _uniform(shape, 1.0 / math.sqrt(fan_in), generator)


def torch_bias_init(fan_in: int, shape, generator=None):
    return _uniform(shape, 1.0 / math.sqrt(fan_in), generator)
