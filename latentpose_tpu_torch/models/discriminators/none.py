"""No-op discriminator (port of
``latentpose_tpu/models/discriminators/none.py``), for the families that
train without an adversarial loss (X2Face): no parameters, no
spectral-norm state, every score zero and no feature maps.  Its optimizer
is optax's ``set_to_zero`` (``runners/optim.py`` :class:`SetToZero`),
whose state the checkpoint does not hold."""

from __future__ import annotations

import torch
import torch.nn as nn


class Wrapper:
    @staticmethod
    def get_net(args, generator=None):
        return Discriminator()


class Discriminator(nn.Module):
    @staticmethod
    def make_input(batch, rgbs):
        return rgbs if rgbs.dim() == 4 else rgbs[:, 0]

    def embed_labels(self, labels, update_stats: bool = False):
        return None

    def pass_inputs(self, x, embed=None, update_stats: bool = False):
        """(zeros (B,) f32, no features)."""
        return torch.zeros(x.shape[0], device=x.device), []

    def forward(self, x, labels=None, update_stats: bool = False):
        return self.pass_inputs(x)
