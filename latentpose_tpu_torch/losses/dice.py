"""Dice segmentation loss (port of ``latentpose_tpu/losses/dice.py``):
-log(2·Σ(f·r) / (Σf² + Σr²)) · dice_weight, sums over the whole batch.

Not a mean of per-sample terms: under N ranks in the default regime
(inside ``parallel.global_batch``) both sums are the global batch's, summed
over the ranks with their gradient, so every rank holds the global dice.
In the explicit regime each rank's dice is its own rows', and the mean of
those is what the JAX step's ``pmean`` reports."""

from __future__ import annotations

import torch

from latentpose_tpu_torch.losses.common.util import strip_time
from latentpose_tpu_torch.parallel import mesh as parallel


class Wrapper:
    @staticmethod
    def get_net(args):
        return Criterion(args.dice_weight)


class Criterion:
    def __init__(self, dice_weight):
        self.dice_weight = float(dice_weight)

    def __call__(self, data_dict):
        fake_segm = strip_time(data_dict["fake_segm"])
        real_segm = strip_time(data_dict["real_segm"])
        numer = (2.0 * fake_segm * real_segm).sum()
        denom = (fake_segm ** 2).sum() + (real_segm ** 2).sum()
        if parallel.sync() is not None:
            numer, denom = parallel.all_reduce_sum(
                torch.stack([numer, denom])).unbind()
        return {"segmentation_dice":
                -torch.log(numer / denom) * self.dice_weight}
