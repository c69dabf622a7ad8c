"""Dice segmentation loss (port of ``latentpose_tpu/losses/dice.py``):
-log(2·Σ(f·r) / (Σf² + Σr²)) · dice_weight, sums over the whole batch."""

from __future__ import annotations

import torch

from latentpose_tpu_torch.losses.common.util import strip_time


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
        return {"segmentation_dice":
                -torch.log(numer / denom) * self.dice_weight}
