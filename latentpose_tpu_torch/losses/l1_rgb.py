"""Plain L1 RGB loss (port of ``latentpose_tpu/losses/l1_rgb.py``):
``l1_weight`` x mean |fake - target|.

A mean over the batch's samples, each of equal weight: under N ranks on
equal shards the mean of the ranks' values is the global batch's, so this
criterion needs no collective."""

from __future__ import annotations

from latentpose_tpu_torch.losses.common.util import strip_time


class Wrapper:
    @staticmethod
    def get_net(args):
        return Criterion(args.l1_weight)


class Criterion:
    def __init__(self, weight):
        self.weight = float(weight)

    def __call__(self, data_dict):
        fake = data_dict["fake_rgbs"]
        real = strip_time(data_dict["target_rgbs"])
        return {"l1_rgb": self.weight * (fake - real).abs().mean()}
