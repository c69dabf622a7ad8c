"""Hinge adversarial loss of the flagship, gan_type 'gan' (port of
``latentpose_tpu/losses/adversarial.py``):

  D: relu(1 - real_score).mean() + relu(1 + fake_score_D).mean()
  G: -fake_score_G.mean()

The relativistic variants (rgan, ragan) wait for the ablation families.

A mean over the batch's samples, each of equal weight: under N ranks on
equal shards the mean of the ranks' values is the global batch's, so this
criterion needs no collective (``losses/dice.py`` is the one that does).
"""

from __future__ import annotations

import torch


class Wrapper:
    @staticmethod
    def get_net(args):
        return Criterion(args.gan_type)


class Criterion:
    def __init__(self, gan_type="gan"):
        if gan_type != "gan":
            raise NotImplementedError(
                f"gan_type {gan_type!r} is not ported to PyTorch yet "
                "(ROADMAP.md A.19); the flagship uses 'gan'")

    def __call__(self, data_dict):
        loss_D = (torch.relu(1.0 - data_dict["real_score"]).mean()
                  + torch.relu(1.0 + data_dict["fake_score_D"]).mean())
        loss_G = -data_dict["fake_score_G"].mean()
        return {"adversarial_G": loss_G}, {"adversarial_D": loss_D}
