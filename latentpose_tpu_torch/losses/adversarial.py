"""Hinge adversarial loss, gan_type 'gan', 'rgan' or 'ragan' (port of
``latentpose_tpu/losses/adversarial.py``):

  D: relu(1 - real_pred).mean() + relu(1 + fake_pred_D).mean()
  G ('gan'): -fake_score_G.mean()
  G ('rgan', 'ragan'): relu(1 + real_pred).mean() + relu(1 - fake_pred_G).mean()

with the relativistic transforms: rgan pairs each real score with its
fake's (real - fake, fake - real), ragan with the other side's batch mean.
The G loss reuses ``real_pred`` taken against ``fake_score_D``, a quirk of
the reference that the JAX package keeps; the D-side scores it reads are
detached (the step takes loss_G's gradient on the generator side only).

A mean over the batch's samples, each of equal weight: under N ranks on
equal shards the mean of the ranks' values is the global batch's.  Only
ragan's batch means are not per sample: in the default regime (inside
``parallel.global_batch``) they are the global batch's, summed over the
ranks with their gradient, as the JAX step computes them.
"""

from __future__ import annotations

import torch

from latentpose_tpu_torch.parallel import mesh as parallel

GAN_TYPES = ("gan", "rgan", "ragan")


class Wrapper:
    @staticmethod
    def get_net(args):
        return Criterion(args.gan_type)


def _batch_mean(score):
    """The mean of ``score`` over the (global, in the default regime)
    batch."""
    if parallel.sync() is None:
        return score.mean()
    total = torch.stack([score.sum(), score.new_tensor(score.numel())])
    total = parallel.all_reduce_sum(total)
    return total[0] / total[1]


class Criterion:
    def __init__(self, gan_type="gan"):
        if gan_type not in GAN_TYPES:
            raise ValueError(f"Incorrect gan_type {gan_type!r}")
        self.gan_type = gan_type

    def _preds(self, real_score, fake_score):
        if self.gan_type == "gan":
            return real_score, fake_score
        if self.gan_type == "rgan":
            return real_score - fake_score, fake_score - real_score
        return (real_score - _batch_mean(fake_score),
                fake_score - _batch_mean(real_score))

    def __call__(self, data_dict):
        fake_score_G = data_dict["fake_score_G"]
        fake_score_D = data_dict["fake_score_D"]
        real_score = data_dict["real_score"]
        real_pred, fake_pred_D = self._preds(real_score, fake_score_D)
        loss_D = (torch.relu(1.0 - real_pred).mean()
                  + torch.relu(1.0 + fake_pred_D).mean())
        if self.gan_type == "gan":
            loss_G = -fake_score_G.mean()
        else:
            real_for_G, fake_D_for_G = real_score.detach(), \
                fake_score_D.detach()
            real_pred_g, _ = self._preds(real_for_G, fake_D_for_G)
            _, fake_pred_G = self._preds(real_for_G, fake_score_G)
            loss_G = (torch.relu(1.0 + real_pred_g).mean()
                      + torch.relu(1.0 - fake_pred_G).mean())
        return {"adversarial_G": loss_G}, {"adversarial_D": loss_D}
