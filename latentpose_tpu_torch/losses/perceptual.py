"""VGG19 perceptual loss (port of ``latentpose_tpu/losses/perceptual.py``).

A mean over the batch's samples, each of equal weight: under N ranks on
equal shards the mean of the ranks' values is the global batch's, so this
criterion needs no collective (``losses/dice.py`` is the one that does)."""

from __future__ import annotations

from latentpose_tpu_torch.losses.common.perceptual_loss import PerceptualLoss
from latentpose_tpu_torch.losses.common.util import strip_time


class Wrapper:
    @staticmethod
    def get_net(args, device=None):
        return Criterion(args.perc_weight, args.vgg_weights_dir,
                         allow_random=args.allow_random_vgg, device=device,
                         compute_dtype=args.compute_dtype)


class Criterion:
    def __init__(self, perc_weight, vgg_weights_dir, allow_random=False,
                 device=None, compute_dtype="float32"):
        self.perceptual_crit = PerceptualLoss(
            perc_weight, vgg_weights_dir, net="caffe",
            allow_random=allow_random, device=device,
            compute_dtype=compute_dtype)

    def __call__(self, data_dict):
        fake_rgb = strip_time(data_dict["fake_rgbs"])
        real_rgb = strip_time(data_dict["target_rgbs"])
        return {"VGG": self.perceptual_crit(fake_rgb, real_rgb)}
