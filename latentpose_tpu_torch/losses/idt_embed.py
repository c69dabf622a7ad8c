"""VGGFace identity perceptual loss (port of
``latentpose_tpu/losses/idt_embed.py``): the fixed centre crop of side
1/1.8, cut with a differentiable crop-and-resize (``ops/resample.py``), then
the VGGFace-16 perceptual loss.  The flagship's data has no keypoints, so
the keypoint-derived box of the JAX criterion is not ported.

A mean over the batch's samples, each of equal weight: under N ranks on
equal shards the mean of the ranks' values is the global batch's, so this
criterion needs no collective (``losses/dice.py`` is the one that does)."""

from __future__ import annotations

import torch

from latentpose_tpu_torch.losses.common.perceptual_loss import PerceptualLoss
from latentpose_tpu_torch.losses.common.util import strip_time
from latentpose_tpu_torch.ops.resample import crop_and_resize


class Wrapper:
    @staticmethod
    def get_net(args, device=None):
        return Criterion(args.idt_embed_weight, args.vgg_weights_dir,
                         allow_random=args.allow_random_vgg, device=device,
                         compute_dtype=args.compute_dtype)


class Criterion:
    def __init__(self, idt_embed_weight, vgg_weights_dir, allow_random=False,
                 device=None, compute_dtype="float32"):
        self.idt_embed_crit = PerceptualLoss(
            idt_embed_weight, vgg_weights_dir, net="face",
            allow_random=allow_random, device=device,
            compute_dtype=compute_dtype)

    def __call__(self, data_dict):
        fake_rgb = strip_time(data_dict["fake_rgbs"])
        real_rgb = strip_time(data_dict["target_rgbs"])
        h, w = real_rgb.shape[1:3]
        crop_factor = 1 / 1.8
        t = h * (1 - crop_factor) / 2
        l = w * (1 - crop_factor) / 2
        row = torch.tensor([t, h - t, l, w - l], dtype=torch.float32,
                           device=fake_rgb.device)
        bboxes = row.expand(fake_rgb.shape[0], 4)
        return {"VGGFace": self.idt_embed_crit(
            crop_and_resize(fake_rgb, bboxes),
            crop_and_resize(real_rgb, bboxes))}
