"""VGGFace identity perceptual loss (port of
``latentpose_tpu/losses/idt_embed.py``): the face box from the driver's
keypoints where the batch has them (the landmark datasets), else the fixed
centre crop of side 1/1.8, cut with a differentiable crop-and-resize
(``ops/resample.py``), then the VGGFace-16 perceptual loss.

A mean over the batch's samples, each of equal weight: under N ranks on
equal shards the mean of the ranks' values is the global batch's.  The
keypoint box's horizontal midpoint is a reference quirk: the min and max
over the whole batch.  Inside ``parallel.global_batch`` (the default
data-parallel regime) they are taken over the global batch (or, with
``--grad_accum_steps``, the global microbatch) with one all-reduce, as the
JAX step takes them; in the explicit regimes over the rank's rows, as the
JAX step's ``shard_map`` does."""

from __future__ import annotations

import torch

from latentpose_tpu_torch.losses.common.perceptual_loss import PerceptualLoss
from latentpose_tpu_torch.losses.common.util import strip_time
from latentpose_tpu_torch.ops.resample import crop_and_resize
from latentpose_tpu_torch.parallel import mesh as parallel


class Wrapper:
    @staticmethod
    def get_net(args, device=None):
        return Criterion(args.idt_embed_weight, args.vgg_weights_dir,
                         allow_random=args.allow_random_vgg, device=device,
                         compute_dtype=args.compute_dtype)


def compute_bboxes_from_keypoints(keypoints):
    """keypoints (B, [1,] 136) -> (B, 4) rows (t, b, l, r) in the
    keypoints' units: the face from the brow line (point 27) to the chin
    (point 8), widened, a square centred at the midpoint of the batch's
    horizontal extent (module docstring)."""
    kp = keypoints.reshape(-1, 68, 2).float()
    x, y = kp[..., 0].T, kp[..., 1].T          # (68, B)
    face_height = y[8] - y[27]
    b = y[8] + face_height * 0.2
    t = y[27] - face_height * 0.47
    low, high = x.min(), x.max()
    if parallel.sync() is not None:
        high, neg_low = parallel.all_reduce_max(torch.stack([high, -low]))
        low = -neg_low
    midpoint_x = (low + high) / 2
    half_height = (b - t) * 0.5
    return torch.stack([t, b, midpoint_x - half_height,
                        midpoint_x + half_height], dim=1)


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
        if data_dict.get("dec_keypoints") is not None:
            # keypoints in [0, 1] -> pixels
            bboxes = compute_bboxes_from_keypoints(
                data_dict["dec_keypoints"]) * torch.tensor(
                [h, h, w, w], dtype=torch.float32, device=fake_rgb.device)
        else:
            crop_factor = 1 / 1.8
            t = h * (1 - crop_factor) / 2
            l = w * (1 - crop_factor) / 2
            row = torch.tensor([t, h - t, l, w - l], dtype=torch.float32,
                               device=fake_rgb.device)
            bboxes = row.expand(fake_rgb.shape[0], 4)
        return {"VGGFace": self.idt_embed_crit(
            crop_and_resize(fake_rgb, bboxes),
            crop_and_resize(real_rgb, bboxes))}
