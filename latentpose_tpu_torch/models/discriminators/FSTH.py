"""FSTH discriminator (port of
``latentpose_tpu/models/discriminators/FSTH.py``): the flagship projection
discriminator over the driver's stickman and the image, six channels in
the reference's interleaved order [s0, r0, s1, r1, s2, r2] (its
``torch.cat([stickmen, rgbs], dim=2).view(b, -1, h, w)`` concatenates
along the height and views back)."""

from __future__ import annotations

import torch

from latentpose_tpu_torch.models.discriminators import no_landmarks


class Wrapper:
    @staticmethod
    def get_net(args, generator=None):
        return Discriminator(
            padding=args.dis_padding,
            in_channels=args.in_channels + args.out_channels,
            num_channels=args.num_channels,
            max_num_channels=args.max_num_channels,
            embed_channels=args.embed_channels,
            num_blocks=args.dis_num_blocks, image_size=args.image_size,
            num_labels=args.num_labels,
            # the fine-tuned 1-row W takes torch's default eps (1e-12)
            embed_sn_eps=1e-12 if args.finetune else 1e-4,
            generator=generator)


class Discriminator(no_landmarks.Discriminator):
    @staticmethod
    def make_input(batch, rgbs):
        """The scored input (B, H, W, 6) of images ``rgbs`` (B, [T,] H, W,
        3): the driver's stickman and the image, interleaved."""
        rgbs = rgbs if rgbs.dim() == 4 else rgbs[:, 0]
        stickman = batch["dec_stickmen"]
        if stickman.dim() > 4:
            stickman = stickman[:, 0]
        return torch.stack([stickman.to(rgbs.dtype), rgbs], dim=-1).reshape(
            *rgbs.shape[:3], stickman.shape[-1] + rgbs.shape[-1])
