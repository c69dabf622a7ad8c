"""No-pose embedder (port of
``latentpose_tpu/models/embedders/no_pose_encoder.py``): the FSTH tower on
the RGB frames alone, for the pose-from-landmarks ablation with the
FSTH_plus generator."""

from __future__ import annotations

from latentpose_tpu_torch.models.embedders.FSTH import Embedder as _FSTH


class Wrapper:
    @staticmethod
    def get_net(args, generator=None):
        return Embedder(num_channels=args.num_channels,
                        max_num_channels=args.max_num_channels,
                        embed_channels=args.embed_channels,
                        num_blocks=args.embed_num_blocks,
                        padding=args.embed_padding,
                        average_function=args.average_function,
                        generator=generator)


class Embedder(_FSTH):
    def __init__(self, **kwargs):
        super().__init__(use_stickmen=False, **kwargs)
