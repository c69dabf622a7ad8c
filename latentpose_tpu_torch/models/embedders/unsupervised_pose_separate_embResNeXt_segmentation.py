"""Flagship embedder: ResNeXt-50 identity encoder and MobileNetV2 latent-pose
encoder (port of
``latentpose_tpu/models/embedders/unsupervised_pose_separate_embResNeXt_segmentation.py``).

- identity: ResNeXt-50 over the K identity frames folded into the batch,
  then the mean ('sum') or max over the frames; eval form for fine-tune's
  ê, train form in meta-train (:class:`ResNeXtIdentity`, which the
  pretrained-pose embedders share);
- pose: MobileNetV2 on driving frame 0, in eval or train form (meta-train
  trains it; the fine-tune step runs it frozen with train-mode BatchNorm).

Inputs are NHWC as in the JAX package; the towers work in NCHW.
"""

from __future__ import annotations

import torch.nn as nn

from latentpose_tpu_torch.nn.backbones import MobileNetV2, ResNeXt50


class Wrapper:
    @staticmethod
    def get_net(args, generator=None):
        return Embedder(identity_embedding_size=args.embed_channels,
                        pose_embedding_size=args.pose_embedding_size,
                        average_function=getattr(args, "average_function",
                                                 "sum"),
                        generator=generator)


class ResNeXtIdentity(nn.Module):
    """The identity half: ResNeXt-50 over the K frames folded into the
    batch, then the mean ('sum') or max; a subclass adds the pose path
    (``get_pose_embedding``, ``pose_module``)."""

    INPUT_KEYS = ("enc_rgbs", "pose_input_rgbs")

    def __init__(self, identity_embedding_size=512, average_function="sum",
                 generator=None):
        super().__init__()
        if average_function not in ("sum", "max"):
            raise ValueError("average_function must be 'sum' or 'max', got "
                             f"{average_function!r}")
        self.identity_embedding_size = identity_embedding_size
        self.average_function = average_function
        self.identity_encoder = ResNeXt50(num_classes=identity_embedding_size,
                                          generator=generator)

    def get_identity_embedding(self, enc_rgbs, train: bool = False):
        """enc_rgbs (B, K, H, W, 3) -> (embeds (B, E), embeds_elemwise
        (B, K, E))."""
        b, k, h, w, c = enc_rgbs.shape
        flat = enc_rgbs.reshape(b * k, h, w, c).permute(0, 3, 1, 2)
        emb = self.identity_encoder(flat, train).reshape(
            b, k, self.identity_embedding_size)
        agg = emb.mean(dim=1) if self.average_function == "sum" \
            else emb.amax(dim=1)
        return agg, emb

    def forward(self, enc_rgbs, pose_input_rgbs=None, train: bool = False,
                dropout_generator=None, compute_identity: bool = True):
        """(embeds, embeds_elemwise, pose embedding or None), as the JAX
        module's ``__call__``: identity first (unless not
        ``compute_identity``), then pose, both in eval or both in train
        form (meta-train); ``torch.func.functional_call`` runs it with
        other weights (the EMA copy)."""
        embeds, elemwise = self.get_identity_embedding(enc_rgbs, train) \
            if compute_identity else (None, None)
        pose = None if pose_input_rgbs is None \
            else self.get_pose_embedding(pose_input_rgbs, train,
                                         dropout_generator)
        return embeds, elemwise, pose


class Embedder(ResNeXtIdentity):
    def __init__(self, identity_embedding_size=512, pose_embedding_size=256,
                 average_function="sum", generator=None):
        super().__init__(identity_embedding_size, average_function,
                         generator)
        self.pose_encoder = MobileNetV2(num_classes=pose_embedding_size,
                                        generator=generator)

    def get_pose_embedding(self, pose_input_rgbs, train: bool = False,
                           dropout_generator=None):
        """pose_input_rgbs (B, T, H, W, 3) -> (B, pose_embedding_size),
        from driver frame 0."""
        return self.pose_encoder(pose_input_rgbs[:, 0].permute(0, 3, 1, 2),
                                 train, dropout_generator)

    def pose_module(self):
        """The pose path as a module of (B, 3, H, W) frames (drive)."""
        return self.pose_encoder
