"""Caffe-VGG19 / VGGFace-VGG16 perceptual loss (port of
``latentpose_tpu/losses/common/perceptual_loss.py``):

- the 30-layer tower of ``nn/vgg.py``;
- inputs remapped ``(x + 1) / 2`` then caffe-normalised with the means
  (103.939, 116.779, 123.680)/255 in that order (the reference applies the
  BGR means to RGB tensors; reproduced) and std 1/255;
- loss = weight × Σ over the 13 ReLU maps of mean |f(x) − f(y)|, the target
  detached;
- ``compute_dtype`` 'bfloat16' runs the tower in bf16 on the normalised
  inputs cast to it; each difference f(x) − f(y) is taken in bf16 and its
  mean in f32, as the JAX package computes it.

Weights are the JAX package's converted ``vgg19_caffe.npz`` /
``vgg_face.npz`` (keys ``conv<i>/kernel`` HWIO and ``conv<i>/bias``), found
by ``utils/weights.py`` in the JAX package's order (explicit dir,
``$LATENTPOSE_WEIGHTS_DIR``, ``<repo>/weights/``).  Without them construction fails unless
``allow_random`` (``--allow_random_vgg``), which seeds a torch init (tests
and smoke runs only; :func:`load_tower_arrays` loads other arrays later).
The tower is frozen: its parameters never require grad.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from latentpose_tpu_torch.nn.vgg import VGG16_CFG, VGG19_CFG, VGGFeatures
from latentpose_tpu_torch.utils.weights import (find_weights_file,
                                                missing_weights_error)

logger = logging.getLogger("latentpose_tpu_torch.losses.perceptual")

_CAFFE_MEAN = np.array([103.939, 116.779, 123.680], np.float32) / 255.0
_CAFFE_STD = np.array([1.0, 1.0, 1.0], np.float32) / 255.0
WEIGHT_FILES = {"caffe": "vgg19_caffe.npz", "face": "vgg_face.npz"}
RANDOM_SEED = 0


def load_tower_arrays(tower, params):
    """Load ``conv<i>/kernel`` (HWIO) and ``conv<i>/bias`` arrays into a
    :class:`VGGFeatures`; every conv must be given."""
    state = {}
    for name, _ in tower.named_children():
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(params[f"{name}/kernel"], np.float32)
            .transpose(3, 2, 0, 1)))
        state[f"{name}.bias"] = torch.from_numpy(
            np.asarray(params[f"{name}/bias"], np.float32).copy())
    tower.load_state_dict(state, strict=True)


class PerceptualLoss:
    def __init__(self, weight, vgg_weights_dir=None, net="caffe",
                 allow_random=False, device=None, compute_dtype="float32"):
        self.weight = float(weight)
        self.dtype = getattr(torch, compute_dtype)
        cfg = VGG19_CFG if net == "caffe" else VGG16_CFG
        self.module = VGGFeatures(cfg, num_layers=30, generator=torch.Generator()
                                  .manual_seed(RANDOM_SEED))
        path = find_weights_file(WEIGHT_FILES[net], vgg_weights_dir)
        if path is not None:
            with np.load(path) as raw:
                load_tower_arrays(self.module, raw)
            logger.info("PerceptualLoss(%s): loaded weights from %s", net,
                        path)
        elif not allow_random:
            raise missing_weights_error(
                WEIGHT_FILES[net], f"PerceptualLoss({net})",
                "--allow_random_vgg", vgg_weights_dir)
        else:
            logger.warning(
                "PerceptualLoss(%s): no pretrained weights found under %r; "
                "using a seeded random tower (tests and smoke runs only)",
                net, vgg_weights_dir)
        self.module.requires_grad_(False)
        self.module.to(device or "cpu")
        self.mean = torch.tensor(_CAFFE_MEAN, device=device)
        self.std = torch.tensor(_CAFFE_STD, device=device)

    def _normalize(self, x):
        """(B, H, W, 3) in [0, 1] -> caffe-normalised NCHW."""
        return ((x - self.mean) / self.std).permute(0, 3, 1, 2)

    def __call__(self, input, target):
        """input, target: (B, H, W, 3) in the generator's output range."""
        x = (input + 1.0) / 2.0
        y = (target.detach() + 1.0) / 2.0
        feats_x = self.module(self._normalize(x).to(self.dtype))
        feats_y = self.module(self._normalize(y).to(self.dtype))
        loss = 0.0
        for fx, fy in zip(feats_x, feats_y):
            # the difference in the tower's dtype, its mean in f32
            loss = loss + (fx - fy).abs().float().mean()
        return loss * self.weight
