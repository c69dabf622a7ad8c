"""Named-module registry (port of ``latentpose_tpu/registry.py``).

Each model family, criterion, metric and dataloader is a module named after
its config string, exposing a ``Wrapper`` (``get_net(args, generator=None)``,
or ``get_dataloader(args, part, phase)`` for a dataloader).  The port holds
the flagship's modules and the FSTH family's (FSTH embedder, generator and
discriminator, FSTH_plus, the landmark datasets, ``l1_rgb``); other names
are reported as not ported yet.
"""

from __future__ import annotations

import importlib

_KINDS = {
    "embedders": ("latentpose_tpu_torch.models.embedders",
                  ("unsupervised_pose_separate_embResNeXt_segmentation",
                   "FSTH")),
    "generators": ("latentpose_tpu_torch.models.generators",
                   ("vector_pose_unsupervised_segmentation_noBottleneck",
                    "FSTH", "FSTH_plus")),
    "discriminators": ("latentpose_tpu_torch.models.discriminators",
                       ("no_landmarks", "FSTH")),
    "criterions": ("latentpose_tpu_torch.losses",
                   ("adversarial", "featmat", "idt_embed", "perceptual",
                    "dice", "dis_embed", "l1_rgb")),
    "metrics": ("latentpose_tpu_torch.metrics",
                ("psnr", "segmentation_iou")),
    "dataloaders": ("latentpose_tpu_torch.data",
                    ("synthetic", "voxceleb2_segmentation_nolandmarks",
                     "voxceleb2", "voxceleb2_segm",
                     "voxceleb2_FSTH_crop")),
}


def load_wrapper(kind: str, name: str):
    """The ``Wrapper`` class of the plugin module ``<package for kind>.<name>``."""
    if kind not in _KINDS:
        raise ValueError(f"Unknown module kind {kind!r}; the port has "
                         f"{sorted(_KINDS)}")
    package, names = _KINDS[kind]
    if name not in names:
        raise ValueError(f"{kind} {name!r} is not ported to PyTorch yet "
                         f"(ROADMAP.md A.19); the port has {list(names)}")
    return importlib.import_module(f"{package}.{name}").Wrapper


def names(kind: str):
    """The names of ``kind``'s ported plugins."""
    return _KINDS[kind][1]
