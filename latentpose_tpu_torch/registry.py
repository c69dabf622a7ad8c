"""Named-module registry (port of ``latentpose_tpu/registry.py``).

Each model family, criterion, metric and dataloader is a module named after
its config string, exposing a ``Wrapper`` (``get_net(args, generator=None)``,
or ``get_dataloader(args, part, phase)`` for a dataloader).  The port holds
every name of the JAX package's registry: the flagship's modules, the FSTH
family's (FSTH embedder, generator and discriminator, FSTH_plus,
``no_pose_encoder``, the landmark datasets, ``l1_rgb``), the X2Face family
(embedder, generator, the ``none`` discriminator, ``voxceleb2_X2Face``), the
pretrained-pose embedders ``X2Face_pretrained_embResNeXt`` and
``FAbNet_pretrained_embResNeXt`` with their mixed-crop dataset, and
``simple_conv``.
"""

from __future__ import annotations

import importlib

_KINDS = {
    "embedders": ("latentpose_tpu_torch.models.embedders",
                  ("unsupervised_pose_separate_embResNeXt_segmentation",
                   "FSTH", "no_pose_encoder", "simple_conv", "X2Face",
                   "X2Face_pretrained_embResNeXt",
                   "FAbNet_pretrained_embResNeXt")),
    "generators": ("latentpose_tpu_torch.models.generators",
                   ("vector_pose_unsupervised_segmentation_noBottleneck",
                    "FSTH", "FSTH_plus", "X2Face")),
    "discriminators": ("latentpose_tpu_torch.models.discriminators",
                       ("no_landmarks", "FSTH", "none")),
    "criterions": ("latentpose_tpu_torch.losses",
                   ("adversarial", "featmat", "idt_embed", "perceptual",
                    "dice", "dis_embed", "l1_rgb")),
    "metrics": ("latentpose_tpu_torch.metrics",
                ("psnr", "segmentation_iou")),
    "dataloaders": ("latentpose_tpu_torch.data",
                    ("synthetic", "voxceleb2_segmentation_nolandmarks",
                     "voxceleb2", "voxceleb2_segm",
                     "voxceleb2_FSTH_crop", "voxceleb2_X2Face",
                     "voxceleb2_segmentation_nolandmarks_X2Face_FAbNet_crops"
                     )),
}


def load_wrapper(kind: str, name: str):
    """The ``Wrapper`` class of the plugin module ``<package for kind>.<name>``."""
    if kind not in _KINDS:
        raise ValueError(f"Unknown module kind {kind!r}; the port has "
                         f"{sorted(_KINDS)}")
    package, names = _KINDS[kind]
    if name not in names:
        raise ValueError(f"Unknown {kind[:-1]} {name!r}: the registry has "
                         f"{list(names)}")
    return importlib.import_module(f"{package}.{name}").Wrapper


def empty_net(kind: str, name: str, args, device):
    """Plugin ``name``'s network for ``args`` on ``device`` with its
    weights left uninitialised (``utils/weights.py`` ``empty_module``), for
    a checkpoint to overwrite whole: the seeded init of a full-width model
    took seconds a build."""
    from latentpose_tpu_torch.utils.weights import empty_module
    return empty_module(lambda: load_wrapper(kind, name).get_net(args),
                        device)


def names(kind: str):
    """The names of ``kind``'s plugins."""
    return _KINDS[kind][1]
