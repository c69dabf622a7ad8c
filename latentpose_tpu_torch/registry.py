"""Named-module registry (port of ``latentpose_tpu/registry.py``).

Each model family is a module named after its config string, exposing a
``Wrapper`` with ``get_net(args, generator=None)``.  The port holds the
flagship's drive modules; other names are reported as not ported yet.
"""

from __future__ import annotations

import importlib

_KINDS = {
    "embedders": ("latentpose_tpu_torch.models.embedders",
                  ("unsupervised_pose_separate_embResNeXt_segmentation",)),
    "generators": ("latentpose_tpu_torch.models.generators",
                   ("vector_pose_unsupervised_segmentation_noBottleneck",)),
}


def load_wrapper(kind: str, name: str):
    """The ``Wrapper`` class of the plugin module ``<package for kind>.<name>``."""
    if kind not in _KINDS:
        raise ValueError(f"Unknown module kind {kind!r}; the port has "
                         f"{sorted(_KINDS)}")
    package, names = _KINDS[kind]
    if name not in names:
        raise ValueError(f"{kind} {name!r} is not ported to PyTorch yet; "
                         f"the port has {list(names)}")
    return importlib.import_module(f"{package}.{name}").Wrapper
