"""The converted weights of the frozen dependencies, overlaid on a fresh
init (port of ``overlay_pretrained`` and ``_merge_overlay`` of
``latentpose_tpu/runners/build.py``).

A model declares ``PRETRAINED = ((target subtree, npz file, source subtree
in the file), ...)``: the X2Face generator the whole ``x2face.npz``, the
X2Face-pretrained embedder its ``driving_net`` as ``pose_unet``, the
FAbNet-pretrained embedder ``fabnet.npz`` as ``pose_encoder`` (WEIGHTS.md).
Files are found by ``utils/weights.py`` and skipped when absent (the
wrappers warn).  The overlay works on the module's state in the JAX
layout (``convert.py``), so a leaf of the file replaces the same-path leaf
of the JAX tree: an unknown key or a wrong shape is a conversion bug and
raises, as in the JAX package.  Parameters are overlaid on every
component, BatchNorm statistics on the embedder only (the JAX state keeps
``batch_stats`` for the embedder alone).  A resumed or loaded checkpoint
replaces every leaf, so only a fresh init reads the files.
"""

from __future__ import annotations

import numpy as np

from latentpose_tpu_torch import convert
from latentpose_tpu_torch.checkpoint import SEP
from latentpose_tpu_torch.utils.weights import (find_weights_file,
                                                load_flat_npz_variables)

# the collections overlaid on each component, as the JAX state holds them
_COLLECTIONS = {"params": ("embedder", "generator", "discriminator"),
                "batch_stats": ("embedder",)}


def merge_overlay(existing, src, label):
    """``existing`` (nested dicts of arrays) with its same-path leaves
    replaced by those of ``src``, cast to their dtype; an unknown key or a
    shape mismatch raises."""
    if not isinstance(existing, dict):
        src = np.asarray(src)
        if src.shape != existing.shape:
            raise ValueError(f"pretrained overlay {label}: shape {src.shape} "
                             f"!= model {existing.shape}")
        return src.astype(existing.dtype)
    out = dict(existing)
    for key, value in src.items():
        if key not in existing:
            raise ValueError(f"pretrained overlay {label}: unknown key "
                             f"{key!r} (model has {sorted(existing)})")
        out[key] = merge_overlay(existing[key], value, f"{label}/{key}")
    return out


def _nested(flat, prefix):
    tree = {}
    for key, value in flat.items():
        if key.startswith(prefix):
            *parts, leaf = key[len(prefix):].split(SEP)
            node = tree
            for part in parts:
                node = node.setdefault(part, {})
            node[leaf] = value
    return tree


def _flat(tree, prefix):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}{SEP}"))
        else:
            out[prefix + key] = value
    return out


def overlay_pretrained(models, weights_dir=None):
    """Load the converted weights that ``models`` ({component: module})
    declare into them, in place."""
    for component, model in models.items():
        for target, filename, source in getattr(model, "PRETRAINED", ()):
            path = find_weights_file(filename, weights_dir)
            if path is None:
                continue
            variables = load_flat_npz_variables(str(path))
            flat = convert.export(model, component, params=("params",))
            for coll, components in _COLLECTIONS.items():
                src = variables.get(coll, {})
                for part in (p for p in source.split("/") if p):
                    src = src.get(part, {})
                if not src or component not in components:
                    continue
                prefix = f"{coll}{SEP}{component}{SEP}"
                tree = _nested(flat, prefix)
                label = f"{component}:{filename}"
                parts = [p for p in target.split("/") if p]
                if parts:
                    node = tree
                    for part in parts[:-1]:
                        node = node[part]
                    node[parts[-1]] = merge_overlay(node[parts[-1]], src,
                                                    label)
                else:
                    tree = merge_overlay(tree, src, label)
                flat.update(_flat(tree, prefix))
            convert.load_into(model, flat, component)
