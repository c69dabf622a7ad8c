"""Converted pretrained-weight discovery (port of
``latentpose_tpu/utils/weights.py``, with the same search order):

1. the explicit directory the caller passed (``--vgg_weights_dir``,
   ``--weights_dir``);
2. ``$LATENTPOSE_WEIGHTS_DIR``;
3. ``<repo>/weights/``.

A component that needs a missing file fails unless its caller opted into the
degraded mode (``--allow_random_vgg``).  See WEIGHTS.md for how the ``.npz``
files are made.

The same file serves both packages: :func:`load_flat_npz_variables` reads it
as the JAX package does, and :func:`state_dict_from_flax` /
:func:`flax_from_state_dict` turn it into a module's ``state_dict`` and back
(the preprocessing nets, whose attribute paths mirror their flax trees).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from latentpose_tpu_torch.utils.npz import read_npz

_REPO_ROOT = Path(__file__).resolve().parents[2]


def find_weights_file(filename: str, explicit_dir=None):
    """The path of a converted weights file, or None if it is absent."""
    candidates = []
    if explicit_dir:
        candidates.append(Path(explicit_dir) / filename)
    env_dir = os.environ.get("LATENTPOSE_WEIGHTS_DIR")
    if env_dir:
        candidates.append(Path(env_dir) / filename)
    candidates.append(_REPO_ROOT / "weights" / filename)
    for cand in candidates:
        if cand.exists():
            return str(cand)
    return None


def missing_weights_error(filename: str, component: str, opt_in_flag: str,
                          explicit_dir=None) -> FileNotFoundError:
    return FileNotFoundError(
        f"{component}: converted weights file {filename!r} not found "
        f"(searched: explicit dir {explicit_dir!r}, $LATENTPOSE_WEIGHTS_DIR, "
        f"{_REPO_ROOT / 'weights'}). This component is NOT paper-parity "
        f"without real weights; see WEIGHTS.md for the acquisition + "
        f"conversion recipe, or pass {opt_in_flag} to knowingly run the "
        f"degraded fallback (tests/synthetic configs only).")


def load_flat_npz_variables(path_or_dict):
    """A flat converted-weights npz (or its dict) -> nested ``variables``
    ({"params": {...}, "batch_stats": {...}}), as the JAX package reads
    it.  Key formats (``tools/convert_torch_weights.py``,
    ``tools/onnx_extract.py``):

    - ``params/a/b/kernel`` / ``batch_stats/a/b/mean``: the collection
      named, any depth;
    - ``a/b/bn1__mean`` / ``...__var``: batch statistics by suffix;
    - ``a/b/kernel``: no collection: ``params``.
    """
    flat = path_or_dict
    if not isinstance(flat, dict):
        flat = read_npz(path_or_dict)
    variables = {}

    def insert(collection, parts, leaf, value):
        node = variables.setdefault(collection, {})
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = value

    for key, value in flat.items():
        if key.endswith("__mean") or key.endswith("__var"):
            path, leaf = key.rsplit("__", 1)
            insert("batch_stats", path.split("/"), leaf, value)
            continue
        parts = key.split("/")
        if parts[0] in ("params", "batch_stats"):
            insert(parts[0], parts[1:-1], parts[-1], value)
        else:
            insert("params", parts[:-1], parts[-1], value)
    return variables


def _flat_variables(variables):
    """Nested ``variables`` -> {"params/a/b/kernel": array, ...}."""
    out = {}

    def walk(prefix, node):
        for key, value in node.items():
            path = f"{prefix}/{key}"
            if isinstance(value, dict):
                walk(path, value)
            else:
                out[path] = np.asarray(value)

    for collection, tree in variables.items():
        walk(collection, tree)
    return out


def _flax_keys(module):
    """{state_dict key: (flax flat key, layout)} of a module whose attribute
    paths mirror a flax tree: Conv2d ``weight`` <-> ``kernel`` (OIHW <->
    HWIO, depthwise (C, 1, k, k) <-> (k, k, 1, C)), Linear ``weight`` <->
    ``kernel`` (out, in) <-> (in, out), BatchNorm ``weight`` / ``bias`` /
    ``running_mean`` / ``running_var`` <-> ``scale`` / ``bias`` /
    ``batch_stats .../mean`` / ``var``; any other parameter keeps its
    name."""
    keys = {}
    for key in module.state_dict():
        name, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        mod = module.get_submodule(name)
        path = name.replace(".", "/")
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            flax = {"weight": "params/{}/scale", "bias": "params/{}/bias",
                    "running_mean": "batch_stats/{}/mean",
                    "running_var": "batch_stats/{}/var"}[leaf]
            keys[key] = (flax.format(path), None)
        elif isinstance(mod, torch.nn.Conv2d) and leaf == "weight":
            keys[key] = (f"params/{path}/kernel", (2, 3, 1, 0))
        elif isinstance(mod, torch.nn.Linear) and leaf == "weight":
            keys[key] = (f"params/{path}/kernel", (1, 0))
        else:
            keys[key] = ("/".join(["params", path, leaf]) if path
                         else f"params/{leaf}", None)
    return keys


def state_dict_from_flax(module, variables):
    """The ``state_dict`` of ``module`` (attribute paths mirroring the flax
    tree) from nested flax ``variables`` (:func:`load_flat_npz_variables`).
    Raises on a missing or unused array, or a shape that does not fit."""
    flat = _flat_variables(variables)
    own = module.state_dict()
    out = {}
    for key, (flax, perm) in _flax_keys(module).items():
        if flax not in flat:
            raise KeyError(f"{type(module).__name__}: weights have no "
                           f"{flax!r} for {key!r}")
        value = flat.pop(flax)
        if perm is not None:
            value = np.transpose(value, np.argsort(perm))
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"{flax}: shape {value.shape} does not fit "
                             f"{key} {tuple(own[key].shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(value, np.float32))
    if flat:
        raise KeyError(f"{type(module).__name__}: weights hold arrays it "
                       f"has no place for: {sorted(flat)[:5]}")
    return out


def flax_from_state_dict(module):
    """The inverse of :func:`state_dict_from_flax`: the flat npz dict
    (``params/...``, ``batch_stats/...``) of ``module``'s weights, in the
    layout the JAX package loads."""
    own = module.state_dict()
    out = {}
    for key, (flax, perm) in _flax_keys(module).items():
        value = own[key].detach().cpu().numpy()
        out[flax] = np.ascontiguousarray(
            value if perm is None else np.transpose(value, perm))
    return out


class _SkipRandomInit(torch.overrides.TorchFunctionMode):
    """A module's constructor with its random initialisers' draws left out:
    an in-place draw leaves the tensor as it was made (uninitialised), a
    random tensor is an uninitialised one; no generator advances."""

    DRAWS = {torch.Tensor.normal_, torch.Tensor.uniform_} | {
        getattr(torch.nn.init, name) for name in (
            "normal_", "uniform_", "kaiming_normal_", "kaiming_uniform_",
            "xavier_normal_", "xavier_uniform_", "trunc_normal_",
            "orthogonal_")}
    FACTORIES = {torch.randn, torch.rand}
    KEEP = ("dtype", "device", "layout", "requires_grad", "pin_memory")

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.DRAWS:
            return args[0] if args else kwargs["tensor"]
        if func in self.FACTORIES:
            return torch.empty(*args, **{k: v for k, v in kwargs.items()
                                         if k in self.KEEP})
        return func(*args, **kwargs)


def empty_module(build, device="cpu"):
    """``build()``'s module made on ``device`` with its random initialisers
    left out, for weights loaded next to overwrite every parameter and
    buffer: the seeded init of a full-width model took seconds a build.
    (A build on the meta device instead sends its ops through PyTorch's
    Python references, which import ``torch._dynamo``: seconds in a fresh
    process.)"""
    with torch.device(device), _SkipRandomInit():
        module = build()
    return module.to(device)    # what a constructor made from host arrays


def load_flax_weights(module, path_or_dict):
    """Load a flat converted-weights npz (the JAX package's file) into
    ``module``; returns the module."""
    # every key but BatchNorm's num_batches_tracked (which eval ignores)
    module.load_state_dict(
        state_dict_from_flax(module, load_flat_npz_variables(path_or_dict)),
        strict=False)
    return module
