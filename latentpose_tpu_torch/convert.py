"""JAX train-state arrays <-> the port's module state, by rename and transpose.

The port's modules carry the JAX names (``block0.conv0`` <-> ``block0::conv0``),
so each leaf maps by its module's type:

- conv kernel HWIO <-> OIHW weight (a depthwise (3, 3, 1, C) becomes
  (C, 1, 3, 3) by the same transpose); dense kernel (in, out) <-> Linear
  weight (out, in); the generator's constant (1, S, S, C) <-> (1, C, S, S);
- flax BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` <->
  BatchNorm2d weight, bias and running statistics;
- ``spectral`` ``u``/``v`` <-> the spectral-norm buffers; the spectral-norm
  embedding table ``embedding`` (num, dim) <-> its weight as it is.

Three readers and one writer: drive reads the EMA weights of a fine-tuned
checkpoint (:func:`load_drive_weights`); fine-tune reads a meta-trained
checkpoint whole (:func:`load_train_state`); :func:`export_train_state`
writes a train state in the JAX layout.  Keys a reader does not use are
skipped by an explicit list, and any other key is an error.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn as nn

from latentpose_tpu_torch.checkpoint import SEP
from latentpose_tpu_torch.nn.blocks import InstanceNormAffine
from latentpose_tpu_torch.ops.spectral_norm import SNConv, SNDense, SNEmbed

_CONV = ((3, 2, 0, 1), (2, 3, 1, 0))        # HWIO -> OIHW, and back
_DENSE = ((1, 0), (1, 0))
_CONSTANT = ((0, 3, 1, 2), (0, 2, 3, 1))    # (1, S, S, C) -> (1, C, S, S)
_SAME = (None, None)

# Keys of a fine-tuned train state that the drive slice does not read.
SKIPPED = re.compile(
    r"step"
    r"|opt_state_[gd](::.*)?"                                   # optimizers
    r"|(params|ema_params|spectral)::discriminator::.*")
# Keys of a meta-trained train state that fine-tuning does not read: the
# optimizers start fresh (their state does not cross yet).
SKIPPED_TRAIN = re.compile(r"opt_state_[gd](::.*)?")
PARTS = ("embedder", "generator", "discriminator")
EMA_PARTS = ("embedder", "generator")


def _rules(model):
    """(torch key, collection, JAX leaf path, transposes) for every entry of
    ``model.state_dict()`` except BatchNorm's ``num_batches_tracked``."""
    rules = []
    for name, mod in model.named_modules():
        t = f"{name}." if name else ""
        j = f"{name.replace('.', SEP)}{SEP}" if name else ""
        if isinstance(mod, (SNConv, nn.Conv2d)):
            rules.append((t + "weight", "params", j + "kernel", _CONV))
        elif isinstance(mod, (SNDense, nn.Linear)):
            rules.append((t + "weight", "params", j + "kernel", _DENSE))
        if isinstance(mod, (SNConv, SNDense, nn.Conv2d, nn.Linear)) \
                and mod.bias is not None:
            rules.append((t + "bias", "params", j + "bias", _SAME))
        if isinstance(mod, SNEmbed):
            rules.append((t + "weight", "params", j + "embedding", _SAME))
        if isinstance(mod, (SNConv, SNDense, SNEmbed)):
            rules += [(t + "u", "spectral", j + "u", _SAME),
                      (t + "v", "spectral", j + "v", _SAME)]
        if isinstance(mod, nn.BatchNorm2d):
            rules += [(t + "weight", "params", j + "scale", _SAME),
                      (t + "bias", "params", j + "bias", _SAME),
                      (t + "running_mean", "batch_stats", j + "mean", _SAME),
                      (t + "running_var", "batch_stats", j + "var", _SAME)]
        if isinstance(mod, InstanceNormAffine):
            rules += [(t + "weight", "params", j + "weight", _SAME),
                      (t + "bias", "params", j + "bias", _SAME)]
        if "constant" in dict(mod.named_parameters(recurse=False)):
            rules.append((t + "constant", "params", j + "constant", _CONSTANT))
    covered = {r[0] for r in rules}
    missing = [k for k in model.state_dict()
               if k not in covered and not k.endswith("num_batches_tracked")]
    if missing:
        raise TypeError(f"no conversion rule for {missing}")
    return rules


def _key(collection, part, leaf):
    return SEP.join(p for p in (collection, part, leaf) if p)


def _to_torch(flat, key, to_torch, shape):
    if key not in flat:
        raise KeyError(f"checkpoint has no {key}")
    arr = np.asarray(flat[key], np.float32)
    if to_torch is not None:
        arr = arr.transpose(to_torch)
    if arr.shape != tuple(shape):
        raise ValueError(f"{key}: shape {arr.shape} does not fit {tuple(shape)}")
    return torch.tensor(arr)   # a copy: npz arrays are read-only


def load_into(model, flat, part: str, params: str = "params") -> set:
    """Load the ``part`` subtree of flat JAX arrays into ``model``, reading
    weights from collection ``params`` ('params' or 'ema_params').  Returns
    the keys it read."""
    state = model.state_dict()
    used = set()
    for tkey, coll, leaf, (to_torch, _) in _rules(model):
        key = _key(params if coll == "params" else coll, part, leaf)
        state[tkey] = _to_torch(flat, key, to_torch, state[tkey].shape)
        used.add(key)
    model.load_state_dict(state, strict=True)
    return used


def read_ema(model, flat, part: str):
    """The ``ema_params`` weights of ``part`` as {parameter name: tensor}
    (CPU f32), and the keys read."""
    shapes = {k: p.shape for k, p in model.named_parameters()}
    ema, used = {}, set()
    for tkey, coll, leaf, (to_torch, _) in _rules(model):
        if coll == "params":
            key = _key("ema_params", part, leaf)
            ema[tkey] = _to_torch(flat, key, to_torch, shapes[tkey])
            used.add(key)
    return ema, used


def export_ema(model, part: str, ema) -> dict:
    """EMA weights ({parameter name: tensor}) of ``model`` as flat JAX arrays
    under ``ema_params::<part>``."""
    flat = {}
    for tkey, coll, leaf, (_, to_jax) in _rules(model):
        if coll == "params":
            arr = ema[tkey].detach().cpu().numpy()
            if to_jax is not None:
                arr = arr.transpose(to_jax)
            flat[_key("ema_params", part, leaf)] = np.ascontiguousarray(arr)
    return flat


def load_train_state(flat, models):
    """Load a meta-trained checkpoint's arrays into ``models`` (embedder,
    generator, discriminator: params, BatchNorm statistics, spectral
    state) and return (ema_params, step), ``ema_params`` as
    ``runners/state.py`` holds them.  The optimizer states are skipped;
    any other key not read is an error."""
    used = {"step"}
    for part in PARTS:
        used |= load_into(models[part], flat, part)
    ema = {}
    for part in EMA_PARTS:
        ema[part], keys = read_ema(models[part], flat, part)
        used |= keys
    unknown = sorted(k for k in flat if k not in used
                     and not SKIPPED_TRAIN.fullmatch(k))
    if unknown:
        raise ValueError(f"checkpoint keys the fine-tune slice neither reads "
                         f"nor skips ({len(unknown)}): {unknown[:8]}")
    return ema, int(np.asarray(flat.get("step", 0)))


def export_train_state(state) -> dict:
    """A ``runners/state.py`` TrainState as flat JAX arrays: params,
    ema_params, batch_stats, spectral and step (no optimizer state)."""
    flat = {"step": np.asarray(state.step, np.int32)}
    for part in PARTS:
        flat.update(export(state.models[part], part, params=("params",)))
    for part in EMA_PARTS:
        flat.update(export_ema(state.models[part], part,
                               state.ema_params[part]))
    if state.finetune:
        flat[f"params{SEP}finetune_embedding"] = \
            state.finetune_embedding.detach().cpu().numpy()
        flat[f"ema_params{SEP}finetune_embedding"] = \
            state.ema_params["finetune_embedding"].detach().cpu().numpy()
    return flat


def export(model, part: str, params=("params", "ema_params")) -> dict:
    """The inverse of :func:`load_into`: ``model``'s state as flat JAX
    arrays under ``part``, weights written to each collection in ``params``."""
    state = model.state_dict()
    flat = {}
    for tkey, coll, leaf, (_, to_jax) in _rules(model):
        arr = state[tkey].detach().cpu().numpy()
        if to_jax is not None:
            arr = arr.transpose(to_jax)
        for c in (params if coll == "params" else (coll,)):
            flat[_key(c, part, leaf)] = np.ascontiguousarray(arr)
    return flat


def load_drive_weights(flat, embedder, generator):
    """Load a fine-tuned checkpoint's drive weights into the two modules and
    return the identity embedding (1, E) as a numpy array.

    EMA copies are read where present (``ema_params`` for embedder, generator
    and ``finetune_embedding``), BatchNorm statistics from ``batch_stats``,
    spectral-norm state from ``spectral``.  The non-EMA copy of what was read
    from EMA and the keys :data:`SKIPPED` lists are skipped; any other key
    raises, so that a checkpoint of another model family is not half-read.
    """
    used = set()
    for part, model in (("embedder", embedder), ("generator", generator)):
        has_ema = any(k.startswith(f"ema_params{SEP}{part}{SEP}") for k in flat)
        used |= load_into(model, flat, part,
                          "ema_params" if has_ema else "params")
    key = f"ema_params{SEP}finetune_embedding"
    if key not in flat:
        key = f"params{SEP}finetune_embedding"
    if key not in flat:
        raise KeyError("checkpoint has no finetune_embedding: drive needs a "
                       "fine-tuned checkpoint")
    used.add(key)
    shadowed = {k for k in flat if k.startswith(f"params{SEP}")
                and "ema_" + k in used}
    unknown = sorted(k for k in flat if k not in used and k not in shadowed
                     and not SKIPPED.fullmatch(k))
    if unknown:
        raise ValueError(f"checkpoint keys the drive slice neither reads nor "
                         f"skips ({len(unknown)}): {unknown[:8]}")
    return np.asarray(flat[key], np.float32)
