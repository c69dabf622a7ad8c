"""JAX train-state arrays <-> the port's module state, by rename and transpose.

The port's modules carry the JAX names (``block0.conv0`` <-> ``block0::conv0``),
so each leaf maps by its module's type:

- conv kernel HWIO <-> OIHW weight (a depthwise (3, 3, 1, C) becomes
  (C, 1, 3, 3) by the same transpose); dense kernel (in, out) <-> Linear
  weight (out, in); the generator's constant (1, S, S, C) <-> (1, C, S, S);
- flax BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` <->
  BatchNorm2d weight, bias and running statistics;
- ``spectral`` ``u``/``v`` <-> the spectral-norm buffers; the spectral-norm
  embedding table ``embedding`` (num, dim) <-> its weight as it is;
- the optimizers' state, optax's ``ScaleByAdamState`` under
  ``opt_state_g::0`` / ``opt_state_d::0`` (``count``, and ``mu`` / ``nu``
  trees shaped as the trainable params) <-> the port's ``count`` and
  per-tensor moments, each moment transposed as its parameter is; the
  ``none`` discriminator's ``set_to_zero`` holds no state and writes no
  key;
- X2Face's avatar, ``params::finetune_identity_images`` (1, N, H, W, 3),
  as it is.

Two readers and one writer: drive reads the EMA weights of a fine-tuned
checkpoint (:func:`load_drive_weights`); training reads a meta-trained or
fine-tuned checkpoint whole (:func:`load_train_state`: to resume it, or to
start fine-tuning); :func:`export_train_state` writes a train state in the
JAX layout.  Keys a reader does not use are skipped by an explicit list, and
any other key is an error.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn as nn

from latentpose_tpu_torch.checkpoint import SEP
from latentpose_tpu_torch.nn.blocks import InstanceNormAffine
from latentpose_tpu_torch.ops.spectral_norm import SNConv, SNDense, SNEmbed
from latentpose_tpu_torch.runners.optim import SetToZero

_CONV = ((3, 2, 0, 1), (2, 3, 1, 0))        # HWIO -> OIHW, and back
_DENSE = ((1, 0), (1, 0))
_CONSTANT = ((0, 3, 1, 2), (0, 2, 3, 1))    # (1, S, S, C) -> (1, C, S, S)
_SAME = (None, None)

# Keys of a fine-tuned train state that the drive slice does not read.
SKIPPED = re.compile(
    r"step"
    r"|opt_state_[gd](::.*)?"                                   # optimizers
    r"|(params|ema_params|spectral)::discriminator::.*")
PARTS = ("embedder", "generator", "discriminator")
# X2Face's avatar: the identity images its "fine-tune" stores
IDENTITY_IMAGES = "finetune_identity_images"
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
    # an int8_static conv's calibrated maxima are no checkpoint leaf (see
    # quant_calib_from_jax)
    missing = [k for k in model.state_dict()
               if k not in covered and not k.endswith("num_batches_tracked")
               and k.rsplit(".", 1)[-1] != "act_absmax"]
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


def _param_layout(model, part: str):
    """(JAX path, to torch, to JAX) of each of ``model.parameters()``, in
    order."""
    rules = {tkey: (leaf, tt, tj) for tkey, coll, leaf, (tt, tj)
             in _rules(model) if coll == "params"}
    return [(_key("", part, rules[name][0]),) + rules[name][1:]
            for name, _ in model.named_parameters()]


def optimizer_layouts(state):
    """{'opt_state_g': layout, 'opt_state_d': layout}: the JAX paths of
    ``g_trainable(state)`` and ``d_trainable(state)``, in their order."""
    models = state.models
    g = _param_layout(models["generator"], "generator")
    g += ([(name,) + _SAME for name in state.finetune_leaves()]
          if state.finetune
          else _param_layout(models["embedder"], "embedder"))
    return {"opt_state_g": g,
            "opt_state_d": _param_layout(models["discriminator"],
                                         "discriminator")}


def _optimizers(state):
    return {"opt_state_g": state.opt_g, "opt_state_d": state.opt_d}


def load_optimizer_states(flat, state) -> set:
    """Load ``count``, ``mu`` and ``nu`` of both optimizers of ``state``;
    returns the keys read.  A checkpoint without optimizer state leaves
    them fresh, as the JAX package's restore does."""
    used = set()
    for prefix, layout in optimizer_layouts(state).items():
        opt = _optimizers(state)[prefix]
        head = SEP.join((prefix, "0"))
        count = SEP.join((head, "count"))
        if count not in flat:
            continue
        opt.count = int(np.asarray(flat[count]))
        used.add(count)
        for (path, to_torch, _), mu, nu in zip(layout, opt.mu, opt.nu):
            for name, moment in (("mu", mu), ("nu", nu)):
                key = SEP.join((head, name, path))
                with torch.no_grad():
                    moment.copy_(_to_torch(flat, key, to_torch, moment.shape))
                used.add(key)
    return used


def export_optimizer_states(state) -> dict:
    """Both optimizers of ``state`` as flat JAX arrays."""
    flat = {}
    for prefix, layout in optimizer_layouts(state).items():
        opt = _optimizers(state)[prefix]
        if isinstance(opt, SetToZero):      # optax's EmptyState: no leaf
            continue
        head = SEP.join((prefix, "0"))
        flat[SEP.join((head, "count"))] = np.asarray(opt.count, np.int32)
        for (path, _, to_jax), mu, nu in zip(layout, opt.mu, opt.nu):
            for name, moment in (("mu", mu), ("nu", nu)):
                arr = moment.detach().cpu().numpy()
                if to_jax is not None:
                    arr = arr.transpose(to_jax)
                flat[SEP.join((head, name, path))] = \
                    np.ascontiguousarray(arr)
    return flat


def load_train_state(flat, state):
    """Load a checkpoint's arrays into ``state`` in place: the three modules
    (params, BatchNorm statistics, spectral state), the EMA weights, the
    per-avatar leaves of a fine-tuned state, both optimizers and the step.
    ``state`` holds the checkpoint's structure (a fine-tuned state: the
    one-row discriminator and its per-avatar leaves, ``finetune_embedding``
    or ``finetune_affine``) on its device, with its optimizers built; any
    key not read is an error."""
    used = {"step"}
    for part in PARTS:
        used |= load_into(state.models[part], flat, part)
    for part in EMA_PARTS:
        ema, keys = read_ema(state.models[part], flat, part)
        device = next(iter(state.models[part].parameters()),
                      torch.empty(0)).device
        state.ema_params[part] = {k: v.to(device) for k, v in ema.items()}
        used |= keys
    images = state.finetune_identity_images
    if images is not None:
        key = _key("params", "", IDENTITY_IMAGES)
        with torch.no_grad():
            images.copy_(_to_torch(flat, key, None, images.shape))
        used.add(key)
    for name, leaf in state.finetune_leaves().items():
        for coll, target in (("params", leaf),
                             ("ema_params", state.ema_params[name])):
            key = _key(coll, "", name)
            with torch.no_grad():
                target.copy_(_to_torch(flat, key, None, target.shape))
            used.add(key)
    used |= load_optimizer_states(flat, state)
    state.step = int(np.asarray(flat.get("step", 0)))
    unknown = sorted(k for k in flat if k not in used)
    if unknown:
        raise ValueError(f"checkpoint keys the train state neither reads "
                         f"nor skips ({len(unknown)}): {unknown[:8]}")


def export_train_state(state) -> dict:
    """A ``runners/state.py`` TrainState as flat JAX arrays: params,
    ema_params, batch_stats, spectral, step and, where the state has
    them, both optimizers."""
    flat = {"step": np.asarray(state.step, np.int32)}
    for part in PARTS:
        flat.update(export(state.models[part], part, params=("params",)))
    for part in EMA_PARTS:
        flat.update(export_ema(state.models[part], part,
                               state.ema_params[part]))
    for name, leaf in state.finetune_leaves().items():
        flat[f"params{SEP}{name}"] = leaf.detach().cpu().numpy()
        flat[f"ema_params{SEP}{name}"] = \
            state.ema_params[name].detach().cpu().numpy()
    if state.finetune_identity_images is not None:
        flat[_key("params", "", IDENTITY_IMAGES)] = \
            state.finetune_identity_images.detach().cpu().numpy()
    if state.opt_g is not None:
        flat.update(export_optimizer_states(state))
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
    return the avatar: the identity embedding (1, E) as a numpy array, or
    for a self-contained generator (X2Face, whose ``INPUT_KEYS`` hold
    ``enc_rgbs``) the identity images (1, N, H, W, 3) its "fine-tune"
    stored.

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
    leaf = IDENTITY_IMAGES if "enc_rgbs" in generator.INPUT_KEYS \
        else "finetune_embedding"
    key = f"ema_params{SEP}{leaf}"
    if key not in flat:
        key = f"params{SEP}{leaf}"
    if key not in flat:
        raise KeyError(f"checkpoint has no {leaf}: drive needs a "
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


def quant_calib_from_jax(collection) -> dict:
    """The JAX package's ``quant_calib`` collection of the generator (what
    its ``calibrate_quant_scales`` returns: nested dicts ``block{i}`` ->
    ``conv0`` | ``conv1`` | ``skip`` -> ``act_absmax``, optionally under a
    ``generator`` key) -> the port's ``{conv name: (C,) tensor}``, as
    ``runners/drive.py`` ``load_quant_calib`` takes it."""
    if set(collection) == {"generator"}:
        collection = collection["generator"]
    out = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, path + [key])
            elif key == "act_absmax":
                out[".".join(path)] = torch.tensor(
                    np.asarray(value, np.float32))
            else:
                raise KeyError(f"quant_calib leaf {SEP.join(path + [key])} "
                               "is not an act_absmax")

    walk(collection, [])
    return out


def quant_calib_to_jax(calib) -> dict:
    """The inverse of :func:`quant_calib_from_jax`: the generator's
    ``quant_calib`` collection as nested dicts of numpy arrays."""
    out = {}
    for name, value in calib.items():
        node = out
        for part in name.split("."):
            node = node.setdefault(part, {})
        node["act_absmax"] = torch.as_tensor(value).detach().cpu().numpy() \
            .astype(np.float32)
    return out
