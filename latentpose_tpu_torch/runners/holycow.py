"""The train step of both regimes: the embedder (meta-train) or the
per-avatar embedding (fine-tune), G forward, D's embedding lookup and three
passes, the criteria, both optimizer updates and the EMA (port of
``latentpose_tpu/runners/holycow.py``).

The JAX step takes one ``value_and_grad`` of ``loss_G + loss_D`` with
stop-gradients that reproduce the reference's two backwards.  Here the two
backwards are taken as the reference takes them: ``loss_G``'s gradient
w.r.t. the generator side only (the generator, plus the embedder in
meta-train or the identity embedding in fine-tune), ``loss_D``'s w.r.t. the
discriminator only.  Pass 2 sees the fake detached and the rows detached,
pass 3 the live rows.  Every spectral-norm state advances in the reference's
order: the generator's once, the embedding's once (lookup), the trunk's
three times; and the embedder's BatchNorm statistics once per forward.

The step first divides the images of a uint8 batch (``--transfer_dtype
uint8``, the wire) by 255 on the device; then it augments the batch
(``--use_pixelwise_augs``, ``--use_affine_scale``, ``--use_affine_shift``)
with the draw of its step; ``--grad_accum_steps`` k splits it into k
microbatches, each with its own forward and both backwards, and takes one
optimizer update on the mean of their gradients.

``--compute_dtype bfloat16`` casts where the JAX package casts, and nowhere
else (no autocast, no loss scaling: bf16 has f32's exponent range).  The
dtype map of a bf16 step, which ``tests/test_torch_bf16.py`` holds against
the JAX package module by module:

- parameters, optimizer moments, the EMA, spectral-norm (u, v) and σ,
  BatchNorm running statistics: f32; every gradient reaches its parameter
  in f32 (through the ``.to(bf16)`` of the weight in each layer);
- the batch (uint8 or f32) -> f32 on the device -> augmentation in f32;
- ``enc_rgbs`` and ``pose_input_rgbs`` -> bf16 before the embedder; both
  towers (every conv, BatchNorm, the conv_bn link, dense) return bf16:
  ``embeds``, ``embeds_elemwise``, ``pose_embedding``; BatchNorm and the
  link take their statistics in f32;
- the generator follows the pose embedding: bf16 activations, AdaIN's
  statistics and affine in f32 inside the kernel, output bf16 (the
  projector runs in f32 in fine-tune, where the identity embedding is an
  f32 leaf); ``fake_rgbs`` and ``fake_segm`` -> f32 for the losses;
- the discriminator's fake (the generator's bf16 output) and real inputs
  in bf16; its scores and features -> f32; the projection rows stay f32;
- the VGG towers in bf16 on normalised inputs cast to bf16, each feature
  difference taken in bf16 and averaged in f32; every other loss in f32.

Not ported yet (refused by the CLI): multi-device reduction.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from latentpose_tpu_torch.data import augmentation
from latentpose_tpu_torch.runners.optim import ema_update
from latentpose_tpu_torch.runners.state import (TrainState, d_trainable,
                                                ema_pairs, g_trainable)

EMA_ALPHA = {True: 0.972, False: 0.999}      # fine-tune, meta-train
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the batch keys the step reads (fine-tune reads enc_rgbs only for ê)
STEP_KEYS = ("pose_input_rgbs", "target_rgbs", "real_segm", "label")
META_STEP_KEYS = ("enc_rgbs",) + STEP_KEYS


def compute_dtype(args):
    """torch's dtype of ``args.compute_dtype``."""
    return DTYPES[args.compute_dtype]


def to_device(batch, device, keys=STEP_KEYS):
    """The step's inputs from a (data_dict, target_dict) host batch, images
    as they come (f32, or uint8 on the wire: the step divides on the
    device), labels as int64; ``keys``: :data:`META_STEP_KEYS` for
    meta-train."""
    merged = {**batch[0], **batch[1]}
    out = {key: torch.as_tensor(merged[key]).to(device) for key in keys}
    out["label"] = out["label"].long()
    return out


def dequantize(batch):
    """The wire's device side: every uint8 tensor as f32 / 255 (true
    division, as the JAX package's ``dequantize_batch`` and the host's
    :func:`runners.loop.dequantize_batch_host` divide)."""
    return {k: v.float() / 255.0 if v.dtype == torch.uint8 else v
            for k, v in batch.items()}


def apply_criteria(criteria, data_dict):
    """(losses_G, losses_D) dicts from every criterion, in order."""
    losses_G: Dict[str, Any] = {}
    losses_D: Dict[str, Any] = {}
    for criterion in criteria:
        out = criterion(data_dict)
        if isinstance(out, tuple):
            losses_G.update(out[0])
            losses_D.update(out[1])
        else:
            losses_G.update(out)
    return losses_G, losses_D


def forward(state: TrainState, batch, train: bool, dropout_generator=None,
            dtype=torch.float32):
    """The populated data_dict of one step (reference key names); ``dtype``:
    the compute dtype (the module docstring's dtype map)."""
    embedder = state.models["embedder"]
    generator = state.models["generator"]
    dis = state.models["discriminator"]
    data_dict = dict(batch)
    pose_input = batch["pose_input_rgbs"].to(dtype)
    if state.finetune:
        # the embedder is frozen: no gradient reaches it, but train-mode BN
        # still updates its running statistics
        with torch.no_grad():
            pose = embedder.get_pose_embedding(pose_input, train,
                                               dropout_generator)
        embeds = state.finetune_embedding.expand(pose.shape[0], -1)
        elemwise = None
    else:
        embeds, elemwise, pose = embedder(
            batch["enc_rgbs"].to(dtype), pose_input, train,
            dropout_generator)
    fake, fake_segm = generator(embeds, pose, update_stats=True)
    data_dict.update(embeds=embeds, embeds_elemwise=elemwise,
                     pose_embedding=pose, fake_rgbs=fake.float(),
                     fake_segm=fake_segm.float())

    target = batch["target_rgbs"]
    target = target[:, 0] if target.dim() > 4 else target
    rows = dis.embed_labels(batch["label"], update_stats=True)
    # pass 1: fake through the G graph (only loss_G's G-side gradient is
    # taken from it); pass 2: fake detached, rows detached; pass 3: real
    fake_score_G, fake_features = dis.pass_inputs(
        fake.to(dtype), rows.detach(), update_stats=True)
    fake_score_D, _ = dis.pass_inputs(fake.detach().to(dtype), rows.detach(),
                                      update_stats=True)
    real_score, real_features = dis.pass_inputs(target.to(dtype), rows,
                                                update_stats=True)
    data_dict.update(
        fake_features=[f.float() for f in fake_features],
        real_features=[f.float() for f in real_features],
        real_embedding=rows, fake_score_G=fake_score_G.float(),
        fake_score_D=fake_score_D.float(), real_score=real_score.float())
    return data_dict


def _microbatches(batch, k: int):
    if k == 1:
        return [batch]
    bsz = batch["label"].shape[0]
    if bsz % k:
        raise ValueError(f"--grad_accum_steps {k} must divide the batch "
                         f"size {bsz}")
    return [{key: v.chunk(k)[i] for key, v in batch.items()}
            for i in range(k)]


def _add(total, parts):
    return list(parts) if total is None \
        else [a + b for a, b in zip(total, parts)]


def step_dropout_generator(seed: int, step: int):
    """The CPU generator of the pose encoder's dropout masks in train step
    ``step``: keyed on (seed, step) as the augmentation's draw is, on a key
    of its own, so a resumed run draws the masks an unbroken one draws."""
    # (a CPU generator keeps a seed's low 32 bits)
    return torch.Generator().manual_seed(
        augmentation.step_key(seed, step) ^ 0x9E3779B9)


def make_train_step(criteria, args):
    """``step(state, batch) -> scalars``: one train step on ``batch``
    (device tensors, :func:`to_device`), updating ``state`` in place; the
    regime (meta-train or fine-tune) is the state's.  Augmentation and
    dropout draw from ``args.random_seed`` and the state's step."""
    train = not args.set_eval_mode_in_train
    dtype = compute_dtype(args)
    use_ema = args.weights_running_average
    accum = int(args.grad_accum_steps or 1)
    augments = dict(use_pixelwise=bool(args.use_pixelwise_augs),
                    use_scale=bool(args.use_affine_scale),
                    use_shift=bool(args.use_affine_shift))

    def step(state: TrainState, batch):
        batch = dequantize(batch)
        if any(augments.values()):
            draw = augmentation.step_draw(args.random_seed, state.step,
                                          batch["pose_input_rgbs"].device)
            batch = augmentation.augment_data_dict(batch, draw, **augments)
        masks = step_dropout_generator(args.random_seed, state.step)
        g_params, d_params = g_trainable(state), d_trainable(state)
        grads_g = grads_d = totals = None
        for micro in _microbatches(batch, accum):
            data_dict = forward(state, micro, train, masks, dtype)
            losses_G, losses_D = apply_criteria(criteria, data_dict)
            loss_G = sum(losses_G.values())
            loss_D = sum(losses_D.values())
            # the two graphs share no node that needs a gradient (pass 1
            # reads the rows detached, passes 2-3 the fake detached)
            grads_g = _add(grads_g, torch.autograd.grad(loss_G, g_params))
            grads_d = _add(grads_d, torch.autograd.grad(loss_D, d_params))
            scalars = {f"Loss_{k}": v.detach()
                       for k, v in {**losses_G, **losses_D}.items()}
            scalars["loss_G"] = loss_G.detach()
            scalars["loss_D"] = loss_D.detach()
            totals = scalars if totals is None else {
                k: totals[k] + v for k, v in scalars.items()}
            del data_dict, losses_G, losses_D, loss_G, loss_D
        if accum > 1:
            grads_g = [g / accum for g in grads_g]
            grads_d = [g / accum for g in grads_d]
            totals = {k: v / accum for k, v in totals.items()}
        state.opt_g.step(grads_g)
        state.opt_d.step(grads_d)
        if use_ema:
            ema_update(*ema_pairs(state), EMA_ALPHA[state.finetune])
        state.step += 1
        return totals

    return step
