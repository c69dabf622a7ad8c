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

Each model family names its inputs: the embedder's and the generator's
``INPUT_KEYS`` pick them from the batch and the step's results (the
landmark families read ``enc_stickmen``, ``dec_stickmen`` or
``dec_keypoints``; the X2Face generator the identity frames and the
driver themselves), an FSTH fine-tune feeds the generator its trainable
``finetune_affine``, and the discriminator's ``make_input`` builds what it
scores (the FSTH discriminator interleaves the driver's stickman with the
image).  The ``none`` discriminator (X2Face) scores zeros, has no rows, no
features and no tensor to train; with no D criterion loss_D is 0.  A
generator without segmentation (X2Face) leaves ``fake_segm`` None.  A
frozen pose encoder (``X2Face_pretrained_embResNeXt``,
``FAbNet_pretrained_embResNeXt``) gets zero gradients, which leave Adam's
moments and its weights as they were.

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
- ``enc_rgbs``, ``pose_input_rgbs``, ``enc_stickmen`` and
  ``dec_stickmen`` -> bf16 before the models (``dec_keypoints`` stays f32,
  so FSTH_plus's decoder runs in f32, as in the JAX package); both
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

Under a process group (``--num_devices N``, one rank a device:
``parallel/mesh.py``) the step takes one of the JAX step's three regimes:

- default: the step computes what one process computes on the global
  batch.  Inside :func:`parallel.global_batch` every train-form BatchNorm,
  the conv_bn link's (Σy, Σy²) and dice take their sums over all ranks
  (with their gradient), each rank takes its rows of the global batch's
  augmentation draws and dropout masks, and the gradients' mean over ranks
  goes on the wire in f32.  With ``--grad_accum_steps`` k the rank's rows
  are laid out so that its microbatch i is its part of the global
  microbatch i (:func:`parallel.local_rows`);
- ``--explicit_grad_reduce``: each rank normalises with its own rows'
  statistics and draws its own augmentation and dropout (keyed on seed,
  step and rank, where JAX folds its key with the shard index); after the
  step the running statistics are averaged over ranks; gradients in f32;
- ``--grad_dtype bfloat16``: the explicit regime with the gradient bucket
  in bf16 on the wire.  Microbatch gradients add up in f32 on each rank and
  one reduction follows the last.

In every regime the scalars returned are their mean over ranks (dice is
already global in the default one).  The explicit regimes need a process
group and raise without one, as the JAX step raises without a mesh.

A state sharded by ``--param_sharding fsdp`` (``parallel.shard_state``)
takes the same step in this order: all-gather the parameters
(``parallel.gathered``), the forward and the same two gradients, release
the gathered weights; then, in place of the all-reduce, one
reduce-scatter a group (``parallel.reduce_scatter_grads``, bf16 on the
wire under ``--grad_dtype bfloat16``), each optimizer's update on this
rank's slice and the EMA on the slices.  Every update is elementwise, so
the slices move as the replicated state's entries do.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from latentpose_tpu_torch.data import augmentation
from latentpose_tpu_torch.parallel import mesh as parallel
from latentpose_tpu_torch.runners.optim import ema_update
from latentpose_tpu_torch.runners.state import (TrainState, d_trainable,
                                                ema_pairs, g_trainable)

EMA_ALPHA = {True: 0.972, False: 0.999}      # fine-tune, meta-train
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the batch keys the step reads where the batch has them (fine-tune reads
# the identity frames only for ê)
STEP_KEYS = ("pose_input_rgbs", "target_rgbs", "real_segm", "label",
             "dec_stickmen", "dec_keypoints")
META_STEP_KEYS = ("enc_rgbs", "enc_stickmen") + STEP_KEYS
# the model inputs cast to the compute dtype (as the JAX forward casts them)
CAST_KEYS = ("enc_rgbs", "pose_input_rgbs", "enc_stickmen", "dec_stickmen")


def compute_dtype(args):
    """torch's dtype of ``args.compute_dtype``."""
    return DTYPES[args.compute_dtype]


def to_device(batch, device, keys=STEP_KEYS):
    """The step's inputs from a (data_dict, target_dict) host batch, images
    as they come (f32, or uint8 on the wire: the step divides on the
    device), labels as int64; ``keys``: :data:`META_STEP_KEYS` for
    meta-train (the ones the batch has)."""
    merged = {**batch[0], **batch[1]}
    out = {key: torch.as_tensor(merged[key]).to(device) for key in keys
           if key in merged}
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


def model_inputs(batch, dtype):
    """The batch with the models' image inputs (:data:`CAST_KEYS`) in the
    compute dtype."""
    return {**batch, **{k: batch[k].to(dtype) for k in CAST_KEYS
                        if k in batch}}


def finetune_inputs(leaves, batch_size):
    """(embeds or None, the generator's keyword inputs) of a fine-tune's
    per-avatar leaves ({name: (1, N) tensor})."""
    embeds = leaves.get("finetune_embedding")
    if embeds is not None:
        embeds = embeds.expand(batch_size, -1)
    extra = {} if leaves.get("finetune_affine") is None \
        else {"finetune_affine": leaves["finetune_affine"]}
    return embeds, extra


def forward(state: TrainState, batch, train: bool, dropout_generator=None,
            dtype=torch.float32):
    """The populated data_dict of one step (reference key names); ``dtype``:
    the compute dtype (the module docstring's dtype map)."""
    embedder = state.models["embedder"]
    generator = state.models["generator"]
    dis = state.models["discriminator"]
    data_dict = dict(batch)
    inputs = model_inputs(batch, dtype)
    extra = {}
    if state.finetune:
        # the embedder is frozen: no gradient reaches it, but train-mode BN
        # still updates its running statistics
        with torch.no_grad():
            pose = embedder.get_pose_embedding(inputs["pose_input_rgbs"],
                                               train, dropout_generator)
        embeds, extra = finetune_inputs(state.finetune_leaves(),
                                        batch["label"].shape[0])
        elemwise = None
    else:
        embeds, elemwise, pose = embedder(
            *[inputs.get(k) for k in embedder.INPUT_KEYS], train=train,
            dropout_generator=dropout_generator)
    inputs.update(embeds=embeds, pose_embedding=pose)
    fake, fake_segm = generator(*[inputs.get(k)
                                  for k in generator.INPUT_KEYS],
                                update_stats=True, **extra)
    data_dict.update(embeds=embeds, embeds_elemwise=elemwise,
                     pose_embedding=pose, fake_rgbs=fake.float(),
                     fake_segm=None if fake_segm is None
                     else fake_segm.float())

    target = batch["target_rgbs"]
    target = target[:, 0] if target.dim() > 4 else target
    fake_in = dis.make_input(inputs, fake).to(dtype)
    real_in = dis.make_input(inputs, target).to(dtype)
    # (None for the ``none`` discriminator, which has no rows)
    rows = dis.embed_labels(batch["label"], update_stats=True)
    rows_sg = None if rows is None else rows.detach()
    # pass 1: fake through the G graph (only loss_G's G-side gradient is
    # taken from it); pass 2: fake detached, rows detached; pass 3: real
    fake_score_G, fake_features = dis.pass_inputs(
        fake_in, rows_sg, update_stats=True)
    fake_score_D, _ = dis.pass_inputs(fake_in.detach(), rows_sg,
                                      update_stats=True)
    real_score, real_features = dis.pass_inputs(real_in, rows,
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


def step_dropout_generator(seed: int, step: int, rank: int = 0):
    """The CPU generator of the pose encoder's dropout masks in train step
    ``step``: keyed on (seed, step) as the augmentation's draw is, on a key
    of its own, so a resumed run draws the masks an unbroken one draws;
    ``rank``: the explicit regime's own draw of each rank."""
    # (a CPU generator keeps a seed's low 32 bits)
    return torch.Generator().manual_seed(
        augmentation.step_key(seed, step, rank) ^ 0x9E3779B9)


def make_train_step(criteria, args, on_wire=None):
    """``step(state, batch) -> scalars``: one train step on ``batch``
    (device tensors, :func:`to_device`; under N ranks this rank's rows),
    updating ``state`` in place; the regime (meta-train or fine-tune) is
    the state's, the data-parallel regime the args' (module docstring).
    Augmentation and dropout draw from ``args.random_seed`` and the state's
    step.  ``on_wire(bucket)``: sees each gradient bucket as it goes on the
    wire (:func:`parallel.reduce_grads`, or its sharded form)."""
    train = not args.set_eval_mode_in_train
    dtype = compute_dtype(args)
    use_ema = args.weights_running_average
    accum = int(args.grad_accum_steps or 1)
    augments = dict(use_pixelwise=bool(args.use_pixelwise_augs),
                    use_scale=bool(args.use_affine_scale),
                    use_shift=bool(args.use_affine_shift))
    distributed = parallel.initialized()
    explicit = parallel.explicit_regime(args)
    if explicit and not distributed:
        raise ValueError("--grad_dtype bfloat16 / --explicit_grad_reduce "
                         "need a device mesh (--num_devices > 1)")
    # the gradients' own dtype (f32) on the wire, or bf16
    wire = torch.bfloat16 \
        if getattr(args, "grad_dtype", "float32") == "bfloat16" else None
    shared = distributed and not explicit     # the default regime
    layout = parallel.batch_layout(args)

    def step(state: TrainState, batch):
        batch = dequantize(batch)
        # the explicit regime's ranks draw their own; the default one's
        # take their rows of the global batch's draw
        draw_rank = parallel.rank() if explicit else 0
        if any(augments.values()):
            draw = augmentation.step_draw(args.random_seed, state.step,
                                          batch["pose_input_rgbs"].device,
                                          draw_rank)
            shard = {}
            if shared:
                size = batch["label"].shape[0] * parallel.world()
                shard = dict(rows=parallel.local_rows(size, layout),
                             global_size=size)
            batch = augmentation.augment_data_dict(batch, draw, **augments,
                                                   **shard)
        masks = step_dropout_generator(args.random_seed, state.step,
                                       draw_rank)
        grads_g = grads_d = totals = None
        with parallel.gathered(state):
            g_params, d_params = g_trainable(state), d_trainable(state)
            for micro in _microbatches(batch, accum):
                with parallel.global_batch(shared):
                    data_dict = forward(state, micro, train, masks, dtype)
                    losses_G, losses_D = apply_criteria(criteria, data_dict)
                    loss_G = sum(losses_G.values())
                    # no D criterion (X2Face): loss_D is 0, as in the JAX
                    # step
                    loss_D = sum(losses_D.values()) if losses_D \
                        else torch.zeros((), device=loss_G.device)
                    # the two graphs share no node that needs a gradient
                    # (pass 1 reads the rows detached, passes 2-3 the fake
                    # detached); the backward of a global sum sums over
                    # ranks
                    # (a tensor the forward does not read, as the FSTH
                    # projector in a fine-tune, has a zero gradient, as
                    # in the JAX step)
                    grads_g = _add(grads_g, torch.autograd.grad(
                        loss_G, g_params, allow_unused=True,
                        materialize_grads=True))
                    # (the ``none`` discriminator has no tensor to train)
                    grads_d = _add(grads_d, torch.autograd.grad(
                        loss_D, d_params) if d_params else [])
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
        if distributed:
            reduce = parallel.reduce_grads if state.layout is None \
                else parallel.reduce_scatter_grads
            grads_g = reduce(grads_g, wire, on_wire)
            grads_d = reduce(grads_d, wire, on_wire)
            totals = parallel.mean_scalars(totals)
            if explicit:
                parallel.average_running_stats(state.models)
        state.opt_g.step(grads_g)
        state.opt_d.step(grads_d)
        if use_ema:
            ema_update(*ema_pairs(state), EMA_ALPHA[state.finetune])
        state.step += 1
        return totals

    return step
