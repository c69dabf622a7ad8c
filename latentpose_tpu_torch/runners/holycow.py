"""The fine-tune train step: G forward, D's embedding lookup and three
passes, the criteria, both optimizer updates and the EMA (port of
``latentpose_tpu/runners/holycow.py`` in its fine-tune regime).

The JAX step takes one ``value_and_grad`` of ``loss_G + loss_D`` with
stop-gradients that reproduce the reference's two backwards.  Here the two
backwards are taken as the reference takes them: ``loss_G``'s gradient
w.r.t. the generator side only, ``loss_D``'s w.r.t. the discriminator only.
Pass 2 sees the fake detached and the rows detached, pass 3 the live rows.
Every
spectral-norm state advances in the reference's order: the generator's once,
the embedding's once (lookup), the trunk's three times.

Not ported yet (refused by the CLI): meta-training, augmentation,
bf16 compute, gradient accumulation and multi-device reduction.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from latentpose_tpu_torch.runners.optim import ema_update
from latentpose_tpu_torch.runners.state import (TrainState, d_trainable,
                                                ema_pairs, g_trainable)

EMA_ALPHA_FINETUNE = 0.972
# the batch keys the fine-tune step reads (enc_rgbs only feeds ê)
STEP_KEYS = ("pose_input_rgbs", "target_rgbs", "real_segm", "label")


def to_device(batch, device):
    """The step's inputs from a (data_dict, target_dict) host batch (f32
    images; the uint8 wire is refused by the CLI), labels as int64."""
    merged = {**batch[0], **batch[1]}
    out = {key: torch.as_tensor(merged[key]).to(device) for key in STEP_KEYS}
    out["label"] = out["label"].long()
    return out


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


def forward(state: TrainState, batch, train: bool, dropout_generator=None):
    """The populated data_dict of one step (reference key names)."""
    embedder = state.models["embedder"]
    generator = state.models["generator"]
    dis = state.models["discriminator"]
    data_dict = dict(batch)
    # the embedder is frozen: no gradient reaches it, but train-mode BN
    # still updates its running statistics
    with torch.no_grad():
        pose = embedder.get_pose_embedding(batch["pose_input_rgbs"], train,
                                           dropout_generator)
    bsz = pose.shape[0]
    embeds = state.finetune_embedding.expand(bsz, -1)
    fake_rgbs, fake_segm = generator(embeds, pose, update_stats=True)
    data_dict.update(embeds=embeds, pose_embedding=pose,
                     fake_rgbs=fake_rgbs, fake_segm=fake_segm)

    target = batch["target_rgbs"]
    target = target[:, 0] if target.dim() > 4 else target
    rows = dis.embed_labels(batch["label"], update_stats=True)
    # pass 1: fake through the G graph (only loss_G's G-side gradient is
    # taken from it); pass 2: fake detached, rows detached; pass 3: real
    fake_score_G, fake_features = dis.pass_inputs(fake_rgbs, rows.detach(),
                                                  update_stats=True)
    fake_score_D, _ = dis.pass_inputs(fake_rgbs.detach(), rows.detach(),
                                      update_stats=True)
    real_score, real_features = dis.pass_inputs(target, rows,
                                                update_stats=True)
    data_dict.update(
        fake_features=fake_features, real_features=real_features,
        real_embedding=rows, fake_score_G=fake_score_G,
        fake_score_D=fake_score_D, real_score=real_score)
    return data_dict


def make_finetune_step(criteria, args, dropout_generator=None):
    """``step(state, batch) -> scalars``: one fine-tune step on ``batch``
    (device tensors, :func:`to_device`), updating ``state`` in place."""
    if not args.finetune:
        raise NotImplementedError(
            "the meta-train step is not ported to PyTorch yet (ROADMAP.md "
            "A.12)")
    train = not args.set_eval_mode_in_train
    use_ema = args.weights_running_average

    def step(state: TrainState, batch):
        data_dict = forward(state, batch, train, dropout_generator)
        losses_G, losses_D = apply_criteria(criteria, data_dict)
        loss_G = sum(losses_G.values())
        loss_D = sum(losses_D.values())
        g_params, d_params = g_trainable(state), d_trainable(state)
        # the two graphs share no node that needs a gradient (pass 1 reads
        # the rows detached, passes 2-3 the fake detached)
        grads_g = torch.autograd.grad(loss_G, g_params)
        grads_d = torch.autograd.grad(loss_D, d_params)
        state.opt_g.step(grads_g)
        state.opt_d.step(grads_d)
        if use_ema:
            ema_update(*ema_pairs(state), EMA_ALPHA_FINETUNE)
        state.step += 1
        scalars = {f"Loss_{k}": v.detach()
                   for k, v in {**losses_G, **losses_D}.items()}
        scalars["loss_G"] = loss_G.detach()
        scalars["loss_D"] = loss_D.detach()
        return scalars

    return step
