"""Few-shot fine-tuning as a re-parameterisation (port of
``latentpose_tpu/runners/finetune.py``):

1. ê = the mean identity embedding over all of the avatar's frames (with
   their stickmen for the FSTH embedder), with the EMA embedder weights,
   the live BatchNorm statistics and eval mode;
2. the generator's per-avatar input becomes a trainable leaf, in params
   and in the EMA: the (1, E) ``finetune_embedding`` = ê, or what the
   generator's wrapper makes of ê (``make_finetune_state``: the FSTH
   generator's packed AdaIN parameters ``finetune_affine``);
3. the discriminator's label-embedding matrix W becomes one row = ê, with
   spectral-norm eps 1e-12 and the (u, v) of a fresh one-row init;
4. both optimizers start fresh (RAdam from the fine-tune config).

:func:`optimizers` also builds meta-training's (Adam, from the meta config).
"""

from __future__ import annotations

import copy
import logging

import torch
from torch.func import functional_call

from latentpose_tpu_torch.ops.spectral_norm import SNEmbed
from latentpose_tpu_torch.runners.loop import dequantize_batch_host
from latentpose_tpu_torch.runners.optim import Adam, RAdam, SetToZero
from latentpose_tpu_torch.runners.state import (TrainState, d_trainable,
                                                g_trainable)

logger = logging.getLogger("latentpose_tpu_torch.finetune")


@torch.no_grad()
def compute_averaged_identity_embedding(state: TrainState, dataloader,
                                        device, dtype=torch.float32):
    """ê (1, E) f32 over every ``enc_rgbs`` frame of one pass of
    ``dataloader`` (f32 or uint8 frames), through the EMA embedder in eval
    mode in ``dtype``: the frames' embeddings in ``dtype``, their mean in
    f32 (the JAX package averages bf16 rows in numpy's bf16, ROADMAP.md
    C.5)."""
    embedder = state.models["embedder"]
    weights = state.ema_params["embedder"]
    chunks = []
    for data_dict, _ in dataloader:
        frames = dequantize_batch_host(data_dict)
        # the identity frames (and their stickmen), no pose frame
        inputs = [torch.as_tensor(frames[k]).to(device).to(dtype)
                  if k in ("enc_rgbs", "enc_stickmen") else None
                  for k in embedder.INPUT_KEYS]
        _, elemwise, _ = functional_call(embedder, weights, tuple(inputs))
        chunks.append(elemwise.reshape(-1, elemwise.shape[-1]).float())
    logger.info("Averaged identity embedding over %d frame-chunks",
                len(chunks))
    return torch.cat(chunks).mean(dim=0, keepdim=True)


OPTIMIZERS = {"Adam": Adam, "RAdam": RAdam}


def optimizers(state: TrainState, args):
    """Fresh optimizers over the two trainable sets (reference betas
    (beta1, 0.999), eps 1e-5): ``args.optimizer`` is Adam or RAdam; a
    discriminator with nothing to train (``none``) takes
    :class:`SetToZero`, as its JAX wrapper's ``get_optimizer``."""
    opt = OPTIMIZERS[args.optimizer]
    opt_d = opt if d_trainable(state) else SetToZero
    return (opt(g_trainable(state), args.lr_gen, b1=args.beta1, b2=0.999,
                eps=1e-5),
            opt_d(d_trainable(state), args.lr_dis, b1=args.beta1, b2=0.999,
                  eps=1e-5))


def enable_finetuning(state: TrainState, args, identity_embedding,
                      generator=None, gen_wrapper=None) -> TrainState:
    """The fine-tune state from a meta-trained one (which stays as it was).

    ``identity_embedding``: ê (1, E).  ``generator``: a ``torch.Generator``
    for the fresh one-row embedding's (u, v) init.  ``gen_wrapper``: the
    generator's ``Wrapper``; where it has ``make_finetune_state(generator,
    ê)``, that gives the per-avatar leaves, else they are
    {'finetune_embedding': ê}."""
    ident = identity_embedding.detach().float()
    make = getattr(gen_wrapper, "make_finetune_state", None)
    leaves = {"finetune_embedding": ident} if make is None \
        else make(state.models["generator"], ident)
    models = dict(state.models)
    dis = copy.deepcopy(state.models["discriminator"])
    embed = SNEmbed(1, ident.shape[1], sn_eps=1e-12, generator=generator)
    with torch.no_grad():
        embed.weight.copy_(ident.cpu())
    dis.embed = embed.to(ident.device)
    models["discriminator"] = dis
    ema = dict(state.ema_params)
    ema.update({k: v.detach().float().clone() for k, v in leaves.items()})
    new = TrainState(models=models, ema_params=ema, step=state.step,
                     **{k: v.detach().float().clone().requires_grad_()
                        for k, v in leaves.items()})
    new.opt_g, new.opt_d = optimizers(new, args)
    return new
