"""The port's train state (port of ``latentpose_tpu/runners/state.py``).

The JAX TrainState is one pytree; here its leaves live where PyTorch keeps
them:

- ``params``, ``batch_stats`` and ``spectral`` are the parameters,
  BatchNorm running statistics and spectral-norm (u, v) buffers of the
  three modules in ``models`` ({'embedder', 'generator', 'discriminator'});
- ``finetune_embedding`` is a (1, E) leaf tensor after the fine-tune
  re-parameterisation (None before);
- ``ema_params`` holds the EMA weights: {'embedder': {name: tensor},
  'generator': {name: tensor}} by ``named_parameters`` name, plus
  'finetune_embedding'; BatchNorm statistics are shared with the live
  modules, not averaged;
- ``opt_g`` / ``opt_d`` are the two optimizers (``runners/optim.py``), over
  :func:`g_trainable` and :func:`d_trainable`;
- ``step`` is the global iteration;
- ``layout`` is None, or under ``--param_sharding fsdp`` the
  ``parallel.mesh.ShardedState`` that holds this rank's slices of the
  parameters, the EMA and the optimizers' moments
  (``parallel.mesh.shard_state`` over :func:`shard_groups`): the optimizers
  then run over the slices, :func:`ema_pairs` pairs the slices, and the
  modules hold their parameters only inside ``parallel.mesh.gathered``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass
class TrainState:
    models: Dict[str, torch.nn.Module]
    ema_params: Dict[str, Any]
    step: int = 0
    finetune_embedding: Optional[torch.Tensor] = None
    opt_g: Any = None
    opt_d: Any = None
    layout: Any = None

    @property
    def finetune(self) -> bool:
        return self.finetune_embedding is not None


def ema_of(module) -> dict:
    """A detached copy of ``module``'s parameters, by name."""
    return {k: p.detach().clone() for k, p in module.named_parameters()}


def g_trainable(state: TrainState):
    """The generator-side optimizer's tensors.  Meta-training: the generator
    and the whole embedder (identity and pose towers).  Fine-tuning: the
    generator and the per-avatar identity embedding (the embedder is
    frozen)."""
    if state.finetune:
        return [*state.models["generator"].parameters(),
                state.finetune_embedding]
    return [*state.models["generator"].parameters(),
            *state.models["embedder"].parameters()]


def d_trainable(state: TrainState):
    return list(state.models["discriminator"].parameters())


def shard_groups(state: TrainState):
    """The groups a sharded state lays out, each one bucket: 'g' and 'd'
    (the two optimizers' tensors, in their order) and, in a fine-tune,
    'frozen' (the embedder, which no optimizer trains)."""
    groups = {"g": g_trainable(state), "d": d_trainable(state)}
    if state.finetune:
        groups["frozen"] = list(state.models["embedder"].parameters())
    return groups


def ema_pairs(state: TrainState):
    """(EMA tensors, live tensors) over every EMA entry, paired in order;
    of a sharded state, this rank's slices of them."""
    if state.layout is not None:
        return state.layout.ema_pairs()
    ema, live = [], []
    for part in ("embedder", "generator"):
        params = dict(state.models[part].named_parameters())
        for name, tensor in state.ema_params[part].items():
            ema.append(tensor)
            live.append(params[name])
    if state.finetune:
        ema.append(state.ema_params["finetune_embedding"])
        live.append(state.finetune_embedding)
    return ema, live
