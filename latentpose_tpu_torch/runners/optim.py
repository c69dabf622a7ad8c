"""Adam and RAdam as ``optax.adam`` and ``optax.radam`` compute them, and the
EMA of weights (port of the optimizers in ``latentpose_tpu/runners/
holycow.py`` ``get_gen_optimizer``, ``models/discriminators/no_landmarks.py``
``get_optimizer``, and the EMA in ``runners/holycow.py`` ``train_step``).
Meta-training takes Adam, fine-tuning RAdam; the ``none`` discriminator
takes optax's ``set_to_zero`` (:class:`SetToZero`).

``torch.optim.RAdam`` is not the same update: it puts eps as
``sqrt(bc2) / (sqrt(v) + eps)`` where optax has ``1 / (sqrt(v / bc2) + eps)``,
and it rectifies when ρ > 5 where optax does when ρ >= 5; ``torch.optim.Adam``
puts eps in the same other place.  So this module writes optax's forms on
tensors, with optax's f32 arithmetic for the schedule scalars.  β₂ᵗ is the correctly rounded f32 power; XLA's f32 pow on
the CPU lands 1-2 ulps off it for some t, and ρ_t, a difference of two
numbers near 2000, then moves by ~0.02 (0.3 % of the rectified step).

Every update is elementwise (RAdam's rectification is one scalar a step),
so under ``--param_sharding fsdp`` each optimizer runs unchanged over one
tensor, the rank's slice of its group's bucket, with ``mu`` and ``nu``
laid out as that slice (``parallel/mesh.py`` ``shard_state``), and
``ema_update`` over the EMA's slices.
"""

from __future__ import annotations

import math

import numpy as np
import torch

f32 = np.float32


def _pow(base: float, count: int) -> np.float32:
    """f32(base) ** count, correctly rounded to f32."""
    return f32(float(f32(base)) ** count)


class Adam:
    """``optax.adam(lr, b1, b2, eps)`` over a list of tensors, updated in
    place; state: ``count`` and the moments ``mu``, ``nu`` per tensor (the
    layout of optax's ``ScaleByAdamState``, which RAdam shares)."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def _advance(self, grads):
        """Count the step and move the moments toward ``grads``."""
        self.count += 1
        for g, mu, nu in zip(grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)

    @torch.no_grad()
    def step(self, grads):
        """One update from ``grads`` (one per tensor, same order):
        p -= lr · (mu / bc1) / (sqrt(nu / bc2) + eps)."""
        self._advance(grads)
        bc1 = float(f32(1) - _pow(self.b1, self.count))
        bc2 = float(f32(1) - _pow(self.b2, self.count))
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(update * -self.lr)


class RAdam(Adam):
    """``optax.radam(lr, b1, b2, eps)``, with Adam's state."""

    THRESHOLD = 5.0     # optax's rectification threshold on ρ_t

    def schedule(self, count: int):
        """(ρ_t, r_t, 1 - β₁ᵗ, 1 - β₂ᵗ) for step ``count`` (1-based), in f32."""
        b2 = self.b2
        ro_inf = 2.0 / (1.0 - b2) - 1.0               # a Python float
        b2t = _pow(b2, count)
        ro = f32(ro_inf) - f32(2 * count) * b2t / (f32(1) - b2t)
        r = np.sqrt((ro - f32(4)) * (ro - f32(2)) * f32(ro_inf)
                    / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)) \
            if ro >= 4 else f32(math.nan)
        return ro, r, f32(1) - _pow(self.b1, count), f32(1) - b2t

    @torch.no_grad()
    def step(self, grads):
        """One update from ``grads`` (one per tensor, same order)."""
        self._advance(grads)
        ro, r, bc1, bc2 = self.schedule(self.count)
        rectify = bool(ro >= self.THRESHOLD)
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            mu_hat = mu / float(bc1)
            if rectify:
                nu_hat = nu / float(bc2)
                update = float(r) * mu_hat / (torch.sqrt(nu_hat) + self.eps)
            else:
                update = mu_hat
            p.add_(update * -self.lr)


class SetToZero:
    """``optax.set_to_zero()``: the ``none`` discriminator's optimizer, over
    no tensor.  Its state is optax's ``EmptyState``, which a checkpoint
    does not hold (``convert.py`` writes and reads nothing for it)."""

    def __init__(self, params=(), *args, **kwargs):
        self.params = list(params)
        self.count = 0
        self.mu, self.nu = [], []

    def step(self, grads):
        pass


@torch.no_grad()
def ema_update(ema, live, alpha: float):
    """``ema = ema * alpha + live * (1 - alpha)`` for paired tensor lists,
    in place."""
    for a, b in zip(ema, live):
        a.copy_(a * alpha + b * (1.0 - alpha))
