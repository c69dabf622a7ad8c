"""Results saver (port of ``latentpose_tpu/utils/saver.py``): one npz per
call, numbered, with the epoch, the iteration, scalars and arrays."""

from __future__ import annotations

from pathlib import Path

import numpy as np


class Saver:
    def __init__(self, save_dir, save_fn="npz_per_batch"):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.save_fn = save_fn
        self.counter = 0

    def save(self, epoch, iteration=0, scalars=None, data=None):
        payload = {"epoch": epoch, "iteration": iteration}
        if scalars:
            payload.update({f"scalar_{k}": v for k, v in scalars.items()})
        if data:
            payload.update({k: np.asarray(v) for k, v in data.items()
                            if v is not None and not isinstance(v, list)})
        np.savez(self.save_dir / f"{self.counter:06d}.npz", **payload)
        self.counter += 1
