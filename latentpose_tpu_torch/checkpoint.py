"""Reader and writer of the JAX package's checkpoint format, numpy only
(port of ``latentpose_tpu/checkpoint.py``).

A checkpoint is a directory ``model_<iteration:08d>.ckpt`` holding
``meta.json`` (the full args namespace, the iteration and the fine-tune flag)
and ``arrays.npz`` (the flattened train state, keys joined with ``::``, e.g.
``ema_params::generator::block0::conv0::kernel``).  Arrays keep the JAX
layouts; ``convert.py`` maps them onto the port's modules.
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path

import numpy as np

logger = logging.getLogger("latentpose_tpu_torch.checkpoint")

SEP = "::"


def load_arrays(checkpoint_path) -> dict:
    """All arrays of a checkpoint, by their flat ``::`` keys."""
    with np.load(Path(checkpoint_path) / "arrays.npz") as raw:
        return {k: raw[k] for k in raw.files}


def peek_args(checkpoint_path) -> dict:
    """The saved args, with ``iteration`` from the metadata."""
    meta_path = Path(checkpoint_path) / "meta.json"
    if not meta_path.exists():
        raise FileNotFoundError(meta_path)
    meta = json.loads(meta_path.read_text())
    args = dict(meta["args"])
    args["iteration"] = meta.get("iteration", args.get("iteration", 0))
    return args


def save_checkpoint(experiment_dir, arrays: dict, args: dict, iteration: int,
                    finetune: bool):
    """Write ``<experiment_dir>/checkpoints/model_<iteration>.ckpt`` (suffixed
    ``_0`` on a name collision) from flat ``::`` arrays; returns its path.
    A write that fails (disk full) removes the partial directory."""
    ckpt_dir = Path(experiment_dir) / "checkpoints"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"model_{int(iteration):08d}.ckpt"
    while path.exists():
        path = path.with_name(path.name + "_0")
    path.mkdir(parents=True)
    try:
        np.savez(path / "arrays.npz", **arrays)
        meta = {"format_version": 1, "iteration": int(iteration),
                "finetune": bool(finetune), "args": args}
        (path / "meta.json").write_text(json.dumps(meta, indent=1))
    except OSError:
        logger.exception("Failed writing checkpoint %s — removing partial "
                         "file (disk full?)", path)
        shutil.rmtree(path, ignore_errors=True)
        raise
    logger.info("Saved checkpoint %s", path)
    return path
