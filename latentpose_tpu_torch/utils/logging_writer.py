"""Experiment logging (port of ``latentpose_tpu/utils/logging_writer.py``).

- ``setup_logging`` creates ``experiments_dir/experiment_name`` with a
  ``checkpoints/`` subdir; the experiment's automatic name is built from the
  non-default args and a timestamp;
- the writer pauses image and scalar writes while the free disk is under
  1 GiB;
- scalars go to ``scalars.jsonl`` and images to ``images/<tag>_<step>.png``
  (the port's own PNG encoder: the card's machine has neither cv2 nor PIL)
  with their captions beside them, and to TensorBoard as well when
  tensorboardX imports.
"""

from __future__ import annotations

import json
import logging
import shutil
import time
from pathlib import Path

import numpy as np

from latentpose_tpu_torch.utils.png import write_png

logger = logging.getLogger("latentpose_tpu_torch.logging")

_MIN_FREE_BYTES = 1 << 30  # 1 GiB


def _disk_ok(path):
    try:
        return shutil.disk_usage(str(path)).free >= _MIN_FREE_BYTES
    except OSError:
        return True


def get_postfix(args_dict, default_args_dict, args_to_ignore,
                delimiter="__"):
    """Sorted ``arg^value`` pairs for every non-default, non-ignored arg,
    joined by ``__``, with ``/`` mapped to ``+``.  A key absent from the
    defaults counts as non-default."""
    s = []
    for arg in sorted(args_dict.keys()):
        if arg in args_to_ignore:
            continue
        if arg in default_args_dict \
                and default_args_dict[arg] == args_dict[arg]:
            continue
        s.append(f"{arg}^{args_dict[arg]}")
    return delimiter.join(s).replace("/", "+")


def get_experiment_name(args, default_args, args_to_ignore):
    """``args.experiment_name``, else the non-default args' postfix under a
    timestamp, cut to 255 characters (a file name's limit, which the JAX
    package's name can pass)."""
    if getattr(args, "experiment_name", ""):
        return args.experiment_name
    postfix = get_postfix(vars(args),
                          vars(default_args) if default_args else {},
                          args_to_ignore)
    return time.strftime("%m-%d_%H-%M___") + postfix[:241]


class ExperimentWriter:
    def __init__(self, experiment_dir):
        self.experiment_dir = Path(experiment_dir)
        self.experiment_dir.mkdir(parents=True, exist_ok=True)
        (self.experiment_dir / "checkpoints").mkdir(exist_ok=True)
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
            self._tb = SummaryWriter(logdir=str(self.experiment_dir))
        except ImportError:
            pass
        self._scalar_file = open(self.experiment_dir / "scalars.jsonl", "a")
        self.images_dir = self.experiment_dir / "images"
        self.images_dir.mkdir(exist_ok=True)

    def add_scalar(self, tag, value, step):
        if not _disk_ok(self.experiment_dir):
            return
        value = float(value)
        self._scalar_file.write(
            json.dumps({"tag": tag, "value": value, "step": int(step)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def flush(self):
        self._scalar_file.flush()
        if self._tb is not None:
            self._tb.flush()

    def add_image(self, tag, image, captions, step):
        """image: (H, W, 3) float in [0, 1] (an assembled grid)."""
        if not _disk_ok(self.experiment_dir):
            return
        arr = np.clip(np.asarray(image), 0.0, 1.0)
        out = self.images_dir / f"{tag.replace('/', '_')}_{int(step):08d}.png"
        write_png(out, (arr * 255).astype(np.uint8))
        if captions:
            out.with_suffix(".txt").write_text("\n".join(map(str, captions)))
        if self._tb is not None:
            try:
                self._tb.add_image(tag, arr.transpose(2, 0, 1), step)
            except ImportError:   # tensorboardX encodes images with PIL
                logger.warning("TensorBoard images need PIL; %s is in %s",
                               tag, self.images_dir)

    def close(self):
        self._scalar_file.close()
        if self._tb is not None:
            self._tb.close()


def setup_logging(args, default_args, args_to_ignore):
    """(experiment dir, its :class:`ExperimentWriter`)."""
    name = get_experiment_name(args, default_args, args_to_ignore)
    experiment_dir = Path(args.experiments_dir) / name
    writer = ExperimentWriter(experiment_dir)
    logger.info("Logging experiment to %s", experiment_dir)
    return str(experiment_dir), writer
