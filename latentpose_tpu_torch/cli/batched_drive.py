"""Batched driving sweep of the PyTorch port (port of
``latentpose_tpu/cli/batched_drive.py``; reference ``batched_drive.py``):
for each fine-tuned avatar directory, find its latest checkpoint and drive it
with every driver sequence (``:122-138``), through
``python -m latentpose_tpu_torch.cli.drive``.

A driver ``id/vid/driver`` (relative to ``<data_root>/<img_dir>``) becomes
``<avatar>/driving-results/id_vid_driver.mp4`` (or its ``.frames/``
directory), which ``compute_pose_identity_error`` reads for the avatar
``id_vid_identity`` that ``batched_finetune`` wrote.
"""

from __future__ import annotations

import argparse
import logging
import subprocess
import sys
from pathlib import Path

logger = logging.getLogger("batched_drive")


def latest_checkpoint(ckpt_dir: Path):
    checkpoints = sorted(ckpt_dir.iterdir())
    if len(checkpoints) > 1:
        logger.warning("%d checkpoints in %s; using latest (%s)",
                       len(checkpoints), ckpt_dir, checkpoints[-1].name)
    return checkpoints[-1]


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--puppeteering_dir", type=Path, required=True,
                        help="Output dir of batched_finetune (contains one "
                             "subdir per fine-tuned identity)")
    parser.add_argument("--data_root", type=str, default="")
    parser.add_argument("--drivers", nargs="+", required=True,
                        help="Driver sequences (dirs / videos / "
                             "synthetic://K) passed to the port's drive")
    parser.add_argument("--extra_args", nargs=argparse.REMAINDER, default=[])
    parser.add_argument("--dry_run", action="store_true")
    args = parser.parse_args(argv)

    avatar_dirs = sorted(
        d for d in args.puppeteering_dir.iterdir()
        if (d / "checkpoints").is_dir())
    if not avatar_dirs:
        parser.error(f"No fine-tuned avatars under {args.puppeteering_dir}")

    commands = []
    for avatar in avatar_dirs:
        ckpt = latest_checkpoint(avatar / "checkpoints")
        command = [
            sys.executable, "-m", "latentpose_tpu_torch.cli.drive", str(ckpt),
            "--destination", str(avatar / "driving-results"),
        ]
        if args.data_root:
            command += ["--data_root", args.data_root]
        command += ["--images_paths"] + list(args.drivers)
        command += list(args.extra_args)
        commands.append(command)
        if args.dry_run:
            print(" ".join(command))
        else:
            subprocess.run(command, check=True)
    return commands


if __name__ == "__main__":
    main()
