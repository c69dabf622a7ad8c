#!/usr/bin/env python3
"""The port's bf16 drive step of two checkouts on one NVIDIA GPU, in turns.

    python3 tools/compare_drive_step.py TREE_A TREE_B [--rounds 2]

Each round runs A, B, B, A, each turn in a fresh process from that tree's
root: chip_smoke.py's seeded flagship checkpoint (256², full widths), then
the drive step (frames already on the card, uint8 wire) at batch 32 and 128:
milliseconds per step over 3 x 10 untraced steps (CUDA events), and the
device's busy milliseconds per step from torch.profiler over 5 steps.  One
line of JSON per turn; TF32 off, as in chip_smoke.py.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path


def turn(tree: Path) -> dict:
    """One measurement, run inside ``tree`` (its modules on sys.path)."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    import chip_smoke as cs
    from latentpose_tpu_torch.cli import drive as cli
    from latentpose_tpu_torch.runners import drive as drive_lib

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": str(tree)}
    with tempfile.TemporaryDirectory() as workdir:
        ckpt = cs.phase_checkpoint(workdir)
        args = cli.resolve_args([str(ckpt), "--device", "cuda"])
        models, state = cli.load_finetuned(args, torch.device("cuda"))
        drive_fn = drive_lib.make_drive_fn(models, args)
        frames = cli.load_driver_frames("synthetic://3", args.image_size)
        seq = np.concatenate([frames] * 4)
        for batch in (32, 128):
            wire = torch.from_numpy(
                (seq[:batch] * 255).astype(np.uint8)).cuda()
            steps = [cs.cuda_ms(lambda: drive_fn(state, wire), 10)
                     for _ in range(3)]
            activities = [torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=activities) as prof:
                for _ in range(5):
                    drive_fn(state, wire)
                torch.cuda.synchronize()
            busy = sum(e.device_time_total for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
            out[f"step_ms_{batch}"] = steps
            out[f"device_busy_ms_{batch}"] = busy / 1e3 / 5
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("tree_a", type=Path)
    parser.add_argument("tree_b", type=Path)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve())), flush=True)
        return
    for _ in range(args.rounds):
        for tree in (args.tree_a, args.tree_b, args.tree_b, args.tree_a):
            tree = tree.resolve()
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), str(tree),
                 str(tree), "--turn", str(tree)],
                cwd=tree, capture_output=True, text=True, timeout=600)
            if proc.returncode:
                raise SystemExit(f"turn in {tree} failed:\n{proc.stderr}")
            print(proc.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
