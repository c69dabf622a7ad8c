"""Batched fine-tune sweep of the PyTorch port (port of
``latentpose_tpu/cli/batched_finetune.py``; reference ``batched_finetune.py``):
for each (meta-checkpoint x identity) spawn a fine-tuning run, with the
batch size / epoch count derived from the identity's image count (560-target
iteration protocol, ``:95-101``).

Unlike the reference (hardcoded model/identity lists + LSF submission), the
sweep is fully parameterized: identities come from --identities or
--identities_file; models from repeated --model CHECKPOINT_PATH.  The
reference's cluster path (`bsub` with hardcoded queue/GPU flags,
``batched_finetune.py:123-135``) generalizes to ``--submit_template``: a
shell template with ``{cmd}`` / ``{name}`` / ``{log}`` placeholders, so any
scheduler works, e.g.
  --submit_template 'bsub -J {name} -o {log} {cmd}'          (LSF)
  --submit_template 'sbatch -J {name} -o {log} --wrap {cmd}' (Slurm)

Each run is ``python -m latentpose_tpu_torch.cli.train --config_name
finetuning-base ...`` (``--extra_args --device cpu`` runs it on the CPU).
An identity ``id/vid/identity`` fine-tunes on
``<data_root>/<img_dir>/id/vid/identity`` into
``<output_dir>/<model tag>/id_vid_identity``.
"""

from __future__ import annotations

import argparse
import logging
import shlex
import subprocess
import sys
from pathlib import Path

logger = logging.getLogger("batched_finetune")

TARGET_NUM_ITERATIONS = 560  # paper eval protocol (reference :99)


def string_to_valid_filename(x):
    return str(x).replace("/", "_")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", action="append", required=True,
                        help="Meta-trained checkpoint path (repeatable)")
    parser.add_argument("--data_root", type=Path, required=True)
    parser.add_argument("--img_dir", type=str, default="images-cropped")
    parser.add_argument("--identities", nargs="*", default=[])
    parser.add_argument("--identities_file", type=str, default="")
    parser.add_argument("--output_dir", type=Path, default=Path("puppeteering"))
    parser.add_argument("--max_batch_size", type=int, default=8)
    parser.add_argument("--target_iterations", type=int,
                        default=TARGET_NUM_ITERATIONS)
    parser.add_argument("--criterions", type=str,
                        default="adversarial, featmat, idt_embed, "
                                "perceptual, dice")
    parser.add_argument("--extra_args", nargs=argparse.REMAINDER, default=[],
                        help="Passed through to the port's train CLI")
    parser.add_argument("--submit_template", type=str, default="",
                        help="Scheduler submission template; {cmd} is the "
                             "shell-quoted fine-tune command, {name} the "
                             "experiment name, {log} a per-run log path. "
                             "Empty (default) runs locally and serially, "
                             "like the reference without --use_bsub.")
    parser.add_argument("--dry_run", action="store_true")
    args = parser.parse_args(argv)

    identities = list(args.identities)
    if args.identities_file:
        identities += [ln.strip() for ln in open(args.identities_file)
                       if ln.strip()]
    if not identities:
        parser.error("No identities given (--identities/--identities_file)")

    commands = []
    for checkpoint_path in args.model:
        ckpt = Path(checkpoint_path)
        assert ckpt.exists(), ckpt
        model_tag = string_to_valid_filename(
            ckpt.parent.parent.name + "_" + ckpt.name)
        output_dir = args.output_dir / model_tag

        for identity in identities:
            experiment_name = string_to_valid_filename(identity)
            ckpt_out = output_dir / experiment_name / "checkpoints"
            if ckpt_out.is_dir() and any(ckpt_out.iterdir()):
                logger.info("Skipping %s (already fine-tuned)", ckpt_out)
                continue

            images_dir = args.data_root / args.img_dir / identity
            num_images = sum(1 for _ in images_dir.iterdir())
            batch_size = min(num_images, args.max_batch_size)
            iters_per_epoch = num_images // batch_size
            num_epochs = -(-args.target_iterations // iters_per_epoch)

            command = [
                sys.executable, "-m", "latentpose_tpu_torch.cli.train",
                "--config_name", "finetuning-base",
                "--checkpoint_path", str(ckpt),
                "--data_root", str(args.data_root),
                "--img_dir", args.img_dir,
                "--train_split_path", str(identity),
                "--batch_size", str(batch_size),
                "--num_epochs", str(num_epochs),
                "--experiments_dir", str(output_dir),
                "--experiment_name", experiment_name,
                "--criterions", args.criterions,
            ] + list(args.extra_args)
            if args.submit_template:
                # submit to a scheduler (reference batched_finetune.py:
                # 123-135 hardcodes `bsub -gpu ... -o ... python3 ...`;
                # the template form covers LSF/Slurm/anything)
                log_path = output_dir / experiment_name / "finetune.log"
                submit = args.submit_template.format(
                    cmd=shlex.join(command),
                    name=f"{model_tag}__{experiment_name}",
                    log=shlex.quote(str(log_path)))
                commands.append(submit)
                if args.dry_run:
                    print(submit)
                else:
                    log_path.parent.mkdir(parents=True, exist_ok=True)
                    subprocess.run(submit, shell=True, check=True)
                continue
            commands.append(command)
            if args.dry_run:
                print(" ".join(command))
            else:
                subprocess.run(command, check=True)
    return commands


if __name__ == "__main__":
    main()
