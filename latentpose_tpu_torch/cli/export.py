"""Serving export of the PyTorch port (port of
``latentpose_tpu/cli/export.py``): the fine-tuned drive step as one
``torch.export`` program, saved as ``.pt2``.

The artifact holds the avatar's EMA weights, its identity and, for
``--quantize int8_static``, the calibrated activation maxima, with the
graph of one drive step at one batch size and one wire dtype::

    from latentpose_tpu_torch.cli.export import load_serving_artifact
    serve = load_serving_artifact("avatar/serving.pt2")
    rgbs, segm = serve(frame_batch)   # uint8/float32 (B, H, W, 3)

The generator's AdaIN calls stay the port's operator
``latentpose::adain_fused`` in the graph (``ops/adain.py``), so the CUDA
kernel runs when the artifact runs.  The program is exported for one device
type, the one it was traced on (``--device``, the card by default).

    python -m latentpose_tpu_torch.cli.export CHECKPOINT \
        [--destination avatar.pt2] [--export_batch_size 32] \
        [--transfer_dtype uint8|float32] [--quantize int8|int8_static \
        --calibration_source DIR|VIDEO|synthetic://K] [--device cpu]

Unlike the JAX CLI, ``--quantize int8_static`` needs an explicit
``--calibration_source``: scales calibrated on synthetic renders would be
baked into an artifact served on real faces.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np
import torch

from latentpose_tpu_torch.cli import drive as drive_cli
from latentpose_tpu_torch.runners import drive as drive_lib

logger = logging.getLogger("latentpose_tpu_torch.export")

WIRE_DTYPES = {"uint8": torch.uint8, "float32": torch.float32}


def export_serving_artifact(models, state, args, batch_size, wire_dtype,
                            quant_calib=None):
    """The drive step over ``state``'s identity as a
    ``torch.export.ExportedProgram`` for (batch_size, S, S, 3) frames of
    ``wire_dtype`` on the models' device.  ``quant_calib``: the calibrated
    activation maxima of an ``int8_static`` generator, loaded into it and
    exported with its buffers."""
    if quant_calib is not None:
        drive_lib.load_quant_calib(models["generator"], quant_calib)
    identity = state["finetune_embedding"]
    module = drive_lib.DriveModule(
        models["embedder"], models["generator"], identity,
        drive_lib.compute_dtype(args)).eval()
    size = args.image_size
    frames = torch.zeros((batch_size, size, size, 3), dtype=wire_dtype,
                         device=identity.device)
    # torch.export does not trace through inference_mode
    with torch.no_grad():
        return torch.export.export(module, (frames,))


def load_serving_artifact(path):
    """The ``.pt2`` at ``path`` as a callable module: ``(frames) -> (rgbs,
    segm)``.  Unlike the JAX package's StableHLO artifact, the program
    calls the port's operator ``latentpose::adain_fused``, so the serving
    host needs this package installed (and, on the card, ``nvcc`` to build
    the kernel at its first launch).  Its weights are frozen: a call
    records no autograd graph."""
    from latentpose_tpu_torch.ops import adain  # noqa: F401  (the operator)
    return torch.export.load(str(path)).module().requires_grad_(False)


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("checkpoint_path")
    parser.add_argument("--destination", default="",
                        help="default: <checkpoint>/serving.pt2")
    parser.add_argument("--export_batch_size", type=int, default=32)
    parser.add_argument("--transfer_dtype", default="uint8",
                        choices=sorted(WIRE_DTYPES))
    parser.add_argument("--platforms", default="",
                        help="the JAX CLI's lowering platforms; a .pt2 runs "
                             "on the device type it was exported on, so "
                             "only that one (or '') is taken")
    parser.add_argument("--quantize", default="",
                        choices=["", "int8", "int8_static"])
    parser.add_argument("--calibration_source", default=None,
                        help="int8_static (required): driver frames for the "
                             "activation-scale calibration pass (dir / "
                             "video / synthetic://K); the calibrated "
                             "scales are baked into the artifact")
    parser.add_argument("--calibration_frames", type=int, default=64)
    parser.add_argument("--compute_dtype", default=None,
                        choices=["float32", "bfloat16"])
    parser.add_argument("--device", default="cuda",
                        help="torch device to export for")
    return parser


def resolve_args(argv=None):
    """Flags over the checkpoint's saved args, with drive's overrides; the
    checks that need no model."""
    cli = build_parser().parse_args(argv)
    args = drive_cli.inference_args(cli, "export")
    device_type = torch.device(args.device).type
    platforms = [p.strip() for p in args.platforms.split(",") if p.strip()]
    if platforms and platforms != [device_type]:
        raise ValueError(
            f"--platforms {args.platforms}: a .pt2 runs on the one device "
            f"type it is exported on, here {device_type} (--device "
            f"{args.device}); pass --platforms {device_type} or none")
    if args.quantize == "int8_static" and not cli.calibration_source:
        raise ValueError(
            "--quantize int8_static needs --calibration_source: the "
            "calibrated scales are baked into the artifact, so they must "
            "come from frames like the ones it will serve")
    args.platforms = [device_type]
    return args


# the embedder the export covers; the ablation families' avatars wait
EXPORTED_EMBEDDER = "unsupervised_pose_separate_embResNeXt_segmentation"


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = resolve_args(argv)
    if args.embedder != EXPORTED_EMBEDDER:
        raise NotImplementedError(
            f"export of a {args.embedder} avatar is not ported to PyTorch "
            "yet (ROADMAP.md A.19, export of the ablation avatars); the "
            "port exports the flagship's")
    models, state = drive_cli.load_finetuned(args, torch.device(args.device))

    quant_calib = None
    if args.quantize == "int8_static":
        frames = drive_cli.load_driver_frames(args.calibration_source,
                                              args.image_size)
        frames = frames[:max(args.calibration_frames, 1)]
        if frames.dtype == np.uint8:
            frames = frames.astype(np.float32) / 255.0
        quant_calib = drive_lib.calibrate_quant_scales(
            models, args, state, frames,
            batch_size=min(args.export_batch_size, len(frames)))
        logger.info("int8_static: calibrated on %d frames from %s",
                    len(frames), args.calibration_source)

    exported = export_serving_artifact(
        models, state, args, args.export_batch_size,
        WIRE_DTYPES[args.transfer_dtype], quant_calib=quant_calib)
    dest = Path(args.destination or (
        Path(args.checkpoint_path) / "serving.pt2"))
    dest.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, str(dest))
    size = dest.stat().st_size
    meta = {
        "batch_size": args.export_batch_size,
        "image_size": args.image_size,
        "transfer_dtype": args.transfer_dtype,
        "quantize": args.quantize,
        "platforms": args.platforms,
        "iteration": int(args.iteration),
        "outputs": ["fake_rgbs", "fake_segm"],
        "bytes": size,
    }
    dest.with_suffix(dest.suffix + ".json").write_text(
        json.dumps(meta, indent=1))
    logger.info("Exported %s (%.1f MiB, %s, iteration %d)", dest,
                size / 2**20, args.platforms[0], int(args.iteration))
    return str(dest)


if __name__ == "__main__":
    main()
