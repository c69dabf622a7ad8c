"""Drive entry point of the PyTorch port (port of ``latentpose_tpu/cli/drive.py``).

Loads a fine-tuned checkpoint written by either package (EMA weights), then
renders the avatar side by side with each driver sequence into an mp4:

    python -m latentpose_tpu_torch.cli.drive CHECKPOINT_PATH [DATA_ROOT] \
        --images_paths dir_or_video [...] --destination out_dir

Driver sources: a directory of images, a video file, or ``synthetic://K``
(procedural driver identity K).  The model args come from the checkpoint's
``meta.json``; flags given here override them.  Compute runs in bf16 unless
``--compute_dtype`` is given.
"""

from __future__ import annotations

import argparse
import logging
import os
import types
from pathlib import Path

import numpy as np
import torch

from latentpose_tpu.utils.video import get_image_writer, to_uint8
from latentpose_tpu_torch import checkpoint as ckpt_lib
from latentpose_tpu_torch import convert, registry
from latentpose_tpu_torch.runners import drive as drive_lib

logger = logging.getLogger("latentpose_tpu_torch.drive")


def load_driver_frames(path, image_size):
    """A driver sequence as (N, H, W, 3): uint8 for decoded image and video
    sources (the wire format, rescaled on the device), float32 in [0, 1]
    for ``synthetic://K`` (32 frames)."""
    if str(path).startswith("synthetic://"):
        from latentpose_tpu_torch.data.synthetic import render_face
        label = int(str(path).split("://", 1)[1])
        return np.stack([render_face(label, f, image_size)[0]
                         for f in range(32)])

    path = Path(path)
    frames = []
    if path.is_dir():
        files = sorted(p for p in path.iterdir()
                       if p.suffix.lower() in (".jpg", ".jpeg", ".png",
                                               ".bmp"))
        # C++ thread-pool decode + resize (native/lpr_loader.cpp)
        from latentpose_tpu.data import native_loader
        if native_loader.is_available():
            images, failed = native_loader.NativeBatchLoader().load(
                [str(p) for p in files], image_size)
            if failed == 0:
                return images
        import cv2
        for p in files:
            img = cv2.imread(str(p))[..., ::-1]
            frames.append(cv2.resize(img, (image_size, image_size)))
    else:
        import cv2
        cap = cv2.VideoCapture(str(path))
        while True:
            ok, img = cap.read()
            if not ok:
                break
            frames.append(cv2.resize(img[..., ::-1],
                                     (image_size, image_size)))
        cap.release()
    if not frames:
        raise FileNotFoundError(f"No frames found in {path}")
    return np.stack(frames)


def load_finetuned(args, device):
    """Build the flagship's drive modules from ``args``, load the fine-tuned
    checkpoint ``args.checkpoint_path`` into them and move them to
    ``device``.  Returns (models, state) for :func:`make_drive_fn`."""
    models = {
        "embedder": registry.load_wrapper("embedders", args.embedder)
        .get_net(args),
        "generator": registry.load_wrapper("generators", args.generator)
        .get_net(args),
    }
    identity = convert.load_drive_weights(
        ckpt_lib.load_arrays(args.checkpoint_path), models["embedder"],
        models["generator"])
    for name in models:
        models[name] = models[name].to(device).eval()
    state = {"finetune_embedding": torch.from_numpy(identity).to(device)}
    logger.info("Loaded fine-tuned checkpoint %s (iteration %d)",
                args.checkpoint_path, args.iteration)
    return models, state


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("checkpoint_path")
    parser.add_argument("data_root_positional", nargs="?", metavar="DATA_ROOT")
    parser.add_argument("--data_root", default=None)
    parser.add_argument("--img_dir", default=None)
    parser.add_argument("--images_paths", nargs="+", default=[])
    parser.add_argument("--destination", default="driving_results")
    parser.add_argument("--drive_batch_size", type=int, default=32)
    parser.add_argument("--compute_dtype", default=None,
                        choices=["float32", "bfloat16"])
    parser.add_argument("--num_devices", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to drive on")
    # accepted for the JAX CLI's surface; refused below until ported
    parser.add_argument("--crop", action=argparse.BooleanOptionalAction,
                        default=False)
    parser.add_argument("--quantize", default="",
                        choices=["", "int8", "int8_static"])
    parser.add_argument("--calibration_frames", type=int, default=64)
    return parser


def resolve_args(argv=None):
    """CLI flags over the checkpoint's saved args, with drive's overrides."""
    cli = build_parser().parse_args(argv)
    if not os.path.exists(os.path.join(cli.checkpoint_path, "meta.json")):
        raise FileNotFoundError(
            f"Checkpoint `{cli.checkpoint_path}` not found — drive needs a "
            "fine-tuned checkpoint")
    args = types.SimpleNamespace(**ckpt_lib.peek_args(cli.checkpoint_path))
    cli.data_root = cli.data_root or cli.data_root_positional
    del cli.data_root_positional
    for key, value in vars(cli).items():
        if value is not None:
            setattr(args, key, value)
    args.finetune = True
    args.inference = True
    if cli.compute_dtype is None:
        args.compute_dtype = "bfloat16"    # serving default
    if args.crop:
        raise NotImplementedError(
            "--crop is not ported to PyTorch yet (it needs the face "
            "detector: ROADMAP.md queue A, eval / preprocess nets); pre-crop "
            "the footage or drive it with the JAX package's drive.py")
    if args.quantize:
        raise NotImplementedError(
            f"--quantize {args.quantize} is not ported to PyTorch yet "
            "(ROADMAP.md queue A, int8 serving)")
    if (getattr(args, "num_devices", 0) or 1) > 1:
        raise NotImplementedError(
            f"--num_devices {args.num_devices}: multi-device drive is not "
            "ported to PyTorch yet (ROADMAP.md queue A, distributed); pass "
            "--num_devices 1")
    return args


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = resolve_args(argv)
    models, state = load_finetuned(args, torch.device(args.device))
    drive_fn = drive_lib.make_drive_fn(models, args)

    os.makedirs(args.destination, exist_ok=True)
    results = []
    for images_path in args.images_paths:
        # driver dirs are relative to <data_root>/<img_dir> when given
        resolved = images_path
        if args.data_root and not str(images_path).startswith("synthetic"):
            candidate = (Path(args.data_root)
                         / getattr(args, "img_dir", "images-cropped")
                         / images_path)
            if candidate.exists():
                resolved = candidate
        frames = load_driver_frames(resolved, args.image_size)
        outputs = drive_lib.drive_sequence(
            drive_fn, state, frames, batch_size=args.drive_batch_size)

        name = str(images_path).replace("://", "_").replace("/", "_")
        dest = Path(args.destination) / f"{name}.mp4"
        writer = get_image_writer(dest)
        for driver, result in zip(frames, outputs):
            if driver.dtype == np.uint8:
                driver = driver.astype(np.float32) / 255.0
            writer.add(to_uint8(np.concatenate([driver, result], axis=1)))
        writer.close()
        logger.info("Wrote %s (%d frames)", dest, len(frames))
        results.append(dest)
    return results


if __name__ == "__main__":
    main()
