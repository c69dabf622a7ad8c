"""Drive entry point of the PyTorch port (port of ``latentpose_tpu/cli/drive.py``).

Loads a fine-tuned checkpoint written by either package (EMA weights), then
renders the avatar side by side with each driver sequence into an mp4:

    python -m latentpose_tpu_torch.cli.drive CHECKPOINT_PATH [DATA_ROOT] \
        --images_paths dir_or_video [...] --destination out_dir

Driver sources: a directory of images, a video file, or ``synthetic://K``
(procedural driver identity K).  The model args come from the checkpoint's
``meta.json``; flags given here override them.  Compute runs in bf16 unless
``--compute_dtype`` is given.

``--quantize int8`` runs the generator's block convs in int8 with a dynamic
activation scale; ``--quantize int8_static`` with scales calibrated on the
first driver sequence's leading ``--calibration_frames`` frames, then used
for every sequence (``ops/quant.py``).  Both are approximate (the JAX
package gates them at 40 dB PSNR against the exact path).

``--num_devices N`` drives on N devices, one process (rank) each: the CLI
starts the N local ranks itself, or under torchrun each process joins the
group it is given.  Batch k of a sequence goes whole to rank k mod N, so
each batch (the int8 path's dynamic scale included) is what one process
drives; rank 0 receives the others' batches in order and writes the video,
which equals a one-process run's frame for frame.  ``int8_static``
calibrates on rank 0 and hands every rank its scales.

``--crop`` drives raw footage (a directory of frames, or a video with cv2):
each frame is cropped as the dataset crops it (:func:`inline_crop_frames`),
its box from the ``--bboxes_dir`` dict or from S³FD (``s3fd.npz`` under
``$LATENTPOSE_WEIGHTS_DIR`` or ``<repo>/weights/``).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import types
from pathlib import Path

import numpy as np
import torch

from latentpose_tpu_torch import checkpoint as ckpt_lib
from latentpose_tpu_torch import convert, registry
from latentpose_tpu_torch.data.common import crop as crop_lib
from latentpose_tpu_torch.data.common.voxceleb import IMAGE_EXTENSIONS
from latentpose_tpu_torch.data import native_loader
from latentpose_tpu_torch.parallel import launch
from latentpose_tpu_torch.parallel import mesh as parallel
from latentpose_tpu_torch.runners import drive as drive_lib
from latentpose_tpu_torch.utils.video import get_image_writer, to_uint8

logger = logging.getLogger("latentpose_tpu_torch.drive")


def load_driver_frames(path, image_size):
    """A driver sequence as (N, H, W, 3): float32 in [0, 1] for an image
    directory (decoded and resized bilinearly by the port's C++ loader,
    ``data/native_loader.py``, as the JAX package's does) and for
    ``synthetic://K`` (32 frames); uint8 for a video file, decoded with cv2
    (the wire format, rescaled on the device)."""
    if str(path).startswith("synthetic://"):
        from latentpose_tpu_torch.data.synthetic import render_face
        label = int(str(path).split("://", 1)[1])
        return np.stack([render_face(label, f, image_size)[0]
                         for f in range(32)])

    path = Path(path)
    if path.is_dir():
        files = sorted(p for p in path.iterdir()
                       if p.suffix.lower() in IMAGE_EXTENSIONS)
        if not files:
            raise FileNotFoundError(f"No frames found in {path}")
        loader = native_loader.NativeBatchLoader()
        try:
            images, failed = loader.load(files, image_size)
        finally:
            loader.close()
        if failed:
            raise RuntimeError(f"{failed} of {len(files)} images in {path} "
                               "failed to decode")
        return images
    import cv2
    frames = []
    cap = cv2.VideoCapture(str(path))
    while True:
        ok, img = cap.read()
        if not ok:
            break
        frames.append(cv2.resize(img[..., ::-1], (image_size, image_size)))
    cap.release()
    if not frames:
        raise FileNotFoundError(f"No frames found in {path}")
    return np.stack(frames)


def load_raw_frames(path):
    """A driver sequence at its own resolution: (frames, ids), uint8 RGB
    arrays and each frame's id (its stem when numeric, the bbox dict's key,
    else its position).  A directory decodes through the C++ loader, a
    video through cv2."""
    path = Path(path)
    frames, ids = [], []
    if path.is_dir():
        files = sorted(p for p in path.iterdir()
                       if p.suffix.lower() in IMAGE_EXTENSIONS)
        for idx, p in enumerate(files):
            frames.append(native_loader.decode(p))
            ids.append(int(p.stem) if p.stem.isdigit() else idx)
    else:
        import cv2
        cap = cv2.VideoCapture(str(path))
        while True:
            ok, img = cap.read()
            if not ok:
                break
            ids.append(len(frames))
            frames.append(img[..., ::-1].copy())
        cap.release()
    if not frames:
        raise FileNotFoundError(f"No frames found in {path}")
    return frames, ids


def load_bboxes(path):
    """The dataset's per-frame bbox dict at ``path``, or {} where there is
    none."""
    try:
        return np.load(str(path), allow_pickle=True).item()
    except (FileNotFoundError, OSError, ValueError):
        return {}


def inline_crop_frames(path, args, detector=None):
    """Raw driver footage cropped as the inference dataloader crops it (port
    of ``latentpose_tpu/cli/drive.py`` ``inline_crop_frames``): each frame's
    box from the ``args.bboxes_dir`` dict ([identity][sequence][frame],
    256-space LTRB), else from ``detector`` (S³FD: ``s3fd.npz`` where the
    weights are searched, when the dict is empty), else the whole frame ->
    square x1.8 -> integer box -> the blur-faded padded crop -> INTER_CUBIC
    (when ``args.image_size`` exceeds the crop's height) or INTER_AREA to
    ``args.image_size``², in C++.  Returns (N, S, S, 3) uint8, the wire
    format drive rescales on the device."""
    from latentpose_tpu_torch.preprocess.croppers import (
        choose_one_detection, make_face_detector)

    frames, frame_ids = load_raw_frames(path)
    bboxes = load_bboxes(args.bboxes_dir)
    identity, sequence = (["", ""] + str(path).rstrip("/").split("/"))[-2:]
    if not bboxes and detector is None:
        detector = make_face_detector(None, args.device)
        if detector is None:
            raise RuntimeError(
                "--crop needs per-frame bboxes: provide --bboxes_dir "
                "(precomputed .npy dict, the dataset contract) or converted "
                "S3FD weights (see WEIGHTS.md). Alternatively pre-crop with "
                "cli/crop_as_in_dataset.py and drive without --crop.")

    ltrb = [None] * len(frames)
    for i, idx in enumerate(frame_ids):
        try:
            raw = bboxes[identity][sequence][idx]
            ltrb[i] = (np.asarray(raw, np.float32) / 256.0).tolist()
        except (KeyError, ValueError, IndexError):
            pass
    # the frames without a box: through the detector, a batch a size
    todo = [i for i in range(len(frames)) if ltrb[i] is None]
    for shape in sorted({frames[i].shape for i in todo}):
        group = [i for i in todo if frames[i].shape == shape]
        h, w = shape[:2]
        if detector is None:
            found = [[0.0, 0.0, 1.0, 1.0]] * len(group)  # pre-cropped
        else:
            found = [[v / s for v, s in zip(
                choose_one_detection(faces)[:4], (w, h, w, h))]
                for faces in detector(np.stack([frames[i] for i in group]))]
        for i, box in zip(group, found):
            ltrb[i] = box

    size = args.image_size
    out = np.empty((len(frames), size, size, 3), np.uint8)
    loader = native_loader.NativeBatchLoader()
    try:
        for shape in sorted({f.shape for f in frames}):
            group = [i for i, f in enumerate(frames) if f.shape == shape]
            h, w = shape[:2]
            boxes = []
            for i in group:
                l, t, r, b = ltrb[i]
                if (l, t, r, b) == (0.0, 0.0, 1.0, 1.0):
                    boxes.append((0, 0, h, w))
                else:
                    l, t, r, b = crop_lib.square_and_scale_bbox(l, t, r, b)
                    boxes.append(crop_lib.bbox_to_integer_coords(
                        t, l, b, r, h, w))
            cubic = [size > b - t for t, _, b, _ in boxes]
            out[group] = loader.crop_boxes(
                np.stack([frames[i] for i in group]), boxes, cubic, size)
    finally:
        loader.close()
    return out


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
    parser.add_argument("--quantize", default="",
                        choices=["", "int8", "int8_static"])
    parser.add_argument("--calibration_frames", type=int, default=64,
                        help="int8_static: how many leading driver frames "
                             "feed the calibration pass")
    parser.add_argument("--crop", action=argparse.BooleanOptionalAction,
                        default=False,
                        help="crop raw driver footage as the dataset does")
    parser.add_argument("--bboxes_dir", default=None,
                        help="--crop: the per-frame bbox .npy dict "
                             "(default: the checkpoint's)")
    return parser


def resolve_args(argv=None):
    """CLI flags over the checkpoint's saved args, with drive's overrides."""
    cli = build_parser().parse_args(argv)
    cli.data_root = cli.data_root or cli.data_root_positional
    del cli.data_root_positional
    return inference_args(cli, "drive")


def inference_args(cli, what):
    """The parsed flags ``cli`` (with ``checkpoint_path``) over the
    checkpoint's saved args, with the inference overrides of drive and
    export (the reference's ``drive.py:48-59``): fine-tune and inference
    on, bf16 compute unless ``--compute_dtype`` was given; ``--num_devices``
    checked against the visible devices (drive), or 1 (export: the
    exported program is single-device)."""
    if not os.path.exists(os.path.join(cli.checkpoint_path, "meta.json")):
        raise FileNotFoundError(
            f"Checkpoint `{cli.checkpoint_path}` not found — {what} needs a "
            "fine-tuned checkpoint")
    args = types.SimpleNamespace(**ckpt_lib.peek_args(cli.checkpoint_path))
    for key, value in vars(cli).items():
        if value is not None:
            setattr(args, key, value)
    args.finetune = True
    args.inference = True
    if cli.compute_dtype is None:
        args.compute_dtype = "bfloat16"    # serving default
    # a checkpoint converted from the reference's may lack these
    for key, default in (("bboxes_dir", "/non/existent/file"),
                         ("data_root", None), ("num_devices", 0)):
        if not hasattr(args, key):
            setattr(args, key, default)
    if what == "export":
        args.num_devices = 1
    world = parallel.requested_world(args.num_devices)
    if world > 1 and not parallel.launched():
        parallel.check_devices(torch.device(args.device).type, world)
    return args


def main(argv=None):
    """Drive as the flags say; returns the videos written (under N ranks:
    rank 0's, on every rank)."""
    logging.basicConfig(level=logging.INFO)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = resolve_args(argv)
    world = parallel.requested_world(args.num_devices)
    if world > 1 and not parallel.launched():
        return launch.run("latentpose_tpu_torch.cli.drive", argv, world)
    device = torch.device(args.device)
    joined = parallel.launched() and not parallel.initialized()
    if joined:
        device = parallel.init_process_group(device)
    try:
        return _drive(args, device)
    finally:
        if joined:
            parallel.destroy_process_group()


def _drive(args, device):
    main_rank = parallel.is_main()
    models, state = load_finetuned(args, device)
    # int8_static: the drive fn is built after calibrating on the first
    # sequence's leading frames
    drive_fn = None if args.quantize == "int8_static" else \
        drive_lib.make_drive_fn(models, args)
    # --crop without a bbox dict: one S3FD for every sequence
    detector = None
    if args.crop and not load_bboxes(args.bboxes_dir):
        from latentpose_tpu_torch.preprocess.croppers import \
            make_face_detector
        detector = make_face_detector(None, args.device)

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
        if args.crop and not str(resolved).startswith("synthetic"):
            frames = inline_crop_frames(resolved, args, detector)
        else:
            frames = load_driver_frames(resolved, args.image_size)
        if drive_fn is None:
            calib_frames = frames[:max(args.calibration_frames, 1)]
            if calib_frames.dtype == np.uint8:
                calib_frames = calib_frames.astype(np.float32) / 255.0
            calib = drive_lib.calibrate_quant_scales(
                models, args, state, calib_frames,
                batch_size=args.drive_batch_size) if main_rank else \
                drive_lib.empty_quant_calib(models)
            for scale in calib.values():        # rank 0's, on every rank
                parallel.broadcast_tensor(scale)
            logger.info("int8_static: calibrated activation scales on %d "
                        "frames (%d quantized convs)", len(calib_frames),
                        len(calib))
            drive_fn = drive_lib.make_drive_fn(models, args,
                                               quant_calib=calib)
        outputs = drive_lib.drive_sequence(
            drive_fn, state, frames, batch_size=args.drive_batch_size)

        name = str(images_path).replace("://", "_").replace("/", "_")
        dest = Path(args.destination) / f"{name}.mp4"
        results.append(dest)
        if not main_rank:
            continue
        writer = get_image_writer(dest)
        for driver, result in zip(frames, outputs):
            if driver.dtype == np.uint8:
                driver = driver.astype(np.float32) / 255.0
            writer.add(to_uint8(np.concatenate([driver, result], axis=1)))
        writer.close()
        logger.info("Wrote %s (%d frames)", dest, len(frames))
    parallel.barrier()          # every video is written
    return results


if __name__ == "__main__":
    main()
