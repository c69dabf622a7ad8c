"""Dataset preprocessing (port of ``latentpose_tpu/cli/preprocess_dataset.py``,
the same flags), in stages:

  1. ``--do_decode_videos``: every video under ``--raw_videos_dir`` -> a
     folder of JPEG frames, through ``ffmpeg`` on PATH;
  2. ``--do_crop``: every folder of frames under ``--raw_images_dir``,
     cropped latentpose-style (S³FD, ``s3fd.npz``) with FAN landmarks
     (``fan_2d.npz``) -> ``images-cropped/`` (PNG) and ``keypoints-cropped/``;
  3. ``--do_compute_segmentation``: Graphonomy masks (``graphonomy.npz``,
     test-time scales 0.75 / 1.0 / 1.5 / 2.0) of every crop ->
     ``segmentation-cropped/`` (3-channel PNG);
  4. ``--do_compute_pose_3dmm``: an external estimator command;
  5. ``--do_crop_ffhq``: every folder of frames cropped FFHQ-style from FAN's
     landmarks -> ``images-cropped-ffhq/`` and ``keypoints-cropped-ffhq/``.

The tree is what ``voxceleb2_segmentation_nolandmarks`` reads.  The nets
(and the FFHQ crop) run on ``--device`` (``cuda`` unless ``cpu`` is
given).

    python -m latentpose_tpu_torch.cli.preprocess_dataset --data_root ROOT \
        --do_crop --do_compute_segmentation --weights_dir DIR
"""

from __future__ import annotations

import argparse
import logging
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from latentpose_tpu_torch.cli.crop_as_in_dataset import (batches_of,
                                                         crop_sequence)
from latentpose_tpu_torch.preprocess.readers import (IMAGE_EXTENSIONS,
                                                     FolderReader)
from latentpose_tpu_torch.utils.png import write_png

logger = logging.getLogger("latentpose_tpu_torch.preprocess_dataset")

VIDEO_EXTENSIONS = (".mp4", ".avi", ".mkv", ".webm", ".mov")


def decode_videos(src_root: Path, dst_root: Path, fps: float = 0):
    """Stage 1: every video under src_root -> a folder of JPEG frames."""
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg not found on PATH")
    count = 0
    for video in sorted(src_root.rglob("*")):
        if video.suffix.lower() not in VIDEO_EXTENSIONS:
            continue
        out_dir = dst_root / video.relative_to(src_root).with_suffix("")
        out_dir.mkdir(parents=True, exist_ok=True)
        cmd = ["ffmpeg", "-y", "-loglevel", "error", "-i", str(video)]
        if fps:
            cmd += ["-vf", f"fps={fps}"]
        cmd += ["-qscale:v", "2", str(out_dir / "%06d.jpg")]
        subprocess.run(cmd, check=True)
        count += 1
    logger.info("Decoded %d videos", count)


def _frame_folders(root: Path):
    """Every folder under ``root`` that holds frames, sorted."""
    for folder in sorted(p for p in root.rglob("*") if p.is_dir()):
        if any(f.suffix.lower() in IMAGE_EXTENSIONS
               for f in folder.iterdir()):
            yield folder


def crop_identities(images_root: Path, out_images: Path, out_keypoints,
                    cropper, batch_size=32):
    """Stage 2: crop every identity/video folder of frames (landmarks into
    ``out_keypoints`` unless it is None)."""
    for folder in _frame_folders(images_root):
        rel = folder.relative_to(images_root)
        crop_sequence(cropper, folder, out_images / rel,
                      save_landmarks=out_keypoints is not None,
                      landmarks_dir=(None if out_keypoints is None
                                     else out_keypoints / rel),
                      batch_size=batch_size)


def compute_segmentation(images_root: Path, out_root: Path, backend,
                         batch_size=32):
    """Stage 3: a mask for every cropped frame (test-time scales), written
    as a 3-channel PNG of 0 and 255."""
    from latentpose_tpu_torch.preprocess.segmentation import segment_with_tta
    for folder in _frame_folders(images_root):
        out_dir = out_root / folder.relative_to(images_root)
        out_dir.mkdir(parents=True, exist_ok=True)
        for frames, names in batches_of(FolderReader(folder), batch_size):
            masks = segment_with_tta(backend, frames)
            for mask, name in zip(masks, names):
                mask_u8 = (mask * 255).astype(np.uint8)
                write_png(out_dir / f"{name}.png",
                          np.stack([mask_u8] * 3, axis=-1))


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data_root", type=Path, required=True)
    parser.add_argument("--raw_videos_dir", type=str, default="")
    parser.add_argument("--raw_images_dir", type=str, default="images-raw")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--weights_dir", type=str, default="data/weights")
    parser.add_argument("--do_decode_videos", action="store_true")
    parser.add_argument("--do_crop", action="store_true")
    parser.add_argument("--do_compute_segmentation", action="store_true")
    parser.add_argument("--do_crop_ffhq", action="store_true")
    # the reference's 3DMM stage shells out to an external estimator
    parser.add_argument("--do_compute_pose_3dmm", action="store_true")
    parser.add_argument("--pose_3dmm_command", type=str, default="",
                        help="External command invoked as "
                             "'<cmd> <images_list_file> <output_dir>' to "
                             "produce per-frame 3DMM coefficient .npy files")
    parser.add_argument("--fps", type=float, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the nets")
    parser.add_argument("--batch_size", type=int, default=32,
                        help="frames a batch through the nets")
    return parser


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if args.do_compute_pose_3dmm and not args.pose_3dmm_command:
        raise SystemExit(
            "--do_compute_pose_3dmm needs --pose_3dmm_command: the "
            "reference's stage shells out to a private Expression-Net "
            "checkout (utils/preprocess_dataset.sh:148-165); provide "
            "an equivalent external estimator command")

    root = args.data_root
    if args.do_decode_videos:
        decode_videos(root / args.raw_videos_dir, root / args.raw_images_dir,
                      args.fps)
    if args.do_crop:
        from latentpose_tpu_torch.preprocess.croppers import make_cropper
        cropper = make_cropper("latentpose",
                               (args.image_size, args.image_size),
                               args.weights_dir, args.device)
        try:
            crop_identities(root / args.raw_images_dir,
                            root / "images-cropped",
                            root / "keypoints-cropped", cropper,
                            args.batch_size)
        finally:
            cropper.close()
    if args.do_compute_segmentation:
        from latentpose_tpu_torch.preprocess.segmentation import \
            make_segmentation_backend
        compute_segmentation(root / "images-cropped",
                             root / "segmentation-cropped",
                             make_segmentation_backend(args.weights_dir,
                                                       args.device),
                             args.batch_size)
    if args.do_compute_pose_3dmm:
        images = sorted(p for p in (root / "images-cropped").rglob("*")
                        if p.suffix.lower() in IMAGE_EXTENSIONS)
        with tempfile.NamedTemporaryFile("w", suffix=".txt",
                                         delete=False) as f:
            f.write("\n".join(str(p) for p in images))
            list_file = f.name
        out_dir = root / "pose-3dmm"
        out_dir.mkdir(parents=True, exist_ok=True)
        subprocess.run(args.pose_3dmm_command.split()
                       + [list_file, str(out_dir)], check=True)
    if args.do_crop_ffhq:
        from latentpose_tpu_torch.preprocess.croppers import make_cropper
        cropper = make_cropper("ffhq", (args.image_size, args.image_size),
                               args.weights_dir, args.device)
        try:
            crop_identities(root / args.raw_images_dir,
                            root / "images-cropped-ffhq",
                            root / "keypoints-cropped-ffhq", cropper,
                            args.batch_size)
        finally:
            cropper.close()


if __name__ == "__main__":
    main()
