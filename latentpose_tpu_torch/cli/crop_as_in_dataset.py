"""Crop faces as the dataset does (port of
``latentpose_tpu/cli/crop_as_in_dataset.py``, the same flags):

    python -m latentpose_tpu_torch.cli.crop_as_in_dataset SOURCE DEST \
        [--save-landmarks --landmarks-dir DIR] [--bboxes_npy BOXES.npy] \
        [--weights_dir DIR] [--device cpu]

SOURCE: a folder of frames, a video file (needs cv2) or one image.  DEST: a
folder, or a video file (``.mp4``, ``.avi``, ``.mkv``).  Boxes come from
``--bboxes_npy`` ({frame stem: LTRB pixels}) or from S³FD (``s3fd.npz``);
landmarks from FAN (``fan_2d.npz``), one ``.npy`` a frame.  Crops are
written as PNG through the port's own encoder (the JAX package writes JPEG
at quality 95 through PIL; the dataset reads either).  Frames of one size
go through the nets and the C++ crop in batches of ``--batch_size``.
``--crop-style ffhq`` crops the FFHQ quad of FAN's landmarks instead
(``preprocess/croppers.py`` ``FFHQFaceCropper``, on ``--device``); it
takes no boxes.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from latentpose_tpu_torch.preprocess.croppers import make_cropper
from latentpose_tpu_torch.preprocess.readers import ImageReader
from latentpose_tpu_torch.utils.png import write_png
from latentpose_tpu_torch.utils.video import get_image_writer

logger = logging.getLogger("latentpose_tpu_torch.crop_as_in_dataset")

VIDEO_SUFFIXES = (".mp4", ".avi", ".mkv")


def batches_of(reader, size):
    """(frames (N, H, W, 3), names) chunks of at most ``size`` consecutive
    frames of one size."""
    frames, names = [], []
    for image, name in reader:
        if frames and (len(frames) == size or image.shape != frames[0].shape):
            yield np.stack(frames), names
            frames, names = [], []
        frames.append(image)
        names.append(name)
    if frames:
        yield np.stack(frames), names


def crop_sequence(cropper, source, destination, save_landmarks=False,
                  landmarks_dir=None, bboxes=None, batch_size=32):
    """Crop every frame of ``source`` into ``destination`` (a folder of
    ``<stem>.png`` or a video); landmarks to ``landmarks_dir/<stem>.npy``.
    Returns the number of frames."""
    reader = ImageReader.get_image_reader(source)
    dest = Path(destination)
    is_video = dest.suffix.lower() in VIDEO_SUFFIXES
    writer = get_image_writer(dest) if is_video else None
    if not is_video:
        dest.mkdir(parents=True, exist_ok=True)
    lm_dir = Path(landmarks_dir) if landmarks_dir else None
    if save_landmarks and lm_dir:
        lm_dir.mkdir(parents=True, exist_ok=True)
    bboxes = bboxes or {}
    count = 0
    for frames, names in batches_of(reader, batch_size):
        crops, landmarks = cropper.crop_images(
            frames, [bboxes.get(name) for name in names],
            compute_landmarks=save_landmarks)
        for i, name in enumerate(names):
            if is_video:
                writer.add(crops[i])
            else:
                write_png(dest / f"{name}.png", crops[i])
            if save_landmarks and lm_dir is not None \
                    and landmarks is not None:
                np.save(lm_dir / f"{name}.npy", landmarks[i])
        count += len(names)
    if writer:
        writer.close()
    logger.info("Cropped %d frames -> %s", count, dest)
    return count


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("source")
    parser.add_argument("destination")
    parser.add_argument("--crop-style", default="latentpose",
                        choices=["latentpose", "ffhq"])
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--save-landmarks", action="store_true")
    parser.add_argument("--landmarks-dir", type=str, default="")
    parser.add_argument("--weights_dir", type=str, default="data/weights")
    parser.add_argument("--bboxes_npy", type=str, default="",
                        help="Optional precomputed bbox dict (skip S3FD)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the detector and landmarks")
    parser.add_argument("--batch_size", type=int, default=32,
                        help="frames a batch through the nets and the crop")
    return parser


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    cropper = make_cropper(args.crop_style,
                           (args.image_size, args.image_size),
                           weights_dir=args.weights_dir, device=args.device)
    bboxes = {}
    if args.bboxes_npy:
        bboxes = np.load(args.bboxes_npy, allow_pickle=True).item()
    try:
        return crop_sequence(cropper, args.source, args.destination,
                             args.save_landmarks, args.landmarks_dir, bboxes,
                             args.batch_size)
    finally:
        cropper.close()


if __name__ == "__main__":
    main()
