"""Evaluation harness of the PyTorch port (port of
``latentpose_tpu/cli/compute_pose_identity_error.py``; reference
``compute_pose_identity_error.py``).

For each of N test identities, read the N driving results that
``batched_drive`` wrote (driver | reenactment side by side), and compute

- the ArcFace descriptor of every reenactment (identity error, on
  cross-driving), against each identity's average descriptor over its
  ``identity`` frames (background erased with its segmentation);
- the 68 landmarks of the self-driven reenactments (pose reconstruction
  error), against those of the identity's ``driver`` frames;

with the same ``.npy`` caches, at the same paths, as the JAX CLI.  The
backends see the frames in the JAX harness's channel order (BGR, as cv2
reads them): the port decodes RGB and reverses the channels.  A driving
result is ``<driver>.mp4`` (read through cv2, where it imports) or the
``<driver>.mp4.frames/`` PNG directory the port's drive writes where no
video encoder imports.  A video's frames go through FAN and ArcFace as one
batch.

    python -m latentpose_tpu_torch.cli.compute_pose_identity_error \
        --results_root puppeteering/M --data_root <test-set root> \
        --identities_file identities.txt [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from latentpose_tpu_torch.data import native_loader
from latentpose_tpu_torch.eval import backends as backends_lib
from latentpose_tpu_torch.eval.metrics import (identity_error,
                                               pose_reconstruction_error)

logger = logging.getLogger("compute_pose_identity_error")

# The paper's 30-identity VoxCeleb2 test protocol (reference :217-248)
PAPER_IDENTITIES = [
    "id00061/cAT9aR8oFx0", "id00061/Df_m1slf_hY", "id00812/XoAi2n4S2wo",
    "id01106/B08yOvYMF7Y", "id01228/7qHTvs0VO68", "id01333/9kgJaduwKkY",
    "id01437/4lFDvxXzYWY", "id02057/s5VqJY7DDEE", "id02548/x2LUQEUXdz4",
    "id03127/uiRiyK8Qlic", "id03178/cCoNRuzAL-A", "id03178/fnARFfUwf2s",
    "id03524/GkvScYvOJ7o", "id03839/LhI_8AWX_Mg", "id03839/PUwanP-C5qg",
    "id03862/fsCqKQb9Rdg", "id04094/JUYMzfVp8zI", "id04950/PQEAck-3wcA",
    "id05459/3TI6dVmEwzw", "id05714/wFGNufaMbDY", "id06104/7UnGAS5-jpU",
    "id06811/KmvEwL3fP9Q", "id07312/h1dszoDi1E8", "id07663/54qlJ2HZ08s",
    "id07802/BfQUBDw7TiM", "id07868/JC0QT4oXh2Y", "id07961/464OHFffwjI",
    "id07961/hROZwL8pbGg", "id08149/vxBFGKGXSFA", "id08701/UeUyLqpLz70",
]


def string_to_valid_filename(x):
    return str(x).replace("/", "_")


def imread_bgr(path):
    """An image file as cv2.imread reads it: (H, W, 3) uint8 BGR (a grey
    image as three equal channels), or None where it is missing or does not
    decode."""
    try:
        return np.ascontiguousarray(native_loader.decode(path)[..., ::-1])
    except (FileNotFoundError, ValueError):
        return None


def read_reenactments(video_path, num_frames, image_size):
    """The first ``num_frames`` result halves (x >= image_size) of a
    side-by-side driving result, BGR: ``video_path`` through cv2, or its
    ``.frames/`` PNG directory."""
    frames_dir = Path(str(video_path) + ".frames")
    if not Path(video_path).exists() and frames_dir.is_dir():
        files = sorted(frames_dir.glob("*.png"))[:num_frames]
        assert len(files) == num_frames, frames_dir
        return [np.ascontiguousarray(imread_bgr(p)[:, image_size:])
                for p in files]
    from latentpose_tpu_torch.preprocess.readers import VideoReader
    reader = VideoReader(video_path)
    frames = [np.ascontiguousarray(image[:, image_size:, ::-1])  # RGB in
              for _, (image, _) in zip(range(num_frames), reader)]
    reader.cap.release()
    assert len(frames) == num_frames, video_path
    return frames


def compute_gt_descriptors(args, identities, descriptor_backend,
                           default_bbox, timer):
    cache = Path(args.results_root) / (
        "true_average_identity_descriptors_noBackground.npy"
        if args.erase_background
        else "true_average_identity_descriptors.npy")
    if cache.exists():
        logger.info("Loaded cached GT descriptors from %s", cache)
        return np.load(cache)

    gt = np.empty((len(identities), backends_lib.FACE_DESCRIPTOR_DIM),
                  np.float32)
    for row, identity in zip(gt, identities):
        img_dir = Path(args.data_root) / args.img_dir / identity / "identity"
        segm_dir = (Path(args.data_root) / args.segm_dir / identity
                    / "identity")
        images = []
        with timer("decode"):
            for p in sorted(img_dir.iterdir()):
                image = imread_bgr(p)
                if args.erase_background:
                    segm = imread_bgr(segm_dir / p.with_suffix(".png").name)
                    if segm is not None:
                        image = (image.astype(np.float32)
                                 * segm.astype(np.float32) / 255.0) \
                            .astype(np.uint8)
                images.append(image)
        descriptors, bad = descriptor_backend(images, default_bbox)
        if bad:
            logger.warning("couldn't detect %d faces in %s", bad, img_dir)
        row[:] = descriptors.mean(0)
    cache.parent.mkdir(parents=True, exist_ok=True)
    np.save(cache, gt)
    return gt


def compute_gt_landmarks(args, identities, landmark_backend, timer):
    cache = Path(args.results_root) / "target_landmarks.npy"
    if cache.exists():
        logger.info("Loaded cached GT landmarks from %s", cache)
        return np.load(cache)
    gt = np.empty((len(identities), args.num_frames, 68, 2), np.float32)
    for i, identity in enumerate(identities):
        img_dir = Path(args.data_root) / args.img_dir / identity / "driver"
        paths = sorted(img_dir.iterdir())[:args.num_frames]
        with timer("decode"):
            images = [imread_bgr(p) for p in paths]
        lm, ok = _landmarks(landmark_backend, images)
        if not ok:
            logger.warning("no landmarks in %s", img_dir)
        gt[i, :len(paths)] = lm
    np.save(cache, gt)
    return gt


def _landmarks(landmark_backend, images):
    """One batch for the frames of one size, else frame by frame."""
    if len({im.shape for im in images}) == 1:
        return landmark_backend(np.stack(images))
    found = [landmark_backend(im) for im in images]
    return np.stack([lm for lm, _ in found]), all(ok for _, ok in found)


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--results_root", type=Path, required=True)
    parser.add_argument("--data_root", type=Path, required=True)
    parser.add_argument("--img_dir", default="images-cropped")
    parser.add_argument("--segm_dir", default="segmentation-cropped")
    parser.add_argument("--identities", nargs="*", default=[])
    parser.add_argument("--identities_file", type=str, default="")
    parser.add_argument("--crop_type", default="latentpose",
                        choices=["latentpose", "ffhq", "x2face"])
    parser.add_argument("--erase_background", action="store_true",
                        default=True)
    parser.add_argument("--no-erase_background", dest="erase_background",
                        action="store_false")
    parser.add_argument("--num_frames", type=int, default=32)
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--eval_weights_dir", type=str, default="data/weights")
    parser.add_argument("--allow_proxy_eval", action="store_true",
                        help="Run with deterministic proxy backends when "
                             "ArcFace/FAN weights are absent (numbers not "
                             "paper-comparable; see WEIGHTS.md)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the backends")
    return parser


def main(argv=None, timer=None):
    """The three numbers, printed and returned; ``timer``
    (:class:`~latentpose_tpu_torch.eval.backends.StageTimer`) gets each
    stage's time."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    timer = timer or backends_lib.StageTimer()

    identities = list(args.identities)
    if args.identities_file:
        identities += [ln.strip() for ln in open(args.identities_file)
                       if ln.strip()]
    if not identities:
        identities = PAPER_IDENTITIES

    descriptor_backend = backends_lib.make_descriptor_backend(
        args.eval_weights_dir, allow_proxy=args.allow_proxy_eval,
        device=device, timer=timer)
    landmark_backend = backends_lib.make_landmark_backend(
        args.eval_weights_dir, allow_proxy=args.allow_proxy_eval,
        device=device, timer=timer)
    default_bbox = backends_lib.get_default_bbox(args.crop_type)

    gt_descriptors = compute_gt_descriptors(
        args, identities, descriptor_backend, default_bbox, timer)
    gt_landmarks = compute_gt_landmarks(args, identities, landmark_backend,
                                        timer)

    n, f = len(identities), args.num_frames
    our_landmarks = np.empty((n, f, 68, 2), np.float32)
    our_descriptors = np.empty(
        (n, n, f, backends_lib.FACE_DESCRIPTOR_DIM), np.float32)

    for i, identity in enumerate(identities):
        results_path = Path(args.results_root) / (
            string_to_valid_filename(identity) + "_identity")
        desc_cache = (results_path / "our_identity_descriptors"
                      / (string_to_valid_filename(identity) + ".npy"))
        lm_cache = (results_path / "our_landmarks"
                    / (string_to_valid_filename(identity) + ".npy"))

        need_desc, need_lm = True, True
        if desc_cache.exists():
            our_descriptors[i] = np.load(desc_cache)
            need_desc = False
        if lm_cache.exists():
            our_landmarks[i] = np.load(lm_cache)
            need_lm = False
        if not (need_desc or need_lm):
            continue

        for j, driver in enumerate(identities):
            video = (results_path / "driving-results"
                     / (string_to_valid_filename(driver) + "_driver.mp4"))
            with timer("decode"):
                reenacted = read_reenactments(video, f, args.image_size)
            if need_desc:
                descriptors, bad = descriptor_backend(reenacted,
                                                      default_bbox)
                if bad:
                    logger.warning("couldn't detect %d faces in %s", bad,
                                   video)
                our_descriptors[i, j] = descriptors
            if need_lm and i == j:
                our_landmarks[i], _ = _landmarks(landmark_backend, reenacted)
        if need_desc:
            desc_cache.parent.mkdir(parents=True, exist_ok=True)
            np.save(desc_cache, our_descriptors[i])
        if need_lm:
            lm_cache.parent.mkdir(parents=True, exist_ok=True)
            np.save(lm_cache, our_landmarks[i])

    with timer("metrics"):
        id_err = identity_error(gt_descriptors, our_descriptors)
        pose_err = pose_reconstruction_error(gt_landmarks, our_landmarks)
        pose_err_aligned = pose_reconstruction_error(
            gt_landmarks, our_landmarks, apply_optimal_alignment=True)
    print(f"Identity error: {id_err}")
    print(f"Pose reconstruction error: {pose_err}")
    print(f"Pose reconstruction error (with optimal alignment): "
          f"{pose_err_aligned}")
    return {"identity_error": id_err, "pose_reconstruction_error": pose_err,
            "pose_reconstruction_error_aligned": pose_err_aligned}


if __name__ == "__main__":
    main()
