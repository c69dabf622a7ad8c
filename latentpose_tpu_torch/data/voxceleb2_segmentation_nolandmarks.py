"""Flagship dataset: VoxCeleb2 + segmentation, no landmarks (port of
``latentpose_tpu/data/voxceleb2_segmentation_nolandmarks.py``).

- one sample = one video: K+1 frames -> K ``enc_rgbs`` + 1 driver;
- the bbox of each frame from the precomputed per-(identity, sequence,
  frame) ``.npy`` dict, squared and x1.8; no file -> the frames are taken
  as pre-cropped;
- the VoxCeleb2.1 1px gray-border strip before cropping, then the crop with
  blur-faded padding; every frame and mask is decoded, cropped and resized
  in C++ (``data/native_loader.py``), where the JAX package takes cv2 for
  the driver frame and the mask;
- segmentation from the PNG's channel 1 or a ``.png.npy`` array;
- target = image * segmentation;
- fine-tune branch: one image serves as identity, driver and target,
  label 0;
- augmentation runs on the device inside the train step
  (``data/augmentation.py``): the host loader only decodes and crops.

Frame draws: a training sample draws its frames from a ``random.Random``
keyed on (seed, epoch, index) (:func:`frame_key`); the JAX package draws
them from the global ``random`` inside a thread pool, so its draws depend
on thread order.  The val part and the fixed probes draw deterministically
(``random.Random(666)`` over the sorted listing), as the JAX package does.

Keys emitted (NHWC, f32): enc_rgbs (K, H, W, 3), pose_input_rgbs
(1, H, W, 3), target_rgbs (1, H, W, 3), real_segm (1, H, W, 1), label ().
With ``--transfer_dtype uint8`` (the wire) the images, masks and target are
uint8 from the C++ pool on: the float values as uint8(v * 255 + 0.5), the
target floor(i * s / 255 + 0.5) of the uint8 image and mask, as the JAX
dataset computes them.
"""

from __future__ import annotations

import logging
import random
import threading
from pathlib import Path

import numpy as np

from latentpose_tpu_torch.data import native_loader
from latentpose_tpu_torch.data.common import crop as crop_lib
from latentpose_tpu_torch.data.common import voxceleb
from latentpose_tpu_torch.data.pipeline import BatchLoader

logger = logging.getLogger("latentpose_tpu_torch.data.voxceleb2_segm_nolm")


class Wrapper:
    @staticmethod
    def get_dataloader(args, part, phase="train"):
        dirlist = voxceleb.get_part_data(args, part)
        loader = SegmSampleLoader(
            args.data_root, img_dir=args.img_dir, segm_dir=args.segm_dir,
            bboxes_dir=args.bboxes_dir, deterministic=part != "train",
            wire_dtype=args.transfer_dtype)
        dataset = VoxCeleb2SegmDataset(
            dirlist, loader, bool(args.inference), args.n_frames_for_encoder,
            args.image_size, seed=args.random_seed)
        return BatchLoader(
            dataset, batch_size=args.batch_size,
            shuffle=phase == "train", seed=args.random_seed,
            num_workers=args.num_workers, prefetch_size=args.prefetch_size,
            drop_last=phase == "train")


class SegmSampleLoader(voxceleb.SampleLoader):
    """Adds the bbox crop and the segmentation to the frame sampler;
    ``wire_dtype`` 'uint8' loads images and masks as the wire's bytes."""

    def __init__(self, data_root, img_dir=None, segm_dir=None,
                 bboxes_dir=None, deterministic=False, wire_dtype="float32"):
        super().__init__(data_root, img_dir, deterministic=deterministic,
                         wire_dtype=wire_dtype)
        self.segm_dir = segm_dir
        self.dtype = {"float32": np.float32, "uint8": np.uint8}[wire_dtype]
        try:
            # the preprocessing's dict {identity: {sequence: (N, 4)}}
            self.bboxes = np.load(str(bboxes_dir), allow_pickle=True).item()
        except (FileNotFoundError, OSError):
            self.bboxes = {}
            logger.warning("No bboxes .npy found at %r; assuming images are "
                           "already cropped", str(bboxes_dir))
        self._native = None
        self._native_lock = threading.Lock()

    @property
    def native(self):
        """The C++ pool, made at first use (the batch loader's threads share
        it)."""
        with self._native_lock:
            if self._native is None:
                self._native = native_loader.NativeBatchLoader()
            return self._native

    def _bbox_for(self, path, i):
        """[0, 1]-space (l, t, r, b), squared and x1.8-scaled, and whether
        it is known; the identity box for pre-cropped frames."""
        try:
            identity, sequence = str(path).split("/")[-2:]
            raw = self.bboxes[identity][sequence][int(i)]
            l, t, r, b = (raw / 256.0).tolist()
        except (KeyError, ValueError, IndexError):
            return (0.0, 0.0, 1.0, 1.0), False
        return crop_lib.square_and_scale_bbox(l, t, r, b), True

    def _boxes(self, path, ids):
        boxes, flags = zip(*(self._bbox_for(path, i) for i in ids))
        return np.asarray(boxes, np.float64), np.asarray(flags, np.uint8)

    def load_images(self, path, ids, imsize):
        """(N, imsize, imsize, 3) f32 (or the wire's uint8): frames ``ids``
        of one sequence, decoded, cropped and resized in one call of the
        C++ pool."""
        boxes, flags = self._boxes(path, ids)
        images, failed = self.native.load_cropped(
            [self.resolve_image(path, i) for i in ids], boxes, flags, imsize,
            self.dtype)
        if failed:   # their slots are zeros
            logger.error("%d/%d frames failed to load under %s", failed,
                         len(ids), path)
        return images

    def load_segm(self, path, ids, imsize):
        """(N, imsize, imsize, 1) f32 (or the wire's uint8): the masks of
        frames ``ids``, from ``<i>.png`` (channel 1) or ``<i>.png.npy``
        (channel 0)."""
        base = Path(self.data_root) / self.segm_dir / path
        boxes, flags = self._boxes(path, ids)
        out = np.empty((len(ids), imsize, imsize, 1), self.dtype)
        for n, i in enumerate(ids):
            png, npy = base / (i + ".png"), base / (i + ".png.npy")
            if png.exists():
                masks, failed = self.native.load_segm(
                    [png], boxes[n:n + 1], flags[n:n + 1], imsize, self.dtype)
                if failed:
                    logger.critical("Couldn't load segmentation %s", png)
                out[n, ..., 0] = masks[0]
            elif npy.exists():
                out[n, ..., 0] = self.native.crop_segm(
                    np.load(str(npy))[:, :, 0], boxes[n], flags[n], imsize,
                    self.dtype)
            else:
                raise FileNotFoundError(f"Sample {png} not found")
        return out

    def load_sample(self, path, i, imsize, load_image=False,
                    load_segmentation=False):
        """{'image': (H, W, 3), 'segmentation': (H, W, 1)} of frame i."""
        out = {}
        if load_image:
            out["image"] = self.load_images(path, [i], imsize)[0]
        if load_segmentation:
            out["segmentation"] = self.load_segm(path, [i], imsize)[0]
        return out


def masked_target(image, segm):
    """target = image * segmentation, in the wire's dtype: uint8 inputs give
    floor(i * s / 255 + 0.5) in f32 (the JAX dataset's ``_masked_target``),
    f32 ones their product."""
    if image.dtype == np.uint8:
        return np.floor(image.astype(np.float32) * segm.astype(np.float32)
                        / 255.0 + 0.5).astype(np.uint8)
    return image * segm


def frame_key(seed: int, epoch: int, index: int) -> int:
    """The seed of the ``random.Random`` that draws sample ``index``'s
    frames in epoch ``epoch`` of a run seeded ``seed``."""
    return (seed * 1_000_003 + epoch) * 1_000_003 + index


class VoxCeleb2SegmDataset(voxceleb.VoxCeleb2DatasetBase):
    def __init__(self, dirlist, loader, inference, n_frames_for_encoder,
                 imsize, seed=0):
        super().__init__(dirlist, loader, inference, n_frames_for_encoder,
                         imsize)
        self.num_labels = 1 if dirlist.finetuning else len(dirlist)
        self.seed = seed
        self.epoch = 0      # set by the BatchLoader

    def __getitem__(self, index):
        return self.get(index)

    def pose_input(self, path, frame, images):
        """The driver's ``pose_input_rgbs`` (1, H, W, 3): its crop
        ``images`` (the mixed-crop dataset takes another)."""
        return images

    def get(self, index, deterministic=False):
        """Sample ``index`` as (data_dict, target_dict); ``deterministic``
        (or a deterministic loader) draws the frames with seed 666."""
        index = int(index)
        data_dict, target_dict = {}, {}
        path = self.dirlist.paths[index]

        if self.dirlist.finetuning:
            sample = self.loader.load_sample(
                path, self.dirlist.files[index], self.imsize,
                load_image=True, load_segmentation=not self.inference)
            image = sample["image"][None]            # (1, H, W, 3)
            data_dict["enc_rgbs"] = image
            data_dict["pose_input_rgbs"] = self.pose_input(
                path, self.dirlist.files[index], image)
            if not self.inference:
                segm = sample["segmentation"][None]
                data_dict["target_rgbs"] = masked_target(image, segm)
                target_dict["real_segm"] = segm
            target_dict["label"] = 0
        else:
            rng = None if deterministic else random.Random(
                frame_key(self.seed, self.epoch, index))
            ids = self.loader.list_ids(path, self.n_frames_for_encoder + 1,
                                       rng)
            images = self.loader.load_images(path, ids, self.imsize)
            data_dict["enc_rgbs"] = images[:-1]
            data_dict["pose_input_rgbs"] = self.pose_input(path, ids[-1],
                                                           images[-1:])
            if not self.inference:
                segm = self.loader.load_segm(path, ids[-1:], self.imsize)
                data_dict["target_rgbs"] = masked_target(images[-1:], segm)
                target_dict["real_segm"] = segm
            target_dict["label"] = index

        return data_dict, target_dict
