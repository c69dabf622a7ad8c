"""X2Face-crop dataset (port of ``latentpose_tpu/data/voxceleb2_X2Face.py``):
the identity frames of the pre-cropped tree as they are, and the driver,
which is also the target, in the VoxCeleb1 crop that X2Face and FAb-Net
were trained on: the frame's bbox squared and scaled x1.4 (with
``--voxceleb1_crop_type fabnet`` then cut by FAb-Net's fixed
43/66/43/20-of-256 margins, l, t, r, b), cropped with the dataset's
blur-faded padding and resized bilinearly.  No segmentation, no landmarks.

- the identity frames: decoded by ``data/native_loader.py`` and resized as
  cv2 resizes them (``ops/resize.py``: cubic up, area down);
- the VoxCeleb1 crop (:func:`voxceleb1_crop`): the box of
  ``--bboxes_dir``'s dict (256-space l, t, r, b), or without one a fixed
  central box; the padded crop in C++ (``csrc/lpr_loader.cpp``, the
  dataset's crop), then cv2's INTER_LINEAR (``ops/resize.py``
  ``resize_linear``), where the JAX package takes cv2 for both;
- fine-tune branch: one image serves as identity (whole) and as driver and
  target (cropped), label 0.

Frame draws as in the flagship dataset (``frame_key``).  Keys (NHWC, f32,
or the wire's uint8 with ``--transfer_dtype uint8``): enc_rgbs
(K, H, W, 3), pose_input_rgbs and target_rgbs (1, H, W, 3); label ().
"""

from __future__ import annotations

import random

import numpy as np
import torch

from latentpose_tpu_torch.data.common import crop as crop_lib
from latentpose_tpu_torch.data.common import voxceleb
from latentpose_tpu_torch.data.pipeline import BatchLoader
from latentpose_tpu_torch.data.voxceleb2_segmentation_nolandmarks import (
    SegmSampleLoader, frame_key)
from latentpose_tpu_torch.ops.resize import resize_linear

VOXCELEB1_SCALE = 1.4
FABNET_CUTOFFS = (43 / 256, 66 / 256, 43 / 256, 20 / 256)  # l, t, r, b


def voxceleb1_bbox(raw_bbox_256, crop_type="x2face"):
    """The squared x1.4 box in [0, 1] space (l, t, r, b) of a 256-space
    detector box, or the fixed central box where there is none; FAb-Net's
    cutoffs on top with ``crop_type`` 'fabnet'."""
    if raw_bbox_256 is None:
        cutoff = (1 - VOXCELEB1_SCALE / 1.8) / 2
        l, t, r, b = cutoff, cutoff, 1 - cutoff, 1 - cutoff
    else:
        l, t, r, b = (np.asarray(raw_bbox_256, np.float64) / 256.0).tolist()
        l, t, r, b = crop_lib.square_and_scale_bbox(l, t, r, b,
                                                    scale=VOXCELEB1_SCALE)
    if crop_type == "fabnet":
        cl, ct, cr, cb = FABNET_CUTOFFS
        w, h = r - l, b - t
        l, r = l + w * cl, r - w * cr
        t, b = t + h * ct, b - h * cb
    return l, t, r, b


def raw_bbox(bboxes, path, i):
    """Frame ``i``'s 256-space box in ``bboxes``, or None."""
    try:
        identity, sequence = str(path).split("/")[-2:]
        return bboxes[identity][sequence][int(i)]
    except (KeyError, ValueError, IndexError):
        return None


def voxceleb1_crop(native, image, raw, crop_type, imsize):
    """The VoxCeleb1 crop of an (H, W, 3) uint8 frame: (imsize, imsize, 3)
    uint8.  ``native``: a ``NativeBatchLoader`` (its padded crop, at the
    box's own size, which its area resize leaves as it is)."""
    l, t, r, b = voxceleb1_bbox(raw, crop_type)
    box = crop_lib.bbox_to_integer_coords(t, l, b, r, *image.shape[:2])
    cropped = native.crop_boxes(image[None], [box], [False], box[2] - box[0])
    return resize_linear(torch.from_numpy(cropped), (imsize, imsize))[0] \
        .numpy()


class Wrapper:
    @staticmethod
    def get_dataloader(args, part, phase="train"):
        dirlist = voxceleb.get_part_data(args, part)
        loader = X2FaceSampleLoader(
            args.data_root, img_dir=args.img_dir, bboxes_dir=args.bboxes_dir,
            crop_type=args.voxceleb1_crop_type,
            deterministic=part != "train", wire_dtype=args.transfer_dtype)
        dataset = X2FaceDataset(dirlist, loader, bool(args.inference),
                                args.n_frames_for_encoder, args.image_size,
                                seed=args.random_seed)
        return BatchLoader(
            dataset, batch_size=args.batch_size, shuffle=phase == "train",
            seed=args.random_seed, num_workers=args.num_workers,
            prefetch_size=args.prefetch_size, drop_last=phase == "train")


class X2FaceSampleLoader(SegmSampleLoader):
    """The identity frame resized, and the driver's VoxCeleb1 crop (the
    bboxes dict and the C++ pool of the flagship's loader)."""

    def __init__(self, data_root, img_dir=None, bboxes_dir=None,
                 crop_type="x2face", deterministic=False,
                 wire_dtype="float32"):
        super().__init__(data_root, img_dir, bboxes_dir=bboxes_dir,
                         deterministic=deterministic, wire_dtype=wire_dtype)
        self.crop_type = crop_type

    def load_voxceleb1_crop(self, path, i, imsize, image=None):
        """Frame ``i``'s VoxCeleb1 crop (imsize, imsize, 3), f32 in [0, 1]
        or the wire's uint8; ``image``: the frame, if decoded already."""
        image = self.load_rgb(path, i) if image is None else image
        return self._out(voxceleb1_crop(self.native, image,
                                        raw_bbox(self.bboxes, path, i),
                                        self.crop_type, imsize))

    def load_sample(self, path, i, imsize, load_image=False,
                    load_voxceleb1_crop=False):
        """{'image': the frame resized (cubic up, area down),
        'image_cropped_voxceleb1': its VoxCeleb1 crop}, f32 in [0, 1] or
        the wire's uint8."""
        out = {}
        if not load_image and not load_voxceleb1_crop:
            return out
        image = self.load_rgb(path, i)
        if load_image:
            out["image"] = self._out(voxceleb.resize_like_cv2(
                image, imsize, imsize > image.shape[0]))
        if load_voxceleb1_crop:
            out["image_cropped_voxceleb1"] = self.load_voxceleb1_crop(
                path, i, imsize, image)
        return out


class X2FaceDataset(voxceleb.VoxCeleb2DatasetBase):
    def __init__(self, dirlist, loader, inference, n_frames_for_encoder,
                 imsize, seed=0):
        super().__init__(dirlist, loader, inference, n_frames_for_encoder,
                         imsize)
        self.num_labels = 1 if dirlist.finetuning else len(dirlist)
        self.seed = seed
        self.epoch = 0      # set by the BatchLoader

    def __getitem__(self, index):
        return self.get(index)

    def get(self, index, deterministic=False):
        """Sample ``index`` as (data_dict, target_dict); ``deterministic``
        (or a deterministic loader) draws the frames with seed 666."""
        index = int(index)
        path = self.dirlist.paths[index]
        if self.dirlist.finetuning:
            sample = self.loader.load_sample(
                path, self.dirlist.files[index], self.imsize,
                load_image=True, load_voxceleb1_crop=True)
            encs, label = [sample["image"]], 0
        else:
            rng = None if deterministic else random.Random(
                frame_key(self.seed, self.epoch, index))
            ids = self.loader.list_ids(path, self.n_frames_for_encoder + 1,
                                       rng)
            encs = [self.loader.load_sample(path, i, self.imsize,
                                            load_image=True)["image"]
                    for i in ids[:-1]]
            sample = self.loader.load_sample(path, ids[-1], self.imsize,
                                             load_voxceleb1_crop=True)
            label = index
        crop = sample["image_cropped_voxceleb1"][None]
        data_dict = {"enc_rgbs": np.stack(encs), "pose_input_rgbs": crop,
                     "target_rgbs": crop.copy()}
        return data_dict, {"label": label}
