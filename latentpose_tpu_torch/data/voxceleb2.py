"""Landmark dataset of the FSTH family (port of
``latentpose_tpu/data/voxceleb2.py``): frames, stickmen and keypoints of
the pre-cropped VoxCeleb2 tree, no segmentation, no bbox crop.

- one sample = one video: K+1 frames -> K identity frames with their
  stickmen + 1 driver with its stickman and keypoints (also the target);
- fine-tune branch: one image serves as identity, driver and target,
  label 0;
- frames are decoded by ``data/native_loader.py`` and resized as cv2
  resizes them, stickmen drawn as cv2 draws them
  (``data/common/voxceleb.py``).

Frame draws: a training sample draws from a ``random.Random`` keyed on
(seed, epoch, index) (``frame_key``, as the flagship dataset); the val part
and the fixed probes draw deterministically (``random.Random(666)`` over
the sorted listing), as the JAX package does.

Keys (NHWC, f32): enc_rgbs, enc_stickmen (K, H, W, 3); pose_input_rgbs,
dec_stickmen, target_rgbs (1, H, W, 3); dec_keypoints (1, 136); label ().
With ``--transfer_dtype uint8`` the images and stickmen are the wire's
uint8 from the loader on, and a masked target (``voxceleb2_segm``) is
uint8(v * 255 + 0.5) of its f32 value, as the host's quantize makes it.
"""

from __future__ import annotations

import random

import numpy as np

from latentpose_tpu_torch.data.common import voxceleb
from latentpose_tpu_torch.data.pipeline import BatchLoader
from latentpose_tpu_torch.data.voxceleb2_segmentation_nolandmarks import \
    frame_key


def get_dataloader(args, part, phase, loader_cls, load_segmentation=False,
                   **loader_kwargs):
    """The BatchLoader of a landmark dataset whose frames ``loader_cls`` (a
    ``voxceleb.SampleLoader``) loads."""
    dirlist = voxceleb.get_part_data(args, part)
    loader = loader_cls(
        args.data_root, img_dir=args.img_dir, kp_dir=args.kp_dir,
        draw_oval=args.draw_oval, deterministic=part != "train",
        wire_dtype=args.transfer_dtype, **loader_kwargs)
    dataset = VoxCeleb2LandmarkDataset(
        dirlist, loader, bool(args.inference), args.n_frames_for_encoder,
        args.image_size, load_segmentation=load_segmentation,
        seed=args.random_seed)
    return BatchLoader(
        dataset, batch_size=args.batch_size, shuffle=phase == "train",
        seed=args.random_seed, num_workers=args.num_workers,
        prefetch_size=args.prefetch_size, drop_last=phase == "train")


class Wrapper:
    @staticmethod
    def get_dataloader(args, part, phase="train"):
        return get_dataloader(args, part, phase, voxceleb.SampleLoader)


def _masked(image, segm):
    """target = image * segmentation: the f32 product, or on the wire its
    uint8(v * 255 + 0.5)."""
    if image.dtype != np.uint8:
        return image * segm
    value = (image.astype(np.float32) / 255.0) \
        * (segm.astype(np.float32) / 255.0)
    return (value * 255.0 + 0.5).astype(np.uint8)


class VoxCeleb2LandmarkDataset(voxceleb.VoxCeleb2DatasetBase):
    def __init__(self, dirlist, loader, inference, n_frames_for_encoder,
                 imsize, load_segmentation=False, seed=0):
        super().__init__(dirlist, loader, inference, n_frames_for_encoder,
                         imsize)
        self.load_segmentation = load_segmentation
        self.num_labels = 1 if dirlist.finetuning else len(dirlist)
        self.seed = seed
        self.epoch = 0      # set by the BatchLoader

    def _load(self, path, frame, segm=False):
        kwargs = dict(load_image=True, load_stickman=True,
                      load_keypoints=True)
        if segm:
            kwargs["load_segmentation"] = True
        return self.loader.load_sample(path, frame, self.imsize, **kwargs)

    def __getitem__(self, index):
        return self.get(index)

    def get(self, index, deterministic=False):
        """Sample ``index`` as (data_dict, target_dict); ``deterministic``
        (or a deterministic loader) draws the frames with seed 666."""
        index = int(index)
        data_dict, target_dict = {}, {}
        path = self.dirlist.paths[index]
        want_segm = self.load_segmentation and not self.inference

        if self.dirlist.finetuning:
            dec = self._load(path, self.dirlist.files[index], want_segm)
            encs = [dec]
            label = 0
        else:
            rng = None if deterministic else random.Random(
                frame_key(self.seed, self.epoch, index))
            ids = self.loader.list_ids(path, self.n_frames_for_encoder + 1,
                                       rng)
            encs = [self._load(path, i) for i in ids[:-1]]
            dec = self._load(path, ids[-1], want_segm)
            label = index
        data_dict["enc_rgbs"] = np.stack([e["image"] for e in encs])
        data_dict["enc_stickmen"] = np.stack([e["stickman"] for e in encs])
        data_dict["pose_input_rgbs"] = dec["image"][None]
        data_dict["dec_stickmen"] = dec["stickman"][None]
        data_dict["dec_keypoints"] = dec["keypoints"][None]
        if not self.inference:
            if want_segm:
                segm = dec["segmentation"][None]
                data_dict["target_rgbs"] = _masked(dec["image"][None], segm)
                target_dict["real_segm"] = segm
            else:
                data_dict["target_rgbs"] = dec["image"][None]
        target_dict["label"] = label
        return data_dict, target_dict
