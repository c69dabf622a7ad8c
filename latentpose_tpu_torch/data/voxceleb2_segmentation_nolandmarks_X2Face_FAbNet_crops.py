"""The flagship's dataset with the pose input in the VoxCeleb1 crop (port
of
``latentpose_tpu/data/voxceleb2_segmentation_nolandmarks_X2Face_FAbNet_crops.py``),
for the pretrained-pose-encoder ablations (``X2Face_pretrained_embResNeXt``,
``FAbNet_pretrained_embResNeXt``): the identity frames, the target and its
mask come through the flagship's bbox crop (x1.8,
``voxceleb2_segmentation_nolandmarks``), and ``pose_input_rgbs`` is the
driver frame's VoxCeleb1 crop (x1.4, FAb-Net's cutoffs with
``--voxceleb1_crop_type fabnet``; ``voxceleb2_X2Face.voxceleb1_crop``).
Keys, draws and the wire as in the flagship dataset."""

from __future__ import annotations

from latentpose_tpu_torch.data.common import voxceleb
from latentpose_tpu_torch.data.pipeline import BatchLoader
from latentpose_tpu_torch.data.voxceleb2_segmentation_nolandmarks import (
    SegmSampleLoader, VoxCeleb2SegmDataset)
from latentpose_tpu_torch.data.voxceleb2_X2Face import X2FaceSampleLoader


class Wrapper:
    @staticmethod
    def get_dataloader(args, part, phase="train"):
        dirlist = voxceleb.get_part_data(args, part)
        loader = MixedCropSampleLoader(
            args.data_root, img_dir=args.img_dir, segm_dir=args.segm_dir,
            bboxes_dir=args.bboxes_dir, deterministic=part != "train",
            wire_dtype=args.transfer_dtype)
        loader.crop_type = args.voxceleb1_crop_type
        dataset = MixedCropDataset(
            dirlist, loader, bool(args.inference), args.n_frames_for_encoder,
            args.image_size, seed=args.random_seed)
        return BatchLoader(
            dataset, batch_size=args.batch_size, shuffle=phase == "train",
            seed=args.random_seed, num_workers=args.num_workers,
            prefetch_size=args.prefetch_size, drop_last=phase == "train")


class MixedCropSampleLoader(SegmSampleLoader):
    """The flagship's frames and masks, and the driver's VoxCeleb1 crop."""

    crop_type = "x2face"
    load_voxceleb1_crop = X2FaceSampleLoader.load_voxceleb1_crop


class MixedCropDataset(VoxCeleb2SegmDataset):
    def pose_input(self, path, frame, images):
        return self.loader.load_voxceleb1_crop(path, frame, self.imsize)[None]
