"""Landmark + segmentation dataset (port of
``latentpose_tpu/data/voxceleb2_segm.py``): ``voxceleb2``'s samples with
the driver's segmentation: target_rgbs = image * mask and real_segm
(1, H, W, 1).  The mask is ``<segm_dir>/<video>/<frame>.png``'s channel 1,
else ``<frame>.png.npy``'s channel 0, resized bilinearly as cv2 resizes it
(``ops/resize.py``)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from latentpose_tpu_torch.data import native_loader
from latentpose_tpu_torch.data import voxceleb2
from latentpose_tpu_torch.data.common import voxceleb
from latentpose_tpu_torch.ops import resize


class Wrapper:
    @staticmethod
    def get_dataloader(args, part, phase="train"):
        return voxceleb2.get_dataloader(args, part, phase, SegmSampleLoader,
                                        load_segmentation=True,
                                        segm_dir=args.segm_dir)


class SegmSampleLoader(voxceleb.SampleLoader):
    """The landmark loader and the pre-cropped segmentation masks."""

    def __init__(self, data_root, img_dir=None, kp_dir=None, segm_dir=None,
                 draw_oval=True, deterministic=False, wire_dtype="float32"):
        super().__init__(data_root, img_dir, deterministic=deterministic,
                         kp_dir=kp_dir, draw_oval=draw_oval,
                         wire_dtype=wire_dtype)
        self.segm_dir = segm_dir

    def load_sample(self, path, i, imsize, load_segmentation=False,
                    **kwargs):
        out = super().load_sample(path, i, imsize, **kwargs)
        if load_segmentation:
            base = Path(self.data_root) / self.segm_dir / path
            png, npy = base / (i + ".png"), base / (i + ".png.npy")
            if png.exists():
                segm = native_loader.decode(png)[:, :, 1]
            elif npy.exists():
                segm = np.load(str(npy))[:, :, 0]
            else:
                raise FileNotFoundError(f"Sample {png} not found")
            segm = resize.resize_linear(
                torch.from_numpy(np.ascontiguousarray(segm, np.uint8))[None],
                (imsize, imsize))[0].numpy()
            out["segmentation"] = self._out(segm)[..., None]
        return out
