"""FSTH small-crop dataset (port of
``latentpose_tpu/data/voxceleb2_FSTH_crop.py``): the landmark dataset with
a fixed crop that cuts 20 % off the top and centres the square
horizontally (the few-shot-talking-heads training crop); the keypoints
move and scale with the crop."""

from __future__ import annotations

import numpy as np

from latentpose_tpu_torch.data import voxceleb2
from latentpose_tpu_torch.data.common import voxceleb


class Wrapper:
    @staticmethod
    def get_dataloader(args, part, phase="train"):
        return voxceleb2.get_dataloader(args, part, phase,
                                        FSTHCropSampleLoader)


class FSTHCropSampleLoader(voxceleb.SampleLoader):
    """Fixed crop: 20 % off the top, the square centred horizontally."""

    def load_sample(self, path, i, imsize, load_image=False,
                    load_stickman=False, load_keypoints=False, **_):
        out = {}
        if not load_image:
            return out
        image = self.load_rgb(path, i)
        cut_t, cut_b = 0.2, 1.0
        cut_l = (1.0 - (cut_b - cut_t)) / 2
        cut_r = 1.0 - cut_l
        t = min(image.shape[0] - 1, round(cut_t * image.shape[0]))
        l = min(image.shape[1] - 1, round(cut_l * image.shape[1]))
        b = max(t + 1, round(cut_b * image.shape[0]))
        r = max(l + 1, round(cut_r * image.shape[1]))
        image = image[t:b, l:r]

        if load_keypoints or load_stickman:
            kp = self.load_keypoints(path, i).astype(np.float32)
            kp -= [[l, t]]
            kp *= [[imsize / (r - l), imsize / (b - t)]]

        out["image"] = self._out(voxceleb.resize_like_cv2(
            image, imsize, imsize > image.shape[0]))
        if load_stickman:
            out["stickman"] = self._out(self.draw_stickman((imsize, imsize),
                                                           kp))
        if load_keypoints:
            out["keypoints"] = kp.flatten() / imsize
        return out
