"""Segmentation IoU metric plugin (port of
``latentpose_tpu/metrics/segmentation_iou.py``): fake_segm against
real_segm (its first frame), both thresholded at 0.5."""

from __future__ import annotations

import torch


class Wrapper:
    @staticmethod
    def get_net(args):
        return Metric()


class Metric:
    def __call__(self, data_dict):
        fake = data_dict.get("fake_segm")
        real = data_dict.get("real_segm")
        if fake is None or real is None:
            return {}, {}
        fake, real = torch.as_tensor(fake), torch.as_tensor(real)
        if real.dim() > 4:
            real = real[:, 0]
        f = fake > 0.5
        r = real.to(fake.device) > 0.5
        inter = (f & r).sum()
        union = (f | r).sum()
        iou = inter / torch.clamp(union, min=1)
        return {"segm_IoU": float(iou)}, {"segm_IoU": 1}
