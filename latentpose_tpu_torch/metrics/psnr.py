"""PSNR metric plugin (port of ``latentpose_tpu/metrics/psnr.py``):
``__call__(data_dict) -> (values, counts)``, fake_rgbs against target_rgbs
(its first frame), over the whole batch in f32."""

from __future__ import annotations

import torch


class Wrapper:
    @staticmethod
    def get_net(args):
        return Metric()


class Metric:
    def __call__(self, data_dict):
        fake = torch.as_tensor(data_dict["fake_rgbs"])
        real = torch.as_tensor(data_dict["target_rgbs"])
        if real.dim() > 4:
            real = real[:, 0]
        mse = torch.mean((fake - real.to(fake.device)) ** 2)
        psnr = -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
        return {"PSNR": float(psnr)}, {"PSNR": 1}
