"""Discriminator feature matching (port of
``latentpose_tpu/losses/featmat.py``): mean over blocks of
mean |fake_feat - real_feat.detach()|, times ``fm_weight``."""

from __future__ import annotations


class Wrapper:
    @staticmethod
    def get_net(args):
        return Criterion(args.fm_weight)


class Criterion:
    def __init__(self, fm_weight):
        self.fm_weight = float(fm_weight)

    def __call__(self, data_dict):
        fake_feats = data_dict["fake_features"]
        real_feats = data_dict["real_features"]
        loss = 0.0
        for f, r in zip(fake_feats, real_feats):
            loss = loss + (f - r.detach()).abs().mean()
        return {"feature_matching": loss / len(fake_feats) * self.fm_weight}
