"""Embedding matching (port of ``latentpose_tpu/losses/dis_embed.py``): L1
between the embedder's identity embedding of frame 0 and the discriminator's
detached projection row W[label], times ``dis_embed_weight``; it ties the two
embedding spaces, so that W is a fit start for a fine-tuned avatar's row.

A mean over the batch's samples, each of equal weight: under N ranks on
equal shards the mean of the ranks' values is the global batch's, so this
criterion needs no collective (``losses/dice.py`` is the one that does)."""

from __future__ import annotations


class Wrapper:
    @staticmethod
    def get_net(args):
        return Criterion(args.dis_embed_weight)


class Criterion:
    def __init__(self, dis_embed_weight):
        self.weight = float(dis_embed_weight)

    def __call__(self, data_dict):
        fake_embed = data_dict["embeds_elemwise"]
        real_embed = data_dict["real_embedding"]
        if fake_embed.dim() > 2:
            fake_embed = fake_embed[:, 0]
        if real_embed.dim() > 2:
            real_embed = real_embed[:, 0]
        loss = (fake_embed - real_embed.detach()).abs().mean() * self.weight
        return {"embedding_matching": loss}
