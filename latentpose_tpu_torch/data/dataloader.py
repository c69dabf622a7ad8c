"""Dataloader factory (port of ``latentpose_tpu/data/dataloader.py``): a
name resolves to the dataset plugin's ``Wrapper`` through the registry."""

from __future__ import annotations

from latentpose_tpu_torch import registry


def get_dataloader(args, part: str = "train", phase: str = "train"):
    """``args.dataloader``'s loader of ``part`` ('train' or 'val'); its
    shuffled, drop-last form for ``phase`` 'train'."""
    return registry.load_wrapper("dataloaders", args.dataloader) \
        .get_dataloader(args, part, phase)
