"""VoxCeleb2 data-source core (port of
``latentpose_tpu/data/common/voxceleb.py``): identity-list resolution,
frame sampling and the cross-driving sample lookup.

- the 3-way data-source probe: (1) data_root/img_dir/split_path is a
  directory -> that single identity; (2) split_path is a CSV file -> the
  identity list from its ``path`` column (read with the stdlib ``csv``);
  (3) the subdirectories of data_root/img_dir;
- fine-tune mode: the list enumerates every image of the single identity;
  num_labels := 1;
- meta mode: resume truncates the list to the checkpoint's num_labels; the
  list is padded to a multiple of the world size (``torch.distributed``'s
  when it is initialised, else 1);
- ``list_ids``: k frames of a video, deterministic (seed 666 over the
  sorted listing) or drawn from a ``random.Random`` the caller passes;
- ``get_other_sample_by_label`` for the cross-driving visuals.

Stickmen and keypoints are not ported (ROADMAP.md A.19): the flagship
loader never loads them.
"""

from __future__ import annotations

import csv
import logging
import random
from pathlib import Path

logger = logging.getLogger("latentpose_tpu_torch.data.voxceleb")

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() \
        if dist.is_available() and dist.is_initialized() else 0


class Dirlist:
    """Identity (or image) list; index == label."""

    def __init__(self, paths, files=None):
        self.paths = list(paths)
        self.files = list(files) if files is not None else None

    @property
    def finetuning(self):
        return self.files is not None

    def __len__(self):
        return len(self.paths)


def read_split(split_path):
    """The ``path`` column of a split CSV, in file order."""
    with open(split_path, newline="") as f:
        return [row["path"] for row in csv.DictReader(f)]


def get_part_data(args, part) -> Dirlist:
    assert part in ("train", "val")
    data_root = Path(args.data_root)
    img_dir = Path(args.img_dir)
    split_path = Path(args.train_split_path if part == "train"
                      else args.val_split_path)

    if (data_root / img_dir / split_path).is_dir():
        logger.info("[%s] single identity: %s", part, split_path)
        identity_list = [str(split_path)]
    elif split_path.is_file():
        logger.info("[%s] identity list from CSV %s", part, split_path)
        identity_list = read_split(split_path)
    elif (data_root / img_dir).is_dir():
        # img_dir-relative paths; the tree is descended identity/video when
        # it is two levels deep (the preprocessed layout)
        base = data_root / img_dir
        identity_list = []
        for entry in sorted(x for x in base.iterdir() if x.is_dir()):
            subdirs = sorted(x for x in entry.iterdir() if x.is_dir())
            if subdirs:
                identity_list += [str(x.relative_to(base)) for x in subdirs]
            else:
                identity_list.append(str(entry.relative_to(base)))
        logger.info("[%s] %d sample dirs found under %s", part,
                    len(identity_list), base)
    else:
        raise ValueError(
            f"Could not determine input data source; check --data_root, "
            f"--img_dir and --{part}_split_path")

    if args.finetune:
        if len(identity_list) > 1:
            raise NotImplementedError(
                "fine-tuning to multiple identities is not available")
        images = sorted(
            p for ident in identity_list
            for p in (data_root / img_dir / ident).iterdir()
            if p.suffix.lower() in IMAGE_EXTENSIONS)
        logger.info("[%s] fine-tune dataset: %d images", part, len(images))
        args.num_labels = 1
        return Dirlist(
            paths=[str(p.parent.relative_to(data_root / img_dir))
                   for p in images],
            files=[p.stem for p in images])

    if args.checkpoint_path:
        logger.info("Truncating identity list to checkpoint num_labels=%d",
                    args.num_labels)
        identity_list = identity_list[:args.num_labels]
    elif part == "train":
        args.num_labels = len(identity_list)

    # pad to a multiple of the world size so the ranks' shards stay in step
    world = world_size()
    short = (world - len(identity_list) % world) % world
    return Dirlist(identity_list + identity_list[:short])


class SampleLoader:
    """Frame listing and sampling in the preprocessed VoxCeleb2 tree."""

    def __init__(self, data_root, img_dir=None, deterministic=False):
        self.data_root = Path(data_root)
        self.img_dir = img_dir
        self.deterministic = deterministic

    def list_ids(self, path, k, rng=None):
        """k frame stems of a video directory, drawn from ``rng`` (a
        ``random.Random``), or from ``random.Random(666)`` when the loader
        is deterministic or no ``rng`` is given.  The listing is sorted and
        cycled (appended once a round) when the video is shorter than k."""
        base = sorted((self.data_root / self.img_dir / path).iterdir())
        id_list = list(base)
        if self.deterministic or rng is None:
            rng = random.Random(666)
        while k > len(id_list):
            id_list += base
        return [p.stem for p in rng.sample(id_list, k=k)]

    def resolve_image(self, path, i):
        """The file of frame ``i``: ``<i>.jpg``, else the first of the other
        image extensions that exists."""
        img_path = self.data_root / self.img_dir / path / (i + ".jpg")
        if not img_path.exists():
            for ext in IMAGE_EXTENSIONS:
                alt = img_path.with_suffix(ext)
                if alt.exists():
                    return alt
        return img_path


class VoxCeleb2DatasetBase:
    """Index-based dataset over a Dirlist."""

    def __init__(self, dirlist: Dirlist, loader: SampleLoader, inference,
                 n_frames_for_encoder, imsize):
        self.dirlist = dirlist
        self.loader = loader
        self.inference = inference
        self.n_frames_for_encoder = n_frames_for_encoder
        self.imsize = imsize

        # person id (the path's first 7 characters) -> its labels
        self.identity_to_labels = {}
        for label, path in enumerate(self.dirlist.paths):
            self.identity_to_labels.setdefault(path[:7], []).append(label)

    def __len__(self):
        return len(self.dirlist)

    def get_other_sample_by_label(self, label, same_identity=False,
                                  deterministic=True, rng=random):
        """Another sample's label: of the same person (another video) or
        of another person; the next one in order when ``deterministic``,
        else drawn from ``rng``."""
        identity = self.dirlist.paths[label][:7]
        labels_here = self.identity_to_labels[identity]
        if same_identity:
            idx = 0
            while True:
                if deterministic:
                    other = labels_here[idx % len(labels_here)]
                    idx += 1
                else:
                    other = rng.choice(labels_here)
                if other != label or len(labels_here) == 1:
                    return other
        else:
            other = labels_here[0]
            while True:
                if deterministic:
                    other = (other + 1) % len(self)
                else:
                    other = rng.randint(0, len(self) - 1)
                if (self.dirlist.paths[other][:7] != identity
                        or len(labels_here) == len(self)):
                    return other
