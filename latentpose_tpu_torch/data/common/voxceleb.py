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
  list is padded to a multiple of the world size (``parallel/mesh.py``'s:
  ``torch.distributed``'s when it is initialised, else 1);
- ``list_ids``: k frames of a video, deterministic (seed 666 over the
  sorted listing) or drawn from a ``random.Random`` the caller passes;
- ``get_other_sample_by_label`` for the cross-driving visuals;
- the landmark datasets' frames (:meth:`SampleLoader.load_sample`): the
  image decoded by ``data/native_loader.py`` and resized as cv2 resizes it
  (``ops/resize.py``: cubic up, area down), the 68 keypoints of
  ``<kp_dir>/<video>/<frame>.npy`` scaled by the same ratio, and the
  stickman: the face parts as thick polylines in fixed colours
  (:func:`draw_stickman`, cv2's raster drawn by ``csrc/stickman.cpp``).
"""

from __future__ import annotations

import csv
import logging
import random
from pathlib import Path

import numpy as np
import torch

from latentpose_tpu_torch.data import native_loader
from latentpose_tpu_torch.ops import resize
from latentpose_tpu_torch.parallel import mesh as parallel

logger = logging.getLogger("latentpose_tpu_torch.data.voxceleb")

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def world_size() -> int:
    return parallel.world()


def rank() -> int:
    return parallel.rank()


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


# stickman face parts: (keypoint indices, closed, RGB colour), drawn in order
STICKMAN_PARTS = [
    (list(range(17, 22)), False, (255, 0, 0)),
    (list(range(22, 27)), False, (0, 255, 0)),
    (list(range(27, 31)), False, (0, 0, 255)),
    (list(range(31, 36)), False, (0, 0, 255)),
    (list(range(36, 42)), True, (255, 0, 255)),
    (list(range(42, 48)), True, (0, 255, 255)),
    (list(range(48, 60)), True, (255, 255, 0)),
]
STICKMAN_OVAL = (list(range(0, 17)), False, (255, 255, 255))
STICKMAN_THICKNESS = 2


def draw_stickman(image_shape, keypoints, parts=None):
    """(H, W, 3) uint8: ``parts`` (default the oval and STICKMAN_PARTS) of
    the (68, 2) pixel ``keypoints``, each rounded half to even as
    ``np.round`` rounds, drawn as ``cv2.polylines(..., thickness=2)``
    draws them."""
    parts = [STICKMAN_OVAL] + STICKMAN_PARTS if parts is None else parts
    stickman = np.zeros(tuple(image_shape) + (3,), np.uint8)
    lines = [(np.round(keypoints[edges]).astype(np.int32), closed, color)
             for edges, closed, color in parts]
    return native_loader.draw_polylines(stickman, lines, STICKMAN_THICKNESS)


def resize_like_cv2(image, imsize, cubic):
    """``cv2.resize(image, (imsize, imsize))`` of an (H, W, 3) uint8 image
    with INTER_CUBIC (``cubic``) or INTER_AREA, on the CPU."""
    batch = torch.from_numpy(np.ascontiguousarray(image))[None]
    fn = resize.resize_cubic if cubic else resize.resize_area
    return fn(batch, (imsize, imsize))[0].numpy()


class SampleLoader:
    """Frame listing and sampling in the preprocessed VoxCeleb2 tree, and
    the landmark datasets' frames (image, keypoints, stickman).

    ``wire_dtype`` 'uint8': :meth:`load_sample` returns the image and the
    stickman as uint8 (the wire's bytes: uint8(v * 255 + 0.5) of the float
    values is the uint8 they were made from)."""

    def __init__(self, data_root, img_dir=None, deterministic=False,
                 kp_dir=None, draw_oval=True, wire_dtype="float32"):
        self.data_root = Path(data_root)
        self.img_dir = img_dir
        self.deterministic = deterministic
        self.kp_dir = kp_dir
        self.parts = ([STICKMAN_OVAL] if draw_oval else []) + STICKMAN_PARTS
        self.u8 = {"float32": False, "uint8": True}[wire_dtype]

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

    def load_rgb(self, path, i):
        """Frame ``i`` as (H, W, 3) uint8 RGB; a (1, 1, 3) zero image, with
        an error logged, where it does not decode."""
        img_path = self.resolve_image(path, i)
        try:
            return native_loader.decode(img_path)
        except (ValueError, OSError):
            logger.error("Couldn't load image %s", img_path)
            return np.zeros((1, 1, 3), np.uint8)

    def load_keypoints(self, path, i):
        """The (68, 2) keypoints of frame ``i``: the first two columns of
        ``<kp_dir>/<path>/<i>.npy``, in its dtype."""
        return np.load(self.data_root / self.kp_dir / path / (i + ".npy"))[
            :, :2]

    def draw_stickman(self, image_shape, keypoints):
        return draw_stickman(image_shape, keypoints, self.parts)

    def _out(self, image_u8):
        return image_u8 if self.u8 \
            else image_u8.astype(np.float32) / 255.0

    def load_sample(self, path, i, imsize, load_image=False,
                    load_stickman=False, load_keypoints=False):
        """A pre-cropped frame: {'image': (imsize, imsize, 3) resized (cubic
        when the width grows, else area), 'stickman': (imsize, imsize, 3),
        'keypoints': (136,) f32 in [0, 1]}; images f32 in [0, 1] (or the
        wire's uint8).  The keypoints scale by the image's width ratio."""
        out = {}
        if load_image:
            image = self.load_rgb(path, i)
            ratio = imsize / image.shape[1]
            out["image"] = self._out(resize_like_cv2(image, imsize,
                                                     ratio > 1.0))
        if load_keypoints or load_stickman:
            assert load_image
            keypoints = self.load_keypoints(path, i) * ratio
            if load_stickman:
                out["stickman"] = self._out(
                    self.draw_stickman((imsize, imsize), keypoints))
            if load_keypoints:
                out["keypoints"] = (keypoints.astype(np.float32).flatten()
                                    / imsize)
        return out


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
