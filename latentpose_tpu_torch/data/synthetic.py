"""Procedural "talking head" frames, rendered with numpy (port of the
renderer and the loader of ``latentpose_tpu/data/synthetic.py``, bit for
bit; the JAX module cannot be imported where the card is, since it imports
the augmentation code and with it jax).

Each (identity, frame) renders an elliptical head whose colour and size
encode identity and whose offset, eyes and mouth encode a pose that varies
smoothly with the frame index (period 32).  ``synthetic://K`` drives with
identity K; :class:`SyntheticDataLoader` feeds a meta-train or a fine-tune
run (the dataloader ``synthetic``).  With ``--synthetic_stickmen`` it also
emits the landmark families' keys: 68 keypoints derived from the same
geometry (:func:`synthetic_keypoints`) and their stickmen
(:func:`render_stickman`, drawn as the VoxCeleb2 landmark datasets draw
theirs).
"""

from __future__ import annotations

import collections

import numpy as np

from latentpose_tpu_torch.data.common import voxceleb
from latentpose_tpu_torch.parallel import mesh as parallel


class Wrapper:
    @staticmethod
    def get_dataloader(args, part, phase="train"):
        """The loader of a run's ``part``: the val part draws from the next
        seed, as in the JAX package."""
        rows = None
        if parallel.world() > 1:
            rows = parallel.local_rows(args.batch_size,
                                       parallel.batch_layout(args)).numpy()
        return SyntheticDataLoader(
            args.image_size, args.batch_size,
            num_labels=args.synthetic_num_labels,
            num_enc_frames=args.num_enc_frames,
            frames_per_video=args.synthetic_frames_per_video,
            finetune=bool(args.finetune),
            seed=args.random_seed + (0 if part == "train" else 1),
            wire_dtype=args.transfer_dtype, rows=rows,
            stickmen=bool(args.synthetic_stickmen))


def _identity_style(label: int):
    rng = np.random.RandomState(1000 + label)
    skin = 0.35 + 0.55 * rng.rand(3)
    bg = 0.1 + 0.3 * rng.rand(3)
    size = 0.28 + 0.10 * rng.rand()
    eye_sep = 0.30 + 0.15 * rng.rand()
    return skin, bg, size, eye_sep


def _pose_of_frame(frame: int, period: int = 32):
    t = 2 * np.pi * (frame % period) / period
    yaw = 0.35 * np.sin(t)            # [-0.35, 0.35] horizontal shift
    pitch = 0.2 * np.sin(2 * t + 1.0)
    mouth = 0.5 + 0.5 * np.sin(3 * t)
    return yaw, pitch, mouth


def render_face(label: int, frame: int, image_size: int):
    """Render (image, segm) float32 in [0, 1]; (H, W, 3) and (H, W, 1)."""
    skin, bg, size, eye_sep = _identity_style(label)
    yaw, pitch, mouth = _pose_of_frame(frame)
    h = w = image_size

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy = yy / h - 0.5
    xx = xx / w - 0.5

    cx = 0.5 * yaw * size
    cy = 0.5 * pitch * size
    # head ellipse
    d2 = ((xx - cx) / size) ** 2 + ((yy - cy) / (1.25 * size)) ** 2
    head = (d2 < 1.0).astype(np.float32)

    img = np.empty((h, w, 3), np.float32)
    img[:] = bg
    img = img * (1 - head[..., None]) + skin * head[..., None]

    # eyes: dark circles, horizontal position shifts with yaw (the "pose")
    for side in (-1, 1):
        ex = cx + side * eye_sep * size * 0.5 + 0.3 * yaw * size
        ey = cy - 0.35 * size + 0.2 * pitch * size
        e2 = ((xx - ex) / (0.12 * size)) ** 2 + ((yy - ey) / (0.12 * size)) ** 2
        eye = (e2 < 1.0).astype(np.float32)
        img = img * (1 - eye[..., None]) + 0.05 * eye[..., None]

    # mouth: dark ellipse whose openness encodes `mouth`
    mx, my = cx, cy + 0.55 * size
    m2 = ((xx - mx) / (0.3 * size)) ** 2 + \
         ((yy - my) / (0.05 * size + 0.12 * size * mouth)) ** 2
    mo = (m2 < 1.0).astype(np.float32)
    img = img * (1 - mo[..., None]) + 0.1 * mo[..., None]

    # the style scalars are float64, so the math above upcasts; cast once
    return (img.astype(np.float32), np.ascontiguousarray(
        head[..., None], dtype=np.float32))


def render_face_u8(label: int, frame: int, image_size: int):
    """The uint8 wire's twin of :func:`render_face`: (image, segm, target =
    image * segm), each uint8(x * 255 + 0.5) of the f32 render, so the
    device's / 255 gives the f32 loader's batch to 8-bit rounding."""
    img, segm = render_face(label, frame, image_size)
    return tuple((x * 255.0 + 0.5).astype(np.uint8)
                 for x in (img, segm, img * segm))


# the process's renders, shared by its datasets (a render of a 256² frame
# takes ~20 ms on a host core), read-only
_RENDERS = collections.OrderedDict()
_RENDERS_KEPT = 1024


def _rendered(label: int, frame: int, image_size: int, u8: bool):
    """(image, segm, target) of a frame, f32 or the wire's uint8, from the
    process's renders."""
    key = (label, frame, image_size, u8)
    if key in _RENDERS:
        _RENDERS.move_to_end(key)
        return _RENDERS[key]
    if u8:
        out = render_face_u8(label, frame, image_size)
    else:
        img, segm = render_face(label, frame, image_size)
        out = img, segm, img * segm
    for arr in out:
        arr.setflags(write=False)
    _RENDERS[key] = out
    while len(_RENDERS) > _RENDERS_KEPT:
        _RENDERS.popitem(last=False)
    return out


def synthetic_keypoints(label: int, frame: int, image_size: int):
    """68 face landmarks (iBUG-68 layout) of the procedural face, from the
    geometry of :func:`render_face` (head ellipse, eyes, mouth): (68, 2)
    float32 pixel coordinates."""
    _, _, size, eye_sep = _identity_style(label)
    yaw, pitch, mouth = _pose_of_frame(frame)
    cx = 0.5 * yaw * size
    cy = 0.5 * pitch * size
    pts = np.zeros((68, 2), np.float32)

    # jaw / face oval (0-16): lower half of the head ellipse, left->right
    a = np.linspace(0.95 * np.pi, 0.05 * np.pi, 17)
    pts[0:17, 0] = cx + size * np.cos(a)
    pts[0:17, 1] = cy + 1.25 * size * np.sin(a)

    eye_centers = {}
    for key, side in (("l", -1), ("r", 1)):
        ex = cx + side * eye_sep * size * 0.5 + 0.3 * yaw * size
        ey = cy - 0.35 * size + 0.2 * pitch * size
        eye_centers[key] = (ex, ey)

    # brows (17-21 left, 22-26 right): flat arcs above the eyes
    for start, key in ((17, "l"), (22, "r")):
        ex, ey = eye_centers[key]
        pts[start:start + 5, 0] = np.linspace(ex - 0.18 * size,
                                              ex + 0.18 * size, 5)
        pts[start:start + 5, 1] = ey - 0.22 * size

    # nose bridge (27-30) + base (31-35)
    pts[27:31, 0] = cx
    pts[27:31, 1] = np.linspace(cy - 0.2 * size, cy + 0.25 * size, 4)
    pts[31:36, 0] = cx + np.linspace(-0.12, 0.12, 5) * size
    pts[31:36, 1] = cy + 0.3 * size

    # eyes (36-41 left, 42-47 right): hexagons at the rendered eye circles
    for start, key in ((36, "l"), (42, "r")):
        ex, ey = eye_centers[key]
        ang = np.linspace(0, 2 * np.pi, 7)[:6]
        pts[start:start + 6, 0] = ex + 0.12 * size * np.cos(ang)
        pts[start:start + 6, 1] = ey + 0.12 * size * np.sin(ang)

    # mouth: outer ellipse (48-59) + inner (60-67); height tracks openness
    mw = 0.3 * size
    mh = 0.05 * size + 0.12 * size * mouth
    myc = cy + 0.55 * size
    ang = np.linspace(0, 2 * np.pi, 13)[:12]
    pts[48:60, 0] = cx + mw * np.cos(ang)
    pts[48:60, 1] = myc + mh * np.sin(ang)
    ang = np.linspace(0, 2 * np.pi, 9)[:8]
    pts[60:68, 0] = cx + 0.7 * mw * np.cos(ang)
    pts[60:68, 1] = myc + 0.7 * mh * np.sin(ang)

    return (pts + 0.5) * image_size  # grid coords [-0.5, 0.5] -> pixels


def render_stickman_u8(label: int, frame: int, image_size: int):
    """The stickman of :func:`synthetic_keypoints`, oval included: (H, W,
    3) uint8, the raster itself (the uint8 wire's bytes)."""
    return voxceleb.draw_stickman((image_size, image_size),
                                  synthetic_keypoints(label, frame,
                                                      image_size))


def render_stickman(label: int, frame: int, image_size: int):
    """:func:`render_stickman_u8` as (H, W, 3) float32 in [0, 1]."""
    return render_stickman_u8(label, frame, image_size).astype(
        np.float32) / 255.0


class SyntheticDataLoader:
    """Iterable of (data_dict, target_dict) numpy batches, drawn with the JAX
    loader's ``RandomState`` sequence:

      data_dict:   enc_rgbs (B, K, H, W, 3), pose_input_rgbs (B, 1, H, W, 3)
      target_dict: target_rgbs (B, 1, H, W, 3) = image * segm,
                   real_segm (B, 1, H, W, 1), label (B,) int32

    Meta mode: each sample is one of ``num_labels`` identities, with K
    identity frames and a driving frame (also the target) from that
    identity's video.  Fine-tune mode: one identity (label 0), one frame
    per sample serving as the K identity frames, the driving frame and the
    target (reference ``voxceleb2_segmentation_nolandmarks.py:187-209``).

    An epoch has ``max(1, num_labels // batch_size)`` batches.  Renders are
    cached: the pose has period 32, so a run touches at most 32 frames of
    each identity.  ``wire_dtype`` 'uint8' emits the wire's bytes from a
    cache of :func:`render_face_u8` renders, with no pass over a batch.
    ``rows``: under N ranks, the rank's rows of each (global) batch
    (``parallel/mesh.py`` ``local_rows``), so that the ranks' batches
    together are one process's.

    ``stickmen``: the batch also carries enc_stickmen (B, K, H, W, 3) and
    dec_stickmen (B, 1, H, W, 3) of the identity and driving frames, and
    dec_keypoints (B, 1, 136) of the driving frame in [0, 1] (the landmark
    families' inputs), uint8 on the wire.
    """

    def __init__(self, image_size, batch_size, num_labels=16,
                 num_enc_frames=8, frames_per_video=32, finetune=True,
                 seed=0, wire_dtype="float32", rows=None, stickmen=False):
        self.image_size = image_size
        self.batch_size = batch_size
        self.num_enc_frames = num_enc_frames
        self.frames_per_video = frames_per_video
        self.finetune = finetune
        self.seed = seed
        self.u8 = {"float32": False, "uint8": True}[wire_dtype]
        self.steps_per_epoch = max(1, num_labels // batch_size)
        # the discriminator's W has one row when fine-tuning
        self.num_labels = 1 if finetune else num_labels
        self.epoch = 0
        self.rows = rows
        self.stickmen = stickmen
        self._cache = {}
        self._sticks = {}

    def __len__(self):
        return self.steps_per_epoch

    def _render(self, label, frame):
        """(image, segm, target) of a frame, f32 or the wire's uint8."""
        key = (label, frame % 32)
        if key not in self._cache:
            self._cache[key] = _rendered(label, frame % 32, self.image_size,
                                         self.u8)
        return self._cache[key]

    def _stickman(self, label, frame):
        key = (label, frame % 32)
        if key not in self._sticks:
            stick = render_stickman_u8(label, frame, self.image_size)
            self._sticks[key] = stick if self.u8 \
                else stick.astype(np.float32) / 255.0
        return self._sticks[key]

    def _landmarks(self, label, enc_frames, drv_frame):
        return {
            "enc_stickmen": np.stack([self._stickman(label, int(f))
                                      for f in enc_frames]),
            "dec_stickmen": self._stickman(label, int(drv_frame))[None],
            "dec_keypoints": (synthetic_keypoints(
                label, int(drv_frame), self.image_size).flatten()
                / self.image_size)[None]}

    def sample(self, label: int, rng):
        """(enc (K, H, W, 3), driver (H, W, 3), segm (H, W, 1), target
        (H, W, 3), the stickmen and keypoints {name: array} or None)."""
        frames = rng.randint(0, self.frames_per_video,
                             size=self.num_enc_frames + 2)
        if self.finetune:
            enc_frames = [int(frames[0])] * self.num_enc_frames
            drv_frame = int(frames[0])
            img, segm, target = self._render(label, drv_frame)
            enc = np.stack([img] * self.num_enc_frames)
        else:
            enc_frames, drv_frame = frames[:self.num_enc_frames], frames[-2]
            enc = np.stack([self._render(label, int(f))[0]
                            for f in enc_frames])
            img, segm, target = self._render(label, int(drv_frame))
        marks = self._landmarks(label, enc_frames, drv_frame) \
            if self.stickmen else None
        return enc, img, segm, target, marks

    def get_batch(self, it: int):
        rng = np.random.RandomState(self.seed + it + 100003 * self.epoch)
        labels = rng.randint(0, self.num_labels, size=self.batch_size)
        encs, imgs, segms, targets, marks = zip(
            *(self.sample(int(label), rng) for label in labels))
        data_dict = {"enc_rgbs": np.stack(encs),
                     "pose_input_rgbs": np.stack(imgs)[:, None]}
        if self.stickmen:
            data_dict.update({k: np.stack([m[k] for m in marks])
                              for k in marks[0]})
        target_dict = {
            "target_rgbs": np.stack(targets)[:, None],
            "real_segm": np.stack(segms)[:, None],
            "label": labels.astype(np.int32),
        }
        if self.rows is not None:
            data_dict = {k: v[self.rows] for k, v in data_dict.items()}
            target_dict = {k: v[self.rows] for k, v in target_dict.items()}
        return data_dict, target_dict

    def __iter__(self):
        for it in range(self.steps_per_epoch):
            yield self.get_batch(it)
        self.epoch += 1
