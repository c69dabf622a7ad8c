"""Procedural "talking head" frames, rendered with numpy (port of the
renderer and the loader of ``latentpose_tpu/data/synthetic.py``, bit for
bit; the JAX module cannot be imported where the card is, since it imports
the augmentation code and with it jax).

Each (identity, frame) renders an elliptical head whose colour and size
encode identity and whose offset, eyes and mouth encode a pose that varies
smoothly with the frame index (period 32).  ``synthetic://K`` drives with
identity K; :class:`SyntheticDataLoader` feeds a meta-train or a fine-tune
run (the dataloader ``synthetic``).
"""

from __future__ import annotations

import numpy as np

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
            wire_dtype=args.transfer_dtype, rows=rows)


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
    """

    def __init__(self, image_size, batch_size, num_labels=16,
                 num_enc_frames=8, frames_per_video=32, finetune=True,
                 seed=0, wire_dtype="float32", rows=None):
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
        self._cache = {}

    def __len__(self):
        return self.steps_per_epoch

    def _render(self, label, frame):
        """(image, segm, target) of a frame, f32 or the wire's uint8."""
        key = (label, frame % 32)
        if key not in self._cache:
            if self.u8:
                self._cache[key] = render_face_u8(label, frame,
                                                  self.image_size)
            else:
                img, segm = render_face(label, frame, self.image_size)
                self._cache[key] = img, segm, img * segm
        return self._cache[key]

    def sample(self, label: int, rng):
        """(enc (K, H, W, 3), driver (H, W, 3), segm (H, W, 1), target
        (H, W, 3))."""
        frames = rng.randint(0, self.frames_per_video,
                             size=self.num_enc_frames + 2)
        if self.finetune:
            img, segm, target = self._render(label, int(frames[0]))
            return np.stack([img] * self.num_enc_frames), img, segm, target
        enc = np.stack([self._render(label, int(f))[0]
                        for f in frames[:self.num_enc_frames]])
        return (enc, *self._render(label, int(frames[-2])))

    def get_batch(self, it: int):
        rng = np.random.RandomState(self.seed + it + 100003 * self.epoch)
        labels = rng.randint(0, self.num_labels, size=self.batch_size)
        encs, imgs, segms, targets = zip(*(self.sample(int(label), rng)
                                           for label in labels))
        data_dict = {"enc_rgbs": np.stack(encs),
                     "pose_input_rgbs": np.stack(imgs)[:, None]}
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
