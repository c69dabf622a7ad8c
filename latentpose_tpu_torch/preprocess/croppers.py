"""Face croppers (port of ``latentpose_tpu/preprocess/croppers.py``, the
latentpose style).

``LatentPoseFaceCropper``: the S³FD box (or a given one) -> the largest box
-> square, x1.8 -> integer pixel box -> the blur-faded padded crop -> resize
(INTER_CUBIC when the output is taller than the detected box, else
INTER_AREA), all in C++ (``csrc/lpr_loader.cpp``, the dataset's crop);
optionally FAN's 68 landmarks, shifted and scaled into the crop.  Frames of
one size are cropped as a batch: one S³FD pass, one FAN pass, one call of
the C++ pool.

The FFHQ style (landmark-aligned quads) waits for ROADMAP A.19 with the
crops of the X2Face and FAbNet families.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod

import numpy as np
import torch

from latentpose_tpu_torch.data.native_loader import NativeBatchLoader
from latentpose_tpu_torch.utils.weights import (find_weights_file,
                                                load_flax_weights)


def choose_one_detection(frame_faces):
    """The largest-area box; ``[0, 0, 200, 200, 0]`` when there is none."""
    if len(frame_faces) == 0:
        return [0, 0, 200, 200, 0.0]
    areas = [abs(f[2] - f[0]) * abs(f[1] - f[3]) for f in frame_faces]
    return list(np.asarray(frame_faces[int(np.argmax(areas))]))


class FaceCropper(ABC):
    def __init__(self, output_size=(256, 256), face_detector=None,
                 landmark_detector=None):
        self.output_size = tuple(output_size)
        self.face_detector = face_detector
        self.landmark_detector = landmark_detector
        self._loader = None

    @property
    def loader(self):
        """The C++ pool, made at first use."""
        if self._loader is None:
            self._loader = NativeBatchLoader()
        return self._loader

    def close(self):
        if self._loader is not None:
            self._loader.close()
            self._loader = None

    @abstractmethod
    def crop_images(self, images, bboxes=None, compute_landmarks=True):
        """images: (N, H, W, 3) uint8 RGB frames of one size; bboxes: N
        LTRB boxes or None (detect), or None.  Returns (crops (N, S, S, 3)
        uint8, landmarks (N, 68, 3) float32 or None)."""

    def crop_image(self, image, bbox=None, compute_landmarks=True):
        """One (H, W, 3) frame: (crop, landmarks (68, 3) or None)."""
        crops, landmarks = self.crop_images(image[None], [bbox],
                                            compute_landmarks)
        return crops[0], None if landmarks is None else landmarks[0]

    def _detect_bboxes(self, images):
        if self.face_detector is None:
            raise RuntimeError(
                "No face-detector backend available (S3FD weights not "
                "converted) — pass an explicit bbox")
        return [choose_one_detection(faces)[:4]
                for faces in self.face_detector(images)]

    def _detect_landmarks(self, images):
        if self.landmark_detector is None:
            raise RuntimeError(
                "No landmark backend available (FAN weights not converted) "
                "— run with compute_landmarks=False")
        return self.landmark_detector(images)


class LatentPoseFaceCropper(FaceCropper):
    def crop_images(self, images, bboxes=None, compute_landmarks=True):
        images = np.asarray(images)
        n = len(images)
        bboxes = list(bboxes) if bboxes is not None else [None] * n
        todo = [i for i in range(n) if bboxes[i] is None]
        if todo:
            for i, box in zip(todo, self._detect_bboxes(images[todo])):
                bboxes[i] = box
        landmarks = None
        if compute_landmarks:
            landmarks = np.asarray(self._detect_landmarks(images),
                                   np.float32).copy()
        out_w, out_h = self.output_size
        if out_w != out_h:
            raise ValueError(f"output_size {self.output_size}: the crop is "
                             "square")

        boxes, cubic = [], []
        for i, bbox in enumerate(bboxes):
            l, t, r, b = bbox[:4]
            cx, cy = (l + r) * 0.5, (t + b) * 0.5
            size = max(b - t, r - l) * 1.8
            l = math.floor(cx - size / 2)
            t = math.floor(cy - size / 2)
            r = math.ceil(cx + size / 2)
            b = math.ceil(cy + size / 2)
            b += (r - l) - (b - t)  # exactly square after rounding
            r += 1
            b += 1
            boxes.append((t, l, b, r))
            cubic.append(out_h > bbox[3] - bbox[1])
            if landmarks is not None:
                lm = landmarks[i]
                lm[:, 0] -= l
                lm[:, 1] -= t
                lm[:, 0] *= out_h / (b - t)
                lm[:, 1:] *= out_w / (r - l)    # Z scales too, as JAX's
        return self.loader.crop_boxes(images, boxes, cubic, out_h), landmarks


class S3FDDetector:
    """S³FD on ``device``: a batch of frames of one size -> per frame the
    boxes after NMS ([l, t, r, b, score] lists).  ``candidates`` keeps the
    last batch's count before NMS."""

    def __init__(self, weights_path, device):
        from latentpose_tpu_torch.preprocess import s3fd
        self.s3fd = s3fd
        self.device = torch.device(device)
        self.model = load_flax_weights(s3fd.S3FD(), weights_path).to(
            self.device).eval()
        self.candidates = 0

    def heads(self, images_uint8):
        """The six heads of a (N, H, W, 3) uint8 batch (numpy or tensor)."""
        x = torch.as_tensor(np.asarray(images_uint8)).to(self.device)
        with torch.no_grad():
            return self.model(self.s3fd.preprocess(x))

    def __call__(self, images_uint8):
        candidates = self.s3fd.decode_detections(self.heads(images_uint8))
        self.candidates = sum(len(c) for c in candidates)
        return [self.s3fd.nms(c).tolist() for c in candidates]


def make_face_detector(weights_dir, device="cuda"):
    """The S³FD detector if ``s3fd.npz`` is found, else None."""
    path = find_weights_file("s3fd.npz", weights_dir)
    return None if path is None else S3FDDetector(path, device)


def make_cropper(style, output_size=(256, 256), weights_dir=None,
                 device="cuda"):
    """A cropper of ``style`` with the detector and the landmarks whose
    weights are found (``s3fd.npz``, ``fan_2d.npz``)."""
    if style == "ffhq":
        raise NotImplementedError(
            "--crop-style ffhq is not ported to PyTorch yet (ROADMAP.md "
            "A.19, with the X2Face and FAbNet crops); use the latentpose "
            "style, or the JAX package's crop_as_in_dataset")
    if style != "latentpose":
        raise ValueError(f"Unknown crop style {style!r}")
    face_detector = make_face_detector(weights_dir, device)
    landmark_backend = None
    fan_path = find_weights_file("fan_2d.npz", weights_dir)
    if fan_path is not None:
        from latentpose_tpu_torch.eval.backends import FANBackend
        fan = FANBackend(fan_path, device)

        def landmark_backend(images):
            lm, _ = fan(images)
            return np.concatenate(
                [lm, np.zeros(lm.shape[:-1] + (1,), np.float32)], axis=-1)

    return LatentPoseFaceCropper(output_size, face_detector, landmark_backend)
