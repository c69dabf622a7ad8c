"""Face croppers (port of ``latentpose_tpu/preprocess/croppers.py``).

``LatentPoseFaceCropper``: the S³FD box (or a given one) -> the largest box
-> square, x1.8 -> integer pixel box -> the blur-faded padded crop -> resize
(INTER_CUBIC when the output is taller than the detected box, else
INTER_AREA), all in C++ (``csrc/lpr_loader.cpp``, the dataset's crop);
optionally FAN's 68 landmarks, shifted and scaled into the crop.  Frames of
one size are cropped as a batch: one S³FD pass, one FAN pass, one call of
the C++ pool.

``FFHQFaceCropper``: FAN's 68 landmarks -> the FFHQ oriented quad from
the eyes and the mouth (:func:`ffhq_quad_from_landmarks`) -> its bounding
box with a border, reflect-padded (cv2's BORDER_REFLECT, the edge pixel
repeated) where it leaves the frame -> the pads blurred (a Gaussian of
sigma 0.02 x the quad's size, its kernel as cv2 sizes and samples it for
float input) and faded to the crop's per-channel median (numpy's: the mean
of the two middle values of an even count) -> rint -> INTER_CUBIC (when
the output is taller than the crop) or INTER_AREA (``ops/resize.py``).
Everything after the landmarks runs in torch on the cropper's device, in
f32, in cv2's order; the landmarks move into the crop and scale by the
reference's ratios (x by the height's, y and z by the width's).
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod

import numpy as np
import torch

from latentpose_tpu_torch.data.native_loader import NativeBatchLoader
from latentpose_tpu_torch.ops import resize
from latentpose_tpu_torch.utils.weights import (empty_module,
                                                find_weights_file,
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


def ffhq_quad_from_landmarks(landmarks):
    """The FFHQ oriented crop rectangle of 68 landmarks: (quad (4, 2),
    qsize)."""
    lm = np.asarray(landmarks, np.float32)[:, :2]
    eye_left = lm[36:42].mean(axis=0)
    eye_right = lm[42:48].mean(axis=0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm[48] + lm[54]) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    qsize = float(np.hypot(*x)) * 2
    return quad, qsize


def reflect_index(n_out, start, size, device):
    """Source indices of positions start .. start + n_out - 1 of an axis of
    ``size`` extended by cv2's BORDER_REFLECT (fedcba|abcdefgh|hgfedcb)."""
    i = torch.arange(start, start + n_out, device=device) % (2 * size)
    return torch.where(i >= size, 2 * size - 1 - i, i)


def gaussian_kernel(sigma):
    """cv2's ``getGaussianKernel`` for a float image and ksize (0, 0): size
    ``round(sigma * 8 + 1) | 1``, samples in f64, normalised, then f32."""
    ksize = int(np.rint(sigma * 8 + 1)) | 1
    x = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (k * (1.0 / k.sum())).astype(np.float32)


def gaussian_blur_reflect(image, sigma):
    """cv2.GaussianBlur(image, (0, 0), sigma, borderType=BORDER_REFLECT)
    of an (H, W, C) f32 tensor: the rows' pass, then the columns', each a
    sum of shifted copies in f32 (no TF32)."""
    kernel = gaussian_kernel(sigma)
    r = len(kernel) // 2
    h, w = image.shape[:2]
    rows = image[:, reflect_index(w + 2 * r, -r, w, image.device)]
    out = torch.zeros_like(image)
    for k, weight in enumerate(kernel):
        out += rows[:, k:k + w] * float(weight)
    cols = out[reflect_index(h + 2 * r, -r, h, image.device)]
    out = torch.zeros_like(image)
    for k, weight in enumerate(kernel):
        out += cols[k:k + h] * float(weight)
    return out


def channel_median(image):
    """``np.median(image, axis=(0, 1))`` of an (H, W, C) f32 tensor: the
    middle value, or the mean of the two middle ones of an even count."""
    values = image.reshape(-1, image.shape[-1]).sort(dim=0).values
    n = values.shape[0]
    if n % 2:
        return values[n // 2]
    return (values[n // 2 - 1] + values[n // 2]) / 2


class FFHQFaceCropper(FaceCropper):
    def __init__(self, output_size=(256, 256), face_detector=None,
                 landmark_detector=None, device="cuda"):
        super().__init__(output_size, face_detector, landmark_detector)
        self.device = torch.device(device)

    def crop_images(self, images, bboxes=None, compute_landmarks=True):
        if bboxes is not None and any(b is not None for b in bboxes):
            raise NotImplementedError("NYI: custom bbox for FFHQFaceCropper")
        landmarks = np.asarray(self._detect_landmarks(np.asarray(images)),
                               np.float32)
        crops, out_landmarks = [], []
        for image, lm in zip(images, landmarks):
            crop, lm_cropped = self.crop_from_landmarks(image, lm)
            h_ratio = self.output_size[1] / crop.shape[0]
            w_ratio = self.output_size[0] / crop.shape[1]
            lm_cropped[:, 0] *= h_ratio
            lm_cropped[:, 1:] *= w_ratio
            fn = resize.resize_cubic if h_ratio > 1.0 else resize.resize_area
            crops.append(fn(crop[None], self.output_size)[0].cpu().numpy())
            out_landmarks.append(lm_cropped)
        return np.stack(crops),             np.stack(out_landmarks) if compute_landmarks else None

    def crop_from_landmarks(self, image, landmarks):
        """The FFHQ crop of one (H, W, 3) uint8 frame: (crop (h, w, 3)
        uint8 tensor on the cropper's device, the landmarks moved into it
        (68, 3) numpy)."""
        quad, qsize = ffhq_quad_from_landmarks(landmarks)
        lm_cropped = np.asarray(landmarks, np.float32).copy()
        height, width = image.shape[:2]

        border = max(round(qsize * 0.1), 3)
        x0 = int(np.floor(quad[:, 0].min())) - border
        y0 = int(np.floor(quad[:, 1].min())) - border
        x1 = int(np.ceil(quad[:, 0].max())) + border
        y1 = int(np.ceil(quad[:, 1].max())) + border
        pad = (max(-(x0 + border) + border, 0),
               max(-(y0 + border) + border, 0),
               max((x1 - border) - width + border, 0),
               max((y1 - border) - height + border, 0))
        lm_cropped[:, 0] -= x0
        lm_cropped[:, 1] -= y0

        # the box, reflect-padded where it leaves the frame
        frame = torch.as_tensor(np.asarray(image)).to(self.device)
        ys = reflect_index(y1 - y0, y0, height, self.device)
        xs = reflect_index(x1 - x0, x0, width, self.device)
        out = frame[ys][:, xs].float()

        h, w = out.shape[:2]
        y = torch.arange(h, device=self.device,
                         dtype=torch.float32)[:, None]
        x = torch.arange(w, device=self.device,
                         dtype=torch.float32)[None, :]
        padf = np.array(pad, np.float32)
        padf[padf == 0] = 1e-10
        padf = [float(np.float32(v)) for v in padf]
        mask = torch.maximum(
            1.0 - torch.minimum(x / padf[0], (w - 1 - x) / padf[2]),
            1.0 - torch.minimum(y / padf[1], (h - 1 - y) / padf[3]))[..., None]

        blurred = gaussian_blur_reflect(out, qsize * 0.02)
        out = out + (blurred - out) * torch.clamp(mask * 3.0 + 1.0, 0.0, 1.0)
        out = out + (channel_median(out) - out) * torch.clamp(mask, 0.0, 1.0)
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
        return out, lm_cropped


class S3FDDetector:
    """S³FD on ``device``: a batch of frames of one size -> per frame the
    boxes after NMS ([l, t, r, b, score] lists).  ``candidates`` keeps the
    last batch's count before NMS."""

    def __init__(self, weights_path, device):
        from latentpose_tpu_torch.preprocess import s3fd
        self.s3fd = s3fd
        self.device = torch.device(device)
        self.model = load_flax_weights(
            empty_module(s3fd.S3FD, self.device), weights_path).eval()
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
    if style not in ("latentpose", "ffhq"):
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

    if style == "ffhq":
        return FFHQFaceCropper(output_size, face_detector, landmark_backend,
                               device)
    return LatentPoseFaceCropper(output_size, face_detector, landmark_backend)
