"""Video and image-sequence writers for drive's side-by-side output (port of
``latentpose_tpu/utils/video.py``).  Backend: cv2 (ffmpeg) if its encoder
opens, else imageio, else a directory of PNG frames written by the port's
own encoder (``utils/png.py``): with neither cv2 nor imageio, as on the
machine with the card, drive still writes its frames."""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from latentpose_tpu_torch.utils.png import write_png

logger = logging.getLogger("latentpose_tpu_torch.video")


class FrameDirWriter:
    def __init__(self, path):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.idx = 0

    def add(self, frame_uint8_rgb):
        write_png(self.path / f"{self.idx:06d}.png", frame_uint8_rgb)
        self.idx += 1

    def close(self):
        pass


class CV2VideoWriter:
    def __init__(self, path, fps=25.0):
        import cv2
        self.cv2 = cv2
        self.path = str(path)
        self.fps = fps
        self.writer = None

    def add(self, frame_uint8_rgb):
        if self.writer is None:
            h, w = frame_uint8_rgb.shape[:2]
            fourcc = self.cv2.VideoWriter_fourcc(*"mp4v")
            self.writer = self.cv2.VideoWriter(self.path, fourcc, self.fps,
                                               (w, h))
            if not self.writer.isOpened():
                raise RuntimeError("cv2.VideoWriter failed to open")
        self.writer.write(frame_uint8_rgb[..., ::-1])

    def close(self):
        if self.writer is not None:
            self.writer.release()


class ImageIOVideoWriter:
    def __init__(self, path, fps=25.0):
        import imageio
        self.writer = imageio.get_writer(str(path), fps=fps)

    def add(self, frame_uint8_rgb):
        self.writer.append_data(frame_uint8_rgb)

    def close(self):
        self.writer.close()


def get_image_writer(destination, fps=25.0):
    """A writer for ``destination``: ``.mp4``/``.avi``/``.mkv`` -> video,
    anything else -> a frame directory."""
    destination = Path(destination)
    if destination.suffix.lower() in (".mp4", ".avi", ".mkv"):
        destination.parent.mkdir(parents=True, exist_ok=True)
        try:
            return CV2VideoWriter(destination, fps)
        except Exception:  # noqa: BLE001
            pass
        try:
            return ImageIOVideoWriter(destination, fps)
        except Exception:  # noqa: BLE001
            logger.warning("No video encoder available; writing PNG frames "
                           "to %s.frames/", destination)
            return FrameDirWriter(str(destination) + ".frames")
    return FrameDirWriter(destination)


def to_uint8(img_float_rgb):
    return (np.clip(np.asarray(img_float_rgb), 0.0, 1.0)
            * 255).astype(np.uint8)
