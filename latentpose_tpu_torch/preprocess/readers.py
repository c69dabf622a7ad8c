"""Image sequence readers (port of ``latentpose_tpu/preprocess/readers.py``):
a folder of frames, a video file, or a single image.  Frames and images
decode through the port's C++ loader (``data/native_loader.py``: PNG, and
JPEG through libjpeg or nvJPEG); a video through cv2 where it imports."""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path

from latentpose_tpu_torch.data import native_loader

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


class ImageReader(ABC):
    @abstractmethod
    def __len__(self):
        ...

    @abstractmethod
    def __next__(self):
        """Returns (RGB uint8 image, name stem)."""

    def __iter__(self):
        return self

    @staticmethod
    def get_image_reader(source):
        source = Path(source)
        if source.is_dir():
            return FolderReader(source)
        if source.suffix.lower() in IMAGE_EXTENSIONS:
            return SingleImageReader(source)
        return VideoReader(source)


def _decode(path):
    try:
        return native_loader.decode(path)
    except ValueError as err:
        raise IOError(f"Couldn't read {path}") from err


class FolderReader(ImageReader):
    def __init__(self, path):
        self.files = sorted(p for p in Path(path).iterdir()
                            if p.suffix.lower() in IMAGE_EXTENSIONS)
        self.idx = 0

    def __len__(self):
        return len(self.files)

    def __next__(self):
        if self.idx >= len(self.files):
            raise StopIteration
        p = self.files[self.idx]
        self.idx += 1
        return _decode(p), p.stem


class VideoReader(ImageReader):
    def __init__(self, path):
        try:
            import cv2
        except ImportError as err:
            raise RuntimeError(
                f"reading the video {path} needs cv2, which does not import "
                "here; decode it to frames first (preprocess_dataset "
                "--do_decode_videos, through ffmpeg) and read the "
                "folder") from err
        self.cap = cv2.VideoCapture(str(path))
        self.length = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.idx = 0

    def __len__(self):
        return max(self.length, 0)

    def __next__(self):
        ok, img = self.cap.read()
        if not ok:
            self.cap.release()
            raise StopIteration
        name = f"{self.idx:06d}"
        self.idx += 1
        return img[..., ::-1].copy(), name


class SingleImageReader(ImageReader):
    def __init__(self, path):
        self.path = Path(path)
        self.done = False

    def __len__(self):
        return 1

    def __next__(self):
        if self.done:
            raise StopIteration
        self.done = True
        return _decode(self.path), self.path.stem
