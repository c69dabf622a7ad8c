"""A PNG encoder with the standard library only (``zlib``, ``struct``):
8-bit RGB or grey, no filtering.  The machine with the card has neither
cv2 nor PIL; the port writes its images (the experiment's visuals, test
fixtures) with this.  It decodes with any PNG reader, and with the port's
own loader (``data/native_loader.py``)."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(image, level: int = 6) -> bytes:
    """PNG bytes of a uint8 (H, W, 3) RGB or (H, W) grey image."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) \
            or (image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"encode_png takes uint8 (H, W, 3) or (H, W), got "
                         f"{image.dtype} {image.shape}")
    h, w = image.shape[:2]
    colour = 2 if image.ndim == 3 else 0
    rows = image.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path, image, level: int = 6):
    """Write :func:`encode_png` of ``image`` to ``path``."""
    Path(path).write_bytes(encode_png(image, level))
