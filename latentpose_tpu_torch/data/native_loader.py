"""ctypes binding of the host image loader (port of
``latentpose_tpu/data/native_loader.py``).

``csrc/lpr_loader.cpp`` runs the input pipeline's hot loop (JPEG/PNG decode,
the dataset's blur-faded padded crop, resize, float conversion) in a C++
thread pool; the ctypes call releases the GIL, so the batch loader's Python
threads overlap with decoding.  PNG decodes through zlib in that file; JPEG
through libjpeg where its headers are installed, else through the CUDA
toolkit's nvJPEG (host API, decoded on the card).  ``csrc/stickman.cpp``,
in the same library, draws thick polylines as ``cv2.polylines`` does
(:func:`draw_polylines`: the landmark datasets' stickmen).

The library is built with g++ into ``_build/`` at first use (the file name
carries a hash of the source and flags).  There is no fallback: if it cannot
be built, loading raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCES = tuple(PACKAGE_DIR / "csrc" / name
                for name in ("lpr_loader.cpp", "stickman.cpp"))
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
_build_lock = threading.Lock()


def _compiles(code: str, flags=()) -> bool:
    proc = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", *flags, "-"],
                          input=code, capture_output=True, text=True)
    return proc.returncode == 0


def _jpeg_flags():
    """(compile flags, link flags) of the JPEG decoder: libjpeg if its
    headers are installed, else nvJPEG from the CUDA toolkit."""
    if _compiles("#include <cstdio>\n#include <jpeglib.h>\n"):
        return ["-DLPR_WITH_LIBJPEG"], ["-ljpeg"]
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (cuda / "include" / "nvjpeg.h").exists():
        lib = cuda / "lib64"
        return (["-DLPR_WITH_NVJPEG", f"-I{cuda / 'include'}"],
                [f"-L{lib}", f"-Wl,-rpath,{lib}", "-lnvjpeg", "-lcudart"])
    raise RuntimeError(
        "no JPEG decoder to build the image loader with: neither libjpeg's "
        "headers (jpeglib.h) nor the CUDA toolkit's nvjpeg.h ($CUDA_HOME) "
        "were found")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the loader library; raises with g++'s
    output if the build fails."""
    with _build_lock:
        cflags, ldflags = _jpeg_flags()
        flags = [*CXX_FLAGS, *cflags]
        digest = hashlib.sha256(" ".join(flags + ldflags).encode())
        for source in SOURCES:
            digest.update(source.read_bytes())
        path = BUILD_DIR / f"liblpr_loader-{digest.hexdigest()[:16]}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                ["g++", *flags, "-o", str(tmp), *map(str, SOURCES), *ldflags,
                 "-lz", "-lpthread"], capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError("g++ failed building the image loader "
                                   f"{SOURCES}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)   # concurrent builders never see half a file
    lib = ctypes.CDLL(str(path))
    c_paths = ctypes.POINTER(ctypes.c_char_p)
    f32 = ctypes.POINTER(ctypes.c_float)
    f64 = ctypes.POINTER(ctypes.c_double)
    u8 = ctypes.POINTER(ctypes.c_ubyte)
    lib.lpr_create.restype = ctypes.c_void_p
    lib.lpr_create.argtypes = [ctypes.c_int]
    lib.lpr_destroy.restype = None
    lib.lpr_destroy.argtypes = [ctypes.c_void_p]
    lib.lpr_jpeg_decoder.restype = ctypes.c_char_p
    lib.lpr_jpeg_decoder.argtypes = []
    lib.lpr_load_batch.restype = ctypes.c_int
    lib.lpr_load_batch.argtypes = [
        ctypes.c_void_p, c_paths, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, f32]
    for name in ("lpr_load_cropped_batch", "lpr_load_segm_batch"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, c_paths, ctypes.c_int, f64, u8,
                       ctypes.c_int, f32]
    lib.lpr_decode.restype = ctypes.c_int
    lib.lpr_decode.argtypes = [ctypes.c_char_p, u8, ctypes.c_size_t,
                               ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int)]
    for name in ("lpr_load_cropped_batch_u8", "lpr_load_segm_batch_u8"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, c_paths, ctypes.c_int, f64, u8,
                       ctypes.c_int, u8]
    for name, out in (("lpr_crop_segm", f32), ("lpr_crop_segm_u8", u8)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [u8, ctypes.c_int, ctypes.c_int, f64, ctypes.c_int,
                       ctypes.c_int, out]
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.lpr_polylines_u8.restype = ctypes.c_int
    lib.lpr_polylines_u8.argtypes = [u8, ctypes.c_int, ctypes.c_int, i32,
                                     i32, i32, u8, ctypes.c_int, ctypes.c_int]
    lib.lpr_crop_boxes_u8.restype = ctypes.c_int
    lib.lpr_crop_boxes_u8.argtypes = [
        ctypes.c_void_p, u8, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), u8, ctypes.c_int, u8]
    return lib


def jpeg_decoder() -> str:
    """'libjpeg' or 'nvjpeg': the JPEG decoder the library was built with."""
    return library().lpr_jpeg_decoder().decode()


def decode(path):
    """One image file at its own size: (H, W, 3) uint8 RGB; raises if it
    does not decode."""
    lib = library()
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    name = str(path).encode("utf-8")
    if lib.lpr_decode(name, None, 0, ctypes.byref(h), ctypes.byref(w)):
        raise ValueError(f"{path} does not decode")
    out = np.empty((h.value, w.value, 3), np.uint8)
    lib.lpr_decode(name, _ptr(out, ctypes.c_ubyte), out.nbytes,
                   ctypes.byref(h), ctypes.byref(w))
    return out


def draw_polylines(canvas, lines, thickness: int = 2):
    """Draw polylines on ``canvas`` (H, W, 3) uint8, C-contiguous, in place,
    pixel for pixel as ``cv2.polylines(canvas, [pts], closed, color,
    thickness)`` draws each in turn (LINE_8, shift 0); ``lines``: (pts
    (N, 2) int x, y, closed, (r, g, b)) in drawing order; thickness >= 2.
    Returns ``canvas``."""
    if canvas.dtype != np.uint8 or canvas.ndim != 3 or canvas.shape[2] != 3 \
            or not canvas.flags.c_contiguous:
        raise ValueError("draw_polylines takes a C-contiguous (H, W, 3) "
                         "uint8 canvas")
    pts = np.ascontiguousarray(
        np.concatenate([np.asarray(p).reshape(-1, 2) for p, _, _ in lines]),
        np.int32)
    counts = np.array([len(np.asarray(p).reshape(-1, 2))
                       for p, _, _ in lines], np.int32)
    closed = np.array([bool(c) for _, c, _ in lines], np.int32)
    colors = np.array([col for _, _, col in lines], np.uint8).reshape(-1)
    i32 = ctypes.c_int32
    if library().lpr_polylines_u8(
            _ptr(canvas, ctypes.c_ubyte), canvas.shape[0], canvas.shape[1],
            _ptr(pts, i32), _ptr(counts, i32), _ptr(closed, i32),
            _ptr(colors, ctypes.c_ubyte), len(lines), int(thickness)):
        raise ValueError(f"draw_polylines: thickness {thickness} < 2")
    return canvas


# the C entries of each output dtype: the float ones, and the uint8 wire's
_SUFFIX = {np.float32: "", np.uint8: "_u8"}
_CTYPE = {np.float32: ctypes.c_float, np.uint8: ctypes.c_ubyte}


def _ptr(array, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def _c_paths(paths):
    return (ctypes.c_char_p * len(paths))(
        *[str(p).encode("utf-8") for p in paths])


class NativeBatchLoader:
    """Decode + crop + resize batches of image files into float32 arrays,
    on a pool of ``num_threads`` C++ threads (0: the CPU count, at least
    2)."""

    def __init__(self, num_threads: int = 0):
        self._lib = library()
        if num_threads <= 0:
            num_threads = max(2, os.cpu_count() or 2)
        self._pool = self._lib.lpr_create(num_threads)

    def load(self, paths, target_size, crops=None):
        """paths: N files; crops: (N, 4) int (t, l, b, r) or None (the whole
        image).  Bilinear (align_corners=False) to target_size².

        Returns (images (N, target, target, 3) float32 in [0, 1], n_failed).
        """
        n = len(paths)
        out = np.empty((n, target_size, target_size, 3), np.float32)
        crops_arr = None if crops is None \
            else np.ascontiguousarray(crops, np.int32)
        failed = self._lib.lpr_load_batch(
            self._pool, _c_paths(paths), n,
            None if crops_arr is None else _ptr(crops_arr, ctypes.c_int),
            target_size, target_size, _ptr(out, ctypes.c_float))
        return out, failed

    def _cropped(self, name, paths, bboxes, has_bbox, shape, dtype):
        n = len(paths)
        out = np.empty((n, *shape), dtype)
        bb = np.ascontiguousarray(bboxes, np.float64).reshape(n, 4)
        hb = np.ascontiguousarray(has_bbox, np.uint8).reshape(n)
        fn = getattr(self._lib, name + _SUFFIX[dtype])
        failed = fn(self._pool, _c_paths(paths), n, _ptr(bb, ctypes.c_double),
                    _ptr(hb, ctypes.c_ubyte), shape[0],
                    _ptr(out, _CTYPE[dtype]))
        return out, failed

    def load_cropped(self, paths, bboxes, has_bbox, out_size,
                     dtype=np.float32):
        """The dataset's frame crop: decode -> bbox crop with blur-faded
        reflect101 padding (the VoxCeleb2.1 1px border strip when
        ``has_bbox``) -> AREA/CUBIC resize.

        paths: N files; bboxes: (N, 4) float64 (l, t, r, b) in [0, 1]
        (already squared and scaled); has_bbox: (N,) bool.
        Returns (images (N, out, out, 3) float32 in [0, 1], n_failed); with
        ``dtype`` uint8, those values as the wire's uint8(v * 255 + 0.5),
        quantized on the loader's threads.
        """
        return self._cropped("lpr_load_cropped_batch", paths, bboxes,
                             has_bbox, (out_size, out_size, 3), dtype)

    def load_segm(self, paths, bboxes, has_bbox, out_size, dtype=np.float32):
        """The dataset's segmentation crop of PNG masks (channel 1):
        replicate padding on the sides and bottom, zeros on top, the pads
        blurred and faded to 0 at the sides -> INTER_LINEAR resize.
        Returns (masks (N, out, out) float32 in [0, 1], n_failed), or uint8
        as :meth:`load_cropped`."""
        return self._cropped("lpr_load_segm_batch", paths, bboxes, has_bbox,
                             (out_size, out_size), dtype)

    @staticmethod
    def crop_segm(mask, bbox, has_bbox, out_size, dtype=np.float32):
        """:meth:`load_segm`'s crop of one (H, W) uint8 mask array."""
        mask = np.ascontiguousarray(mask, np.uint8)
        bb = np.ascontiguousarray(bbox, np.float64)
        out = np.empty((out_size, out_size), dtype)
        getattr(library(), "lpr_crop_segm" + _SUFFIX[dtype])(
            _ptr(mask, ctypes.c_ubyte), mask.shape[0], mask.shape[1],
            _ptr(bb, ctypes.c_double), int(bool(has_bbox)), out_size,
            _ptr(out, _CTYPE[dtype]))
        return out

    def crop_boxes(self, images, boxes, cubic, out_size):
        """The face cropper's crop of frames in memory: images (N, H, W, 3)
        uint8 RGB; boxes (N, 4) int pixel (t, l, b, r), exclusive, out of
        the frame allowed (blur-faded reflect101 padding); cubic (N,) bool:
        INTER_CUBIC, else INTER_AREA, to out_size².  Returns (N, out, out,
        3) uint8."""
        images = np.ascontiguousarray(images, np.uint8)
        n, h, w = images.shape[:3]
        if images.shape != (n, h, w, 3):
            raise ValueError(f"crop_boxes takes (N, H, W, 3) uint8, got "
                             f"{images.shape}")
        bx = np.ascontiguousarray(boxes, np.int32).reshape(n, 4)
        cu = np.ascontiguousarray(cubic, np.uint8).reshape(n)
        out = np.empty((n, out_size, out_size, 3), np.uint8)
        failed = self._lib.lpr_crop_boxes_u8(
            self._pool, _ptr(images, ctypes.c_ubyte), n, h, w,
            _ptr(bx, ctypes.c_int), _ptr(cu, ctypes.c_ubyte), out_size,
            _ptr(out, ctypes.c_ubyte))
        if failed:
            raise ValueError(f"crop_boxes: {failed} empty boxes in {bx}")
        return out

    def close(self):
        if getattr(self, "_pool", None):
            self._lib.lpr_destroy(self._pool)
            self._pool = None

    def __del__(self):
        self.close()
