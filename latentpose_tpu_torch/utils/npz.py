"""An ``.npz`` reader and writer for checkpoint-sized archives.

``np.load`` reads a member of an archive in 256 KiB chunks through
``zipfile`` (a Python call, a copy and a CRC update each), and ``np.savez``
writes it through a 16 MiB buffered copy with the CRC computed inline.  For
the stored (uncompressed) members that ``np.savez`` writes, these functions
read each member with one ``preadv`` into its array and write it with one
``write`` from its buffer, the CRC-32 of every member checked or computed on
a pool of threads (``zlib.crc32`` releases the GIL).  The files are the
ones ``np.savez`` writes, zip64 included, and read back bit-equal with
``np.load``; a member this reader does not handle (compressed, an object
array, an ``.npy`` format version above 2) goes through ``np.load``.
"""

from __future__ import annotations

import concurrent.futures
import io
import os
import struct
import time
import zipfile
import zlib
from collections.abc import Mapping

import numpy as np
from numpy.lib import format as npy_format

_LOCAL = struct.Struct("<4s5H3L2H")       # local file header, 30 bytes
_CENTRAL = struct.Struct("<4s6H3L5H2L")   # central directory header, 46
_ZIP64_EXTRA = struct.Struct("<2H2Q")     # local: sizes
_ZIP64_CENTRAL_EXTRA = struct.Struct("<2H3Q")   # central: sizes, offset
_ZIP64_END = struct.Struct("<4sQ2H2L4Q")
_ZIP64_LOCATOR = struct.Struct("<4sLQL")
_END = struct.Struct("<4s4H2LH")
_FULL = 0xFFFFFFFF
_CHUNK = 1 << 30            # bytes a single read or write asks for


def _threads():
    return min(8, os.cpu_count() or 1)


def _bytes_of(arr):
    """A C-contiguous array's bytes as a flat writable-or-not memoryview."""
    return memoryview(arr.reshape(-1).view(np.uint8))


def _read_into(fd, view, offset):
    done = 0
    while done < len(view):
        got = os.preadv(fd, [view[done:done + _CHUNK]], offset + done)
        if got <= 0:
            raise EOFError(f"short read at byte {offset + done}")
        done += got


class NpzArrays(Mapping):
    """The arrays of an ``.npz`` as a mapping that reads each when it is
    looked up; ``files`` as ``np.load``'s.  Close it (or use it as a
    context manager) to release the file."""

    def __init__(self, path):
        self.path = os.fspath(path)
        with zipfile.ZipFile(self.path) as archive:
            infos = archive.infolist()
        self._infos = {i.filename[:-4] if i.filename.endswith(".npy")
                       else i.filename: i for i in infos}
        self.files = list(self._infos)
        self._fd = os.open(self.path, os.O_RDONLY)

    def __getitem__(self, key):
        info = self._infos[key]
        direct = self._direct(info)
        if direct is None:
            with np.load(self.path) as raw:
                return raw[key]
        data_at, header, shape, fortran, dtype = direct
        arr = np.empty(shape[::-1] if fortran else shape, dtype)
        view = _bytes_of(arr)
        _read_into(self._fd, view, data_at + len(header))
        if zlib.crc32(view, zlib.crc32(header)) != info.CRC:
            raise zipfile.BadZipFile(
                f"Bad CRC-32 for file {info.filename!r} in {self.path}")
        return arr.T if fortran else arr

    def __iter__(self):
        return iter(self.files)

    def __len__(self):
        return len(self.files)

    def __contains__(self, key):
        return key in self._infos

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read_all(self, keys=None) -> dict:
        """``keys`` (default: every array) read on a pool of threads, in
        the archive's order."""
        keys = self.files if keys is None else [k for k in self.files
                                                if k in set(keys)]
        with concurrent.futures.ThreadPoolExecutor(_threads()) as pool:
            return dict(zip(keys, pool.map(self.__getitem__, keys)))

    def _direct(self, info):
        """(offset of the member's data, its .npy header, shape, fortran
        order, dtype) for a member this reader handles, else None."""
        if info.compress_type != zipfile.ZIP_STORED or info.flag_bits & 1 \
                or not info.filename.endswith(".npy"):
            return None
        local = os.pread(self._fd, _LOCAL.size, info.header_offset)
        if len(local) != _LOCAL.size or local[:4] != b"PK\x03\x04":
            raise zipfile.BadZipFile(f"{info.filename!r}: bad local header")
        names, extra = struct.unpack("<2H", local[26:30])
        data_at = info.header_offset + _LOCAL.size + names + extra
        head = io.BytesIO(os.pread(self._fd, min(info.file_size, 1 << 16),
                                   data_at))
        version = npy_format.read_magic(head)
        if version == (1, 0):
            shape, fortran, dtype = npy_format.read_array_header_1_0(head)
        elif version == (2, 0):
            shape, fortran, dtype = npy_format.read_array_header_2_0(head)
        else:
            return None
        if dtype.hasobject:
            return None
        header = head.getvalue()[:head.tell()]
        if len(header) + int(np.prod(shape)) * dtype.itemsize \
                != info.file_size:
            raise zipfile.BadZipFile(f"{info.filename!r}: its size does not "
                                     "match its header")
        return data_at, header, shape, fortran, dtype


def read_npz(path, keys=None) -> dict:
    """Every array of the ``.npz`` at ``path`` (or those of ``keys``), by
    name, as ``np.load`` reads them."""
    with NpzArrays(path) as arrays:
        return arrays.read_all(keys)


def _npy_header(arr) -> bytes:
    fp = io.BytesIO()
    header = npy_format.header_data_from_array_1_0(arr)
    try:
        npy_format.write_array_header_1_0(fp, header)
    except ValueError:
        fp = io.BytesIO()
        npy_format.write_array_header_2_0(fp, header)
    return fp.getvalue()


def write_npz(path, arrays: dict):
    """``np.savez(path, **arrays)``: one stored zip64 member ``<key>.npy``
    per array (C order), readable by ``np.load`` and ``zipfile``."""
    members = []
    for key, value in arrays.items():
        arr = np.asarray(value)
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        if arr.dtype.hasobject:
            np.savez(path, **arrays)
            return
        members.append((key + ".npy", _npy_header(arr), arr))

    def crc(member):
        _, header, arr = member
        return zlib.crc32(_bytes_of(arr), zlib.crc32(header))

    with concurrent.futures.ThreadPoolExecutor(_threads()) as pool:
        crcs = list(pool.map(crc, members))
    now = time.localtime(time.time())
    dos_time = (now.tm_hour << 11) | (now.tm_min << 5) | (now.tm_sec // 2)
    dos_date = ((now.tm_year - 1980) << 9) | (now.tm_mon << 5) | now.tm_mday
    central, offset = [], 0
    with open(path, "wb") as f:
        for (name, header, arr), check in zip(members, crcs):
            raw = name.encode("utf-8")
            size = len(header) + arr.nbytes
            local = _LOCAL.pack(b"PK\x03\x04", 45, 0x800, 0, dos_time,
                                dos_date, check, _FULL, _FULL, len(raw),
                                _ZIP64_EXTRA.size) + raw + _ZIP64_EXTRA.pack(
                1, 16, size, size)
            f.write(local)
            f.write(header)
            view = _bytes_of(arr)
            for start in range(0, len(view), _CHUNK):
                f.write(view[start:start + _CHUNK])
            central.append(_CENTRAL.pack(
                b"PK\x01\x02", 45 | (3 << 8), 45, 0x800, 0, dos_time,
                dos_date, check, _FULL, _FULL, len(raw),
                _ZIP64_CENTRAL_EXTRA.size, 0, 0, 0, 0o600 << 16, _FULL)
                + raw + _ZIP64_CENTRAL_EXTRA.pack(1, 24, size, size, offset))
            offset += len(local) + size
        directory = b"".join(central)
        f.write(directory)
        count = len(central)
        end64_at = offset + len(directory)
        f.write(_ZIP64_END.pack(b"PK\x06\x06", _ZIP64_END.size - 12, 45, 45,
                                0, 0, count, count, len(directory), offset))
        f.write(_ZIP64_LOCATOR.pack(b"PK\x06\x07", 0, end64_at, 1))
        f.write(_END.pack(b"PK\x05\x06", 0, 0, min(count, 0xFFFF),
                          min(count, 0xFFFF), min(len(directory), _FULL),
                          min(offset, _FULL), 0))
