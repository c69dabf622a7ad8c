"""PyTorch port, the checkpoint archive's reader and writer
(``latentpose_tpu_torch/utils/npz.py``) held against numpy's and the JAX
package's: an archive the port writes reads back bit-equal, dtypes, shapes
and order included, through ``np.load``, ``zipfile``'s CRC check and the
JAX package's checkpoint reader; an archive ``np.savez`` writes reads back
bit-equal through the port's reader, lazily or on its pool; a flipped byte
fails the CRC; what the direct reader does not take (compressed members)
reads through ``np.load``."""

import zipfile

import numpy as np
import pytest

from latentpose_tpu import checkpoint as jckpt
from latentpose_tpu_torch import checkpoint as tckpt
from latentpose_tpu_torch.utils import npz


def _arrays():
    rng = np.random.default_rng(5)
    out = {f"params::block{i}::kernel": rng.standard_normal(
        (3, 3, 4 + i, 8), dtype=np.float32) for i in range(12)}
    out.update({
        "step": np.array(7, np.int32), "scalar": np.float32(0.25),
        "count": np.zeros((), np.int64), "flags": np.array([True, False]),
        "empty": np.zeros((0, 3), np.float32),
        "fortran": np.asfortranarray(rng.standard_normal((5, 7))),
        "strided": rng.standard_normal((6, 8))[:, ::2],
        "big_endian": np.arange(6, dtype=">i4").reshape(2, 3),
        "half": np.arange(10, dtype=np.float16),
        "bytes": np.arange(250, dtype=np.uint8).reshape(10, 25),
        "text": np.array(["ab", "cde"]),
        "large": rng.standard_normal(300_000).astype(np.float32)})
    return out


def _same(got, want):
    assert list(got) == list(want)
    for key, value in want.items():
        value = np.asarray(value)
        assert got[key].dtype == value.dtype, key
        assert got[key].shape == value.shape, key
        assert np.array_equal(got[key], value), key


@pytest.mark.parametrize("writer", ["port", "numpy"])
@pytest.mark.parametrize("reader", ["read_npz", "lazy", "np.load"])
def test_archives_read_back_bit_equal(tmp_path, writer, reader):
    arrays, path = _arrays(), tmp_path / "arrays.npz"
    if writer == "port":
        npz.write_npz(path, arrays)
    else:
        np.savez(path, **arrays)
    if reader == "read_npz":
        got = npz.read_npz(path)
    elif reader == "lazy":
        with npz.NpzArrays(path) as lazy:
            assert "step" in lazy and "absent" not in lazy
            assert lazy.files == list(arrays) and len(lazy) == len(arrays)
            got = {k: lazy[k] for k in reversed(lazy.files)}
            got = {k: got[k] for k in lazy.files}
    else:
        with np.load(path) as raw:
            got = {k: raw[k] for k in raw.files}
    _same(got, arrays)
    with zipfile.ZipFile(path) as archive:
        assert archive.testzip() is None


def test_a_port_checkpoint_reads_in_the_jax_package(tmp_path):
    arrays = {k: v for k, v in _arrays().items() if "::" in k}
    arrays["step"] = np.array(3, np.int32)
    path = tckpt.save_checkpoint(tmp_path, arrays, {"lr_gen": 1e-3}, 3,
                                 finetune=False)
    nested = jckpt.load_arrays(path)
    assert int(nested["step"]) == 3
    for key, value in arrays.items():
        node = nested
        for part in key.split("::"):
            node = node[part]
        assert np.array_equal(node, value) and node.dtype == value.dtype
    _same(tckpt.load_arrays(path), arrays)
    with tckpt.open_arrays(path) as lazy:
        assert np.array_equal(lazy["step"], arrays["step"])


def test_a_flipped_byte_fails_the_crc(tmp_path):
    path = tmp_path / "arrays.npz"
    npz.write_npz(path, {"a": np.arange(1000, dtype=np.float32)})
    raw = bytearray(path.read_bytes())
    raw[1000] ^= 1
    path.write_bytes(bytes(raw))
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        npz.read_npz(path)


def test_compressed_members_read_through_numpy(tmp_path):
    path = tmp_path / "packed.npz"
    want = {"a": np.arange(12).reshape(3, 4), "b": np.ones(5, np.float32)}
    np.savez_compressed(path, **want)
    _same(npz.read_npz(path), want)
