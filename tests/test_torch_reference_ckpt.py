"""PyTorch port, the reference's checkpoints without JAX
(``latentpose_tpu_torch/reference_checkpoint.py``): a reference-shaped
``model_XXXXXXXX.pth`` at 256² (``tools/fabricate_reference_checkpoint.py``,
meta-trained and fine-tuned) converted by the port's CLI equals the
converter tool's checkpoint array for array, loads whole into the port's
train state and drive modules, and drives."""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from latentpose_tpu.checkpoint import _flatten
from latentpose_tpu_torch import checkpoint as tckpt
from latentpose_tpu_torch import convert
from latentpose_tpu_torch.cli import convert_reference_checkpoint as tconv
from latentpose_tpu_torch.cli import drive as tdrive_cli
from latentpose_tpu_torch.cli import train as ttrain_cli
from latentpose_tpu_torch.runners import drive as tdrive
from latentpose_tpu_torch.utils.png import write_png

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from convert_torch_weights import convert_reference_checkpoint  # noqa: E402
from fabricate_reference_checkpoint import fabricate  # noqa: E402

torch.set_num_threads(1)


def test_flatten_matches_the_jax_flatten():
    tree = {"step": np.int32(3),
            "params": {"a": {"kernel": np.ones((2, 3), np.float32),
                             "bias": np.zeros(3, np.float16)},
                       "finetune_embedding": np.arange(4.0)},
            "spectral": {"embedder": {}, "g": {"u": [1.0, 2.0]}},
            "none": None, "empty": {}}
    want, got = _flatten(tree), tckpt.flatten(tree)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])


@pytest.fixture(scope="module", params=["meta", "finetuned"])
def converted(request, tmp_path_factory):
    """(form, the port's checkpoint, the tool's checkpoint) of one
    fabricated 256² reference file; all of it deleted after the form's
    tests (about 0.6 GB a file)."""
    root = tmp_path_factory.mktemp(request.param)
    pth = fabricate(root / "model_00001230.pth", image_size=256,
                    iteration=1230, seed=3,
                    finetune=request.param == "finetuned")
    port = tconv.main([str(pth), str(root / "port")])
    convert_reference_checkpoint(pth, root / "tool")
    pth.unlink()
    yield request.param, port, root / "tool"
    shutil.rmtree(root, ignore_errors=True)


def test_port_conversion_equals_the_tool(converted):
    form, port, tool = converted
    with np.load(port / "arrays.npz") as got, \
            np.load(tool / "arrays.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            a, b = got[key], want[key]
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert np.array_equal(a, b), key
        finetuned = "params::finetune_embedding" in want.files
    assert finetuned == (form == "finetuned")
    assert json.loads((port / "meta.json").read_text()) == \
        json.loads((tool / "meta.json").read_text())


def test_train_state_reads_every_key(converted):
    """``cli.train``'s loader takes the converted checkpoint whole
    (``convert.load_train_state`` raises on a key it neither reads nor
    skips)."""
    form, port, _ = converted
    flags = ["--finetune"] if form == "finetuned" else []
    args = ttrain_cli.resolve_args(["--checkpoint_path", str(port),
                                    "--device", "cpu", *flags])
    state = ttrain_cli.load_checkpoint(args, torch.device("cpu"))
    assert state.step == 1230 and state.finetune == (form == "finetuned")
    assert args.num_labels == (1 if form == "finetuned" else 100)


@pytest.mark.parametrize("converted", ["finetuned"], indirect=True)
def test_drive_reads_every_key_but_the_skip_list(converted):
    """Drive's loader reads the EMA weights and the identity; every other
    key is a shadowed non-EMA copy or on ``convert.SKIPPED``."""
    _, port, _ = converted
    args = tdrive_cli.resolve_args([str(port), "--device", "cpu"])
    models, state = tdrive_cli.load_finetuned(args, torch.device("cpu"))
    flat = tckpt.load_arrays(port)
    np.testing.assert_array_equal(state["finetune_embedding"].numpy(),
                                  flat["ema_params::finetune_embedding"])
    skipped = [k for k in flat if convert.SKIPPED.fullmatch(k)]
    assert skipped and all(k == "step" or "discriminator" in k
                           for k in skipped)


@pytest.mark.parametrize("converted", ["finetuned"], indirect=True)
def test_converted_checkpoint_drives(converted, tmp_path, monkeypatch):
    """Two frames at 256², f32 on the CPU, through ``cli.drive.main`` (the
    reference's args carry no ``data_root``) with cv2, PIL and imageio
    unimportable, and through the drive CLI's functions."""
    _, port, _ = converted
    frames = tdrive_cli.load_driver_frames("synthetic://3", 256)[:2]
    source = tmp_path / "driver"
    source.mkdir()
    for i, frame in enumerate(frames):
        write_png(source / f"{i:05d}.png", (frame * 255).astype(np.uint8))
    with monkeypatch.context() as mp:
        for name in ("cv2", "PIL", "imageio"):
            mp.setitem(sys.modules, name, None)
        written = tdrive_cli.main([
            str(port), "--images_paths", str(source), "--destination",
            str(tmp_path / "out"), "--device", "cpu", "--compute_dtype",
            "float32", "--drive_batch_size", "2"])
    assert len(list(Path(f"{written[0]}.frames").glob("*.png"))) == 2
    args = tdrive_cli.resolve_args([str(port), "--device", "cpu",
                                    "--compute_dtype", "float32"])
    models, state = tdrive_cli.load_finetuned(args, torch.device("cpu"))
    out = tdrive.drive_sequence(tdrive.make_drive_fn(models, args), state,
                                frames, batch_size=2)
    assert out.shape == (2, 256, 256, 3) and np.isfinite(out).all()
    assert out.std() > 0
