"""PyTorch port, the uint8 wire (``--transfer_dtype uint8``) held against the
JAX package, bit for bit, and the train CLI's bf16 + uint8 runs.

The wire sends each image array to the device as ``uint8(x * 255 + 0.5)``
and the step divides by 255 on the device.  Every piece is held bit-equal,
with no tolerance: the host's quantize and dequantize and the step's device
dequantize against the JAX package's functions (edge values included); the
C++ loader's uint8 entries against the JAX loader's ``load_cropped_u8`` and
against the wire's quantization of the port's own f32 entries; the VoxCeleb2
dataset's uint8 items; the synthetic loader's uint8 render cache against the
JAX package's; and one f32 train step from a uint8 batch against the same
step from the f32 batch that the host's dequantize gives.

The CLI cases meta-train and fine-tune two steps each with ``--compute_dtype
bfloat16 --transfer_dtype uint8`` at tiny widths, on the synthetic loader
and on the VoxCeleb2 tree of ``tests/test_torch_data.py``, resume each run
in the same modes, and read the checkpoints with the JAX package's reader.
The JAX package's C++ loader comes from that module's private build
(:func:`private_jax_loader`); the embedder's towers are cut to one block a
stage, as in ``tests/test_torch_metatrain.py``.
"""

import copy
import shutil

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from latentpose_tpu import checkpoint as jckpt
from latentpose_tpu.checkpoint import _flatten
from latentpose_tpu.data import native_loader as jnative
from latentpose_tpu.data import synthetic as jsynth
from latentpose_tpu.data import voxceleb2_segmentation_nolandmarks as jds
from latentpose_tpu.runners import holycow as jholycow
from latentpose_tpu.runners import loop as jloop
from latentpose_tpu_torch import convert
from latentpose_tpu_torch.cli import train as tcli
from latentpose_tpu_torch.data import native_loader as tnative
from latentpose_tpu_torch.data import synthetic as tsynth
from latentpose_tpu_torch.data import voxceleb2_segmentation_nolandmarks as tds
from latentpose_tpu_torch.runners import holycow as tholycow
from latentpose_tpu_torch.runners import loop as tloop

from test_torch_data import (_args, _frames,  # noqa: F401 (fixtures)
                             private_jax_loader, tree)
from test_torch_metatrain import _shallow_towers  # noqa: F401 (autouse)

torch.set_num_threads(1)

CPU = torch.device("cpu")
# the edges of the wire's rounding: both ends, and the two half-steps that
# round up
EDGES = np.array([0.0, 1.0, 0.5 / 255, 254.5 / 255, 0.49 / 255, 1e-7,
                  0.999], np.float32)
TINY = ["--image_size", "32", "--num_channels", "4", "--max_num_channels",
        "16", "--embed_channels", "16", "--pose_embedding_size", "8",
        "--dis_num_blocks", "3", "--gen_num_residual_blocks", "1",
        "--batch_size", "2", "--num_enc_frames", "2"]
MODES = ["--compute_dtype", "bfloat16", "--transfer_dtype", "uint8"]


def _images(seed, shape=(2, 3, 8, 8, 3)):
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    x.flat[:len(EDGES)] = EDGES
    return x


def _batch(seed):
    return {"enc_rgbs": _images(seed),
            "pose_input_rgbs": _images(seed + 1, (2, 1, 8, 8, 3)),
            "target_rgbs": _images(seed + 2, (2, 1, 8, 8, 3)),
            "real_segm": _images(seed + 3, (2, 1, 8, 8, 1)),
            "label": np.array([3, 1], np.int32),
            "other": np.linspace(0, 1, 5, dtype=np.float32)}


def _assert_same(got, want):
    assert set(got) == set(want)
    for key in want:
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


# --- quantize, dequantize -----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_batch_u8_is_the_jax_packages(seed):
    """The image keys become the same bytes (the edges round as JAX rounds
    them); labels and other keys pass untouched."""
    batch = _batch(seed)
    got = tloop.quantize_batch_u8(batch)
    _assert_same(got, jloop.quantize_batch_u8(batch))
    edges = got["enc_rgbs"].flat[:len(EDGES)]
    np.testing.assert_array_equal(edges, [0, 255, 1, 255, 0, 0, 255])
    assert got["other"] is batch["other"]
    _assert_same(tloop.quantize_batch_u8(got), got)     # bytes stay bytes


def test_dequantize_batch_host_is_the_jax_packages():
    """Every byte value, and a batch that holds other dtypes."""
    every = np.arange(256, dtype=np.uint8).reshape(4, 8, 8, 1)
    batch = {**tloop.quantize_batch_u8(_batch(2)), "all": every}
    _assert_same(tloop.dequantize_batch_host(batch),
                 jloop.dequantize_batch_host(batch))
    assert tloop.dequantize_batch_host(batch)["all"].dtype == np.float32


def test_device_dequantize_is_the_jax_packages():
    """The step's dequantize (true division on the device, here the CPU)
    against the JAX step's ``dequantize_batch`` and the host's inverse."""
    every = np.arange(256, dtype=np.uint8).reshape(4, 8, 8, 1)
    wire = {**tloop.quantize_batch_u8(_batch(3)), "all": every}
    want = jholycow.dequantize_batch({k: jnp.asarray(v)
                                      for k, v in wire.items()})
    got = tholycow.dequantize({k: torch.from_numpy(np.asarray(v))
                               for k, v in wire.items()})
    _assert_same({k: v.numpy() for k, v in got.items()},
                 {k: np.asarray(v) for k, v in want.items()})
    _assert_same({k: v.numpy() for k, v in got.items()},
                 tloop.dequantize_batch_host(wire))


# --- the C++ loader and the VoxCeleb2 dataset ---------------------------------

def _boxes(tree, paths):
    loader = jds.SegmSampleLoader(tree, "images-cropped",
                                  bboxes_dir=tree / "bboxes.npy")
    boxes = [loader._bbox_for(f"{p.parent.parent.name}/{p.parent.name}",
                              p.stem) for p in paths]
    return (np.asarray([b[:4] for b in boxes], np.float64),
            np.asarray([b[4] for b in boxes], np.uint8))


@pytest.mark.parametrize("size", [32, 160])
def test_load_cropped_u8_is_the_jax_loaders(tree, size):
    """Every frame of the tree (JPEG and PNG, padded crops and not): the
    port's uint8 entry gives the JAX loader's ``load_cropped_u8`` bytes, and
    both are the wire's quantization of the port's f32 entry."""
    paths = _frames(tree)
    bb, flags = _boxes(tree, paths)
    want, wf = jnative.NativeBatchLoader(2).load_cropped_u8(paths, bb, flags,
                                                            size)
    port = tnative.NativeBatchLoader(2)
    got, gf = port.load_cropped(paths, bb, flags, size, np.uint8)
    f32, ff = port.load_cropped(paths, bb, flags, size)
    assert wf == gf == ff == 0 and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tloop.quantize_batch_u8({"enc_rgbs": f32})["enc_rgbs"])


def test_uint8_mask_entries_quantize_the_f32_ones(tree):
    """The masks' uint8 entries (PNG masks, and a mask given as an array)
    are the wire's quantization of the f32 entries; a missing file is
    counted and zeroed."""
    masks = sorted((tree / "segmentation-cropped").rglob("*.png"))
    bb, flags = _boxes(tree, masks)
    port = tnative.NativeBatchLoader(2)
    f32, ff = port.load_segm(masks, bb, flags, 40)
    u8, uf = port.load_segm(masks, bb, flags, 40, np.uint8)
    assert ff == uf == 0 and u8.dtype == np.uint8
    np.testing.assert_array_equal(u8, (f32 * 255.0 + 0.5).astype(np.uint8))
    mask = np.load(next((tree / "segmentation-cropped").rglob("*.npy")))
    for has in (0, 1):
        f32 = port.crop_segm(mask[..., 0], bb[0], has, 24)
        u8 = port.crop_segm(mask[..., 0], bb[0], has, 24, np.uint8)
        np.testing.assert_array_equal(u8, (f32 * 255 + 0.5).astype(np.uint8))
    zeros, failed = port.load_cropped([tree / "missing.png"], bb[:1],
                                      flags[:1], 16, np.uint8)
    assert failed == 1 and not zeros.any()


@pytest.mark.parametrize("finetune", [False, True], ids=["meta", "finetune"])
def test_dataset_items_on_the_wire(tree, finetune):
    """The dataset under ``--transfer_dtype uint8``: images and mask the
    wire's quantization of its f32 items (the same frame draw), the target
    the JAX dataset's ``_masked_target`` of the uint8 image and mask."""
    over = dict(train_split_path="id00001/videoA", finetune=True) \
        if finetune else {}
    f32 = tds.Wrapper.get_dataloader(_args(tree, **over), "train").dataset
    u8 = tds.Wrapper.get_dataloader(
        _args(tree, transfer_dtype="uint8", **over), "train").dataset
    for index in range(len(f32)):
        (fd, ft), (ud, ut) = f32[index], u8[index]
        want = tloop.quantize_batch_u8({**fd, **ft})
        for key in ("enc_rgbs", "pose_input_rgbs", "real_segm"):
            got = {**ud, **ut}[key]
            assert got.dtype == np.uint8, key
            np.testing.assert_array_equal(got, want[key], err_msg=key)
        np.testing.assert_array_equal(
            ud["target_rgbs"], jds.VoxCeleb2SegmDataset._masked_target(
                ud["pose_input_rgbs"], ut["real_segm"]))
        assert ut["label"] == ft["label"]


# --- the synthetic loader -----------------------------------------------------

@pytest.mark.parametrize("label,frame,size", [(0, 0, 32), (3, 17, 48),
                                              (5, 40, 64)])
def test_synthetic_u8_render_is_the_jax_packages(label, frame, size):
    got = tsynth.render_face_u8(label, frame, size)
    want = jsynth.render_face_u8(label, frame, size)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    img, segm = tsynth.render_face(label, frame, size)
    np.testing.assert_array_equal(
        got[2], tloop.quantize_batch_u8({"target_rgbs": img * segm})
        ["target_rgbs"])


@pytest.mark.parametrize("finetune", [False, True], ids=["meta", "finetune"])
def test_synthetic_loader_on_the_wire(finetune):
    """The port's uint8 batches are the JAX loader's uint8 batches and the
    wire's quantization of the port's f32 batches, over two epochs."""
    kw = dict(num_labels=5, num_enc_frames=3, finetune=finetune, seed=4)
    want = jsynth.SyntheticDataLoader(image_size=32, batch_size=2,
                                      wire_dtype="uint8", **kw)
    got = tsynth.SyntheticDataLoader(32, 2, wire_dtype="uint8", **kw)
    f32 = tsynth.SyntheticDataLoader(32, 2, **kw)
    for _ in range(2):
        for (wd, wt), (gd, gt), (fd, ft) in zip(list(want), list(got),
                                                list(f32)):
            _assert_same({**gd, **gt}, {**wd, **wt})
            _assert_same({**gd, **gt}, tloop.quantize_batch_u8({**fd, **ft}))


# --- the step and the prefetch ------------------------------------------------

def _tiny_args(workdir, *flags):
    return tcli.resolve_args([
        "--config_name", "default", "--dataloader", "synthetic", "--device",
        "cpu", "--allow_random_vgg", "--synthetic_num_labels", "2",
        "--experiments_dir", str(workdir), *TINY, *flags])


def test_f32_step_from_a_uint8_batch_is_the_dequantized_batchs(tmp_path):
    """One f32 meta step (the three augmentations on: the step dequantizes,
    then augments) from the wire's batch and one from the batch the host's
    dequantize gives leave bit-equal states and losses."""
    args = _tiny_args(tmp_path)
    assert args.use_pixelwise_augs and args.use_affine_scale
    loader = tcli.build_dataloader(args)
    wire = tloop.quantize_batch_u8({**loader.get_batch(0)[0],
                                    **loader.get_batch(0)[1]})
    host = tloop.dequantize_batch_host(wire)
    criteria = tcli.build_criteria(args, CPU)
    results = []
    for batch in (wire, host):
        state = tcli.init_state(copy.copy(args), loader, CPU)
        step = tcli.make_step(args, criteria)
        scalars = step(state, tholycow.to_device((batch, {}), CPU,
                                                 tholycow.META_STEP_KEYS))
        results.append((scalars, convert.export_train_state(state)))
    (ws, wstate), (hs, hstate) = results
    assert set(ws) == set(hs)
    for key in ws:
        assert torch.equal(ws[key], hs[key]), key
    _assert_same(wstate, hstate)


def test_device_prefetch_sends_bytes():
    """With ``transfer_dtype`` uint8 the producer quantizes an f32 loader's
    batches: the device batch holds the wire's bytes, labels as int64; the
    host batch stays as the loader gave it."""
    batches = [(_batch(5), {}), (_batch(6), {})]
    keys = ("enc_rgbs", "target_rgbs", "real_segm", "label")
    got = list(tloop.device_prefetch(batches, CPU, keys,
                                     transfer_dtype="uint8"))
    assert len(got) == 2
    for (host, batch), (data, _) in zip(got, batches):
        want = tloop.quantize_batch_u8(data)
        for key in keys[:-1]:
            assert batch[key].dtype == torch.uint8
            np.testing.assert_array_equal(batch[key].numpy(), want[key])
        assert batch["label"].dtype == torch.int64
        assert host["enc_rgbs"].dtype == np.float32


# --- the CLI ------------------------------------------------------------------

def _peek_modes(path):
    args = jckpt.peek_args(path)
    return args["compute_dtype"], args["transfer_dtype"]


def _read_with_jax(path):
    """The JAX package's reader: the nested state, every float leaf f32,
    flattened back to ``::`` keys; the args."""
    arrays = _flatten(jckpt.load_arrays(path))
    assert arrays and all(v.dtype == np.float32 for v in arrays.values()
                          if v.dtype.kind == "f")
    assert _peek_modes(path) == ("bfloat16", "uint8")
    return arrays


@pytest.mark.parametrize("where", ["synthetic", "voxceleb2"])
def test_cli_trains_in_bf16_on_the_wire_and_resumes(where, tree, tmp_path):
    """``main`` with ``--compute_dtype bfloat16 --transfer_dtype uint8``:
    two meta steps, a resume that takes two more in the same modes (its
    args from the checkpoint alone), then two fine-tune steps from the
    result and a resume of the fine-tuned checkpoint, each checkpoint read
    by the JAX package's reader; on the synthetic loader (4 identities) and
    on the VoxCeleb2 tree (4 of its videos; fine-tune on one video's 6
    frames at batch 3)."""
    common = ["--device", "cpu", "--allow_random_vgg", "--experiments_dir",
              str(tmp_path), "--num_epochs", "1"]
    if where == "synthetic":
        data = ft_data = ["--dataloader", "synthetic",
                          "--synthetic_num_labels", "4"]
        ft_batch = "2"
    else:
        split = tmp_path / "train4.csv"
        rows = (tree / "train.csv").read_text().splitlines()
        split.write_text("\n".join(rows[:5]) + "\n")
        vox = ["--dataloader", "voxceleb2_segmentation_nolandmarks",
               "--data_root", str(tree), "--bboxes_dir",
               str(tree / "bboxes.npy"), "--num_workers", "1"]
        data = vox + ["--train_split_path", str(split)]
        ft_data = vox + ["--train_split_path", "id00001/videoA"]
        ft_batch = "3"
    seen = []
    step = tholycow.make_train_step

    def recording(criteria, args):
        fn = step(criteria, args)

        def wrapped(state, batch):
            seen.append((args.compute_dtype, args.transfer_dtype,
                         {k: v.dtype for k, v in batch.items()
                          if k != "label"}))
            return fn(state, batch)
        return wrapped

    tholycow.make_train_step = recording
    try:
        # --num_enc_frames is the synthetic loader's: the VoxCeleb2 run's
        # selection does not register it (refused, as by the JAX CLI)
        tiny = TINY if where == "synthetic" else TINY[:-2]
        state, path = tcli.main(["--config_name", "default", *data, *common,
                                 *tiny, *MODES])
        assert state.step == 2 and not state.finetune
        _read_with_jax(path)
        state, path = tcli.main([*data, *common, "--checkpoint_path",
                                 str(path)])
        assert state.step == 4 and not state.finetune
        _read_with_jax(path)
        state, ft_path = tcli.main([
            "--finetune", "--config_name", "finetuning-base", *ft_data,
            *common, "--checkpoint_path", str(path), "--batch_size",
            ft_batch, *MODES])
        assert state.finetune and state.step == 6
        assert state.finetune_embedding.dtype == torch.float32
        _read_with_jax(ft_path)
        state, ft_path = tcli.main(["--finetune", *ft_data, *common,
                                    "--checkpoint_path", str(ft_path)])
        assert state.finetune and state.step == 8
        assert "params::finetune_embedding" in _read_with_jax(ft_path)
    finally:
        tholycow.make_train_step = step
        for checkpoints in list(tmp_path.rglob("checkpoints")):
            shutil.rmtree(checkpoints)          # ~100 MB a checkpoint
    assert len(seen) == 8
    for compute, transfer, dtypes in seen:
        assert (compute, transfer) == ("bfloat16", "uint8")
        assert set(dtypes.values()) == {torch.uint8}, dtypes
    for p in [*state.models["generator"].parameters(),
              *state.models["embedder"].parameters()]:
        assert p.dtype == torch.float32


def test_cli_takes_only_the_two_dtypes_of_each_flag(tmp_path, capsys):
    # --compute_dtype has the JAX core parser's choices, so argparse
    # refuses it; --transfer_dtype (the runner's, no choices) the CLI
    with pytest.raises(SystemExit):
        _tiny_args(tmp_path, "--compute_dtype", "float16")
    assert "invalid choice: 'float16'" in capsys.readouterr().err
    with pytest.raises(ValueError, match="one of"):
        _tiny_args(tmp_path, "--transfer_dtype", "bfloat16")
    args = _tiny_args(tmp_path, *MODES)
    assert (args.compute_dtype, args.transfer_dtype) == ("bfloat16", "uint8")
    assert tcli.build_dataloader(args).get_batch(0)[0]["enc_rgbs"].dtype \
        == np.uint8
