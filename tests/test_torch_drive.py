"""PyTorch port, the drive slice as a whole: a fine-tuned flagship-family
checkpoint written by the JAX package (tiny generator widths, full-width
pose and identity towers) drives the same frames in both packages; the
port's CLI, checkpoint writer and synthetic frames; and the guard that the
port's card path needs neither JAX nor the JAX package's heavy imports."""

import re
import struct
import subprocess
import sys
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from latentpose_tpu import checkpoint as jckpt
from latentpose_tpu.models.discriminators import no_landmarks as jdis_mod
from latentpose_tpu.models.embedders import (
    unsupervised_pose_separate_embResNeXt_segmentation as jemb_mod)
from latentpose_tpu.models.generators import (
    vector_pose_unsupervised_segmentation_noBottleneck as jgen_mod)
from latentpose_tpu.runners import build
from latentpose_tpu.runners import drive as jdrive
from latentpose_tpu_torch import checkpoint as tckpt
from latentpose_tpu_torch import convert
from latentpose_tpu_torch.cli import drive as tcli
from latentpose_tpu_torch.data.synthetic import render_face
from latentpose_tpu_torch.runners import drive as tdrive
from latentpose_tpu_torch.utils.png import write_png
from latentpose_tpu_torch.utils.video import to_uint8

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
IMG = 16
# f32 on the CPU, sums in another order than XLA's (stated in the slice spec)
ATOL = 1e-4


def _args():
    return types.SimpleNamespace(
        generator="vector_pose_unsupervised_segmentation_noBottleneck",
        embedder="unsupervised_pose_separate_embResNeXt_segmentation",
        discriminator="no_landmarks",
        image_size=IMG, in_channels=3, out_channels=3, num_channels=4,
        max_num_channels=16, embed_channels=16, pose_embedding_size=8,
        gen_padding="zero", gen_constant_input_size=4,
        gen_num_residual_blocks=1, norm_layer="in", dis_padding="zero",
        dis_num_blocks=3, num_labels=4, optimizer="Adam", lr_gen=1e-3,
        lr_dis=1e-3, beta1=0.0, average_function="sum", finetune=True,
        iteration=0, set_eval_mode_in_train=False, batch_size=2,
        random_seed=0, compute_dtype="float32", num_devices=1,
        img_dir="images-cropped", data_root="")


class _JitInit:
    """A flax module whose ``init`` is jitted: eager init of the ResNeXt-50
    and MobileNetV2 towers takes tens of seconds on the CPU."""

    def __init__(self, module):
        self._module = module
        self.init = jax.jit(module.init)

    def __getattr__(self, name):
        return getattr(self._module, name)


def jax_finetuned_state():
    """(args, models, state) of a JAX fine-tuned state whose EMA weights and
    BatchNorm statistics differ from their defaults."""
    args = _args()
    models = {
        "embedder": jemb_mod.Wrapper.get_net(args),
        "generator": jgen_mod.Wrapper.get_net(args),
        "discriminator": jdis_mod.Discriminator(
            num_channels=4, max_num_channels=16, embed_channels=16,
            num_blocks=3, image_size=IMG, num_labels=4),
    }
    opt_g, opt_d = build.build_optimizers(args, {"discriminators": jdis_mod})
    state = build.init_train_state(
        args, {k: _JitInit(m) for k, m in models.items()}, opt_g, opt_d,
        jax.random.PRNGKey(0), finetune=True)
    rng = np.random.RandomState(7)

    def jitter(scale, low=None):
        def f(v):
            v = np.asarray(v)
            if low is not None:
                return rng.uniform(low, low + scale, v.shape).astype(v.dtype)
            return v + rng.uniform(-scale, scale, v.shape).astype(v.dtype)
        return f

    state = state.replace(
        ema_params=jax.tree_util.tree_map(jitter(0.05), state.ema_params),
        batch_stats=jax.tree_util.tree_map(jitter(1.0, 0.5),
                                           state.batch_stats))
    return args, models, state


@pytest.fixture(scope="module")
def jax_finetuned(tmp_path_factory):
    """:func:`jax_finetuned_state` and the checkpoint it was saved to."""
    args, models, state = jax_finetuned_state()
    path = jckpt.save_checkpoint(tmp_path_factory.mktemp("jax_ft"), state,
                                 args)
    return args, models, state, path


def _frames(wire):
    rng = np.random.RandomState(8)
    if wire == "uint8":
        return rng.randint(0, 256, (3, IMG, IMG, 3)).astype(np.uint8)
    return rng.rand(3, IMG, IMG, 3).astype(np.float32)


def _port(path, *flags):
    args = tcli.resolve_args([str(path), "--device", "cpu", *flags])
    models, state = tcli.load_finetuned(args, torch.device("cpu"))
    return args, models, state


@pytest.mark.parametrize("wire", ["uint8", "float32"])
def test_drive_matches_jax_from_jax_checkpoint(jax_finetuned, wire):
    args, models, state, path = jax_finetuned
    frames = _frames(wire)
    want_rgbs, want_segm = jdrive.make_drive_fn(models, args)(state, frames)

    targs, tmodels, tstate = _port(path, "--compute_dtype", "float32")
    rgbs, segm = tdrive.make_drive_fn(tmodels, targs)(
        tstate, torch.from_numpy(frames))
    assert rgbs.shape == (3, IMG, IMG, 3) and rgbs.dtype == torch.float32
    np.testing.assert_allclose(rgbs.numpy(), np.asarray(want_rgbs), atol=ATOL)
    np.testing.assert_allclose(segm.numpy(), np.asarray(want_segm), atol=ATOL)


def test_drive_sequence_matches_jax(jax_finetuned):
    """5 frames at batch 2: padded tail, two batches in flight."""
    args, models, state, path = jax_finetuned
    frames = np.random.RandomState(9).rand(5, IMG, IMG, 3).astype(np.float32)
    want = jdrive.drive_sequence(jdrive.make_drive_fn(models, args), state,
                                 frames, batch_size=2)
    targs, tmodels, tstate = _port(path, "--compute_dtype", "float32")
    got = tdrive.drive_sequence(tdrive.make_drive_fn(tmodels, targs), tstate,
                                frames, batch_size=2)
    assert got.shape == (5, IMG, IMG, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_cli_drives_synthetic_to_video(jax_finetuned, tmp_path):
    pytest.importorskip("cv2")
    path = jax_finetuned[3]
    videos = tcli.main([str(path), "--images_paths", "synthetic://3",
                        "--destination", str(tmp_path), "--device", "cpu",
                        "--drive_batch_size", "8"])
    assert [v.name for v in videos] == ["synthetic_3.mp4"]
    assert videos[0].exists() and videos[0].stat().st_size > 0
    # bf16 is the serving default, as in the JAX CLI
    assert tcli.resolve_args([str(path)]).compute_dtype == "bfloat16"


@pytest.mark.parametrize("flags", [["--num_devices", "2"]])
def test_cli_refuses_what_is_not_ported(jax_finetuned, flags, monkeypatch):
    """Multi-device drive is ported (tests/test_torch_parallel.py); two
    ranks on a host with fewer cards are refused, as the JAX package's
    ``create_mesh`` refuses them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="Requested 2 devices, only 1"):
        tcli.resolve_args([str(jax_finetuned[3]), *flags])


def _raw_sequence(root, n_frames=4, canvas=(96, 128)):
    """Rendered faces pasted off-centre on canvases (PNG, so that both
    packages decode the same pixels) in ``root/raw/idA/seq1``, and the
    bbox dict (256-space LTRB of the source) for all frames but the last."""
    h, w = canvas
    seq = root / "raw" / "idA" / "seq1"
    seq.mkdir(parents=True)
    boxes = {}
    for f in range(n_frames):
        face = (render_face(3, f, 40)[0] * 255).astype(np.uint8)
        img = np.full((h, w, 3), 50, np.uint8)
        y, x = 10 + 4 * f, 60 - 6 * f
        img[y:y + 40, x:x + 40] = face
        write_png(seq / f"{f:05d}.png", img)
        if f < n_frames - 1:
            boxes[f] = np.array([x, y, x + 40, y + 40], np.float32) * 256 / h
    np.save(root / "bboxes.npy", {"idA": {"seq1": boxes}}, allow_pickle=True)
    return seq, root / "bboxes.npy"


def _s3fd_weights(root):
    """A seeded S³FD written by the port's inverse converter in the JAX
    layout (``s3fd.npz``); its offset heads scaled down, so that its boxes
    stay near their anchors."""
    from latentpose_tpu_torch.preprocess.s3fd import S3FD
    from latentpose_tpu_torch.utils.weights import flax_from_state_dict
    torch.manual_seed(3)
    net = S3FD()
    with torch.no_grad():
        for i in range(6):
            getattr(net, f"reg{i}").weight.mul_(0.05)
    root.mkdir(exist_ok=True)
    np.savez(root / "s3fd.npz", **flax_from_state_dict(net))
    return root


@pytest.mark.parametrize("source", ["bboxes", "detector"])
def test_inline_crop_matches_jax(tmp_path, monkeypatch, source):
    """drive --crop's frames against the JAX package's
    ``inline_crop_frames``: boxes from the dict (the last frame has none:
    the whole frame), or from a seeded S³FD found through
    $LATENTPOSE_WEIGHTS_DIR; within the C++ crop's bound against cv2's
    (ROADMAP C.5: ~1/255, at most 3.5/255; the seeded detector's boxes are
    anchor-sized, so its crops are mostly the blur-faded pad, where the
    two differ most)."""
    from latentpose_tpu.cli.drive import inline_crop_frames as jax_crop
    seq, bboxes = _raw_sequence(tmp_path)
    if source == "detector":
        bboxes = tmp_path / "none.npy"
        monkeypatch.setenv("LATENTPOSE_WEIGHTS_DIR",
                           str(_s3fd_weights(tmp_path / "weights")))
    args = types.SimpleNamespace(bboxes_dir=str(bboxes), image_size=48,
                                 device="cpu")
    want = jax_crop(str(seq), args)
    got = tcli.inline_crop_frames(seq, args)
    assert got.shape == want.shape == (4, 48, 48, 3)
    assert got.dtype == np.uint8
    err = np.abs(got.astype(np.float32) / 255.0 - want)
    assert err.max() <= 3.5 / 255 and err.mean() < 1.5 / 255


def test_cli_drives_raw_frames_with_crop(jax_finetuned, tmp_path,
                                         monkeypatch):
    """``cli.drive.main --crop --bboxes_dir`` with cv2, PIL and imageio
    unimportable: the generator is given the inline crop's frames."""
    path = jax_finetuned[3]
    seq, bboxes = _raw_sequence(tmp_path)
    with monkeypatch.context() as mp:
        for name in ("cv2", "PIL", "imageio"):
            mp.setitem(sys.modules, name, None)
        written = tcli.main([str(path), "--images_paths", str(seq),
                             "--destination", str(tmp_path / "out"),
                             "--device", "cpu", "--drive_batch_size", "2",
                             "--crop", "--bboxes_dir", str(bboxes)])
    files = sorted(Path(f"{written[0]}.frames").glob("*.png"))
    args, models, state = _port(path, "--crop", "--bboxes_dir", str(bboxes))
    frames = tcli.inline_crop_frames(seq, args)
    results = tdrive.drive_sequence(tdrive.make_drive_fn(models, args),
                                    state, frames, batch_size=2)
    assert len(files) == len(frames) == 4
    for file, driver, result in zip(files, frames, results):
        np.testing.assert_array_equal(
            _read_png(file), to_uint8(np.concatenate(
                [driver.astype(np.float32) / 255.0, result], 1)))


def _read_png(path):
    """(H, W, 3) uint8 of a PNG from the port's encoder (8-bit RGB, every
    row unfiltered), read with zlib alone."""
    data, pos, idat = Path(path).read_bytes(), 8, b""
    while pos < len(data):
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        if kind == b"IHDR":
            w, h, depth, colour = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + size
    assert (depth, colour) == (8, 2)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("quantize", ["", "int8", "int8_static"])
def test_cli_writes_frames_without_cv2_pil_or_imageio(jax_finetuned, tmp_path,
                                                      monkeypatch, quantize):
    """``cli.drive.main`` on an image directory with cv2, PIL and imageio
    unimportable, as on the machine with the card: the driver frames decode
    through the C++ loader, the video writer falls back to a directory of
    PNG frames written by the port's own encoder, and each frame is the
    driver beside ``drive_sequence``'s result through ``to_uint8`` (int8:
    dynamic scales; int8_static: calibrated on the sequence's leading
    frames first)."""
    path = jax_finetuned[3]
    source = tmp_path / "driver"
    source.mkdir()
    for f in range(5):
        img, _ = render_face(2, f, 2 * IMG)
        write_png(source / f"{f:05d}.png", (img * 255).astype(np.uint8))
    flags = ["--quantize", quantize] if quantize else []
    with monkeypatch.context() as mp:
        for name in ("cv2", "PIL", "imageio"):
            mp.setitem(sys.modules, name, None)
        written = tcli.main([str(path), "--images_paths", str(source),
                             "--destination", str(tmp_path / "out"),
                             "--device", "cpu", "--drive_batch_size", "2",
                             *flags])
    files = sorted(Path(f"{written[0]}.frames").glob("*.png"))

    args, models, state = _port(path, *flags)
    frames = tcli.load_driver_frames(source, IMG)
    calib = None if quantize != "int8_static" else \
        tdrive.calibrate_quant_scales(models, args, state,
                                      frames[:args.calibration_frames], 2)
    results = tdrive.drive_sequence(
        tdrive.make_drive_fn(models, args, quant_calib=calib), state, frames,
        batch_size=2)
    assert len(files) == len(frames) == 5
    for file, driver, result in zip(files, frames, results):
        np.testing.assert_array_equal(
            _read_png(file), to_uint8(np.concatenate([driver, result], 1)))


def test_checkpoint_keys_neither_read_nor_skipped_are_an_error(jax_finetuned):
    path = jax_finetuned[3]
    args = tcli.resolve_args([str(path), "--device", "cpu"])
    flat = tckpt.load_arrays(path)
    models = [tcli.registry.load_wrapper(kind, name).get_net(args)
              for kind, name in (("embedders", args.embedder),
                                 ("generators", args.generator))]
    convert.load_drive_weights(flat, *models)     # the real key set loads
    extra = dict(flat, **{"params::generator::extra::kernel": np.zeros(1)})
    with pytest.raises(ValueError, match="neither reads nor skips"):
        convert.load_drive_weights(extra, *models)
    missing = {k: v for k, v in flat.items()
               if k != "ema_params::generator::head_conv::kernel"}
    with pytest.raises(KeyError, match="head_conv"):
        convert.load_drive_weights(missing, *models)


def test_port_writer_writes_the_jax_layout(jax_finetuned, tmp_path):
    """The port's modules exported and written by the port's writer give a
    checkpoint whose every key and shape the JAX checkpoint has, and which
    loads back into the same weights."""
    path = jax_finetuned[3]
    args, models, state = _port(path, "--compute_dtype", "float32")
    flat = {}
    for part in ("embedder", "generator"):
        flat.update(convert.export(models[part], part))
    flat["ema_params::finetune_embedding"] = \
        state["finetune_embedding"].numpy()
    with np.load(Path(path) / "arrays.npz") as raw:
        for key, arr in flat.items():
            assert key in raw.files, key
            assert raw[key].shape == arr.shape, key
    out = tckpt.save_checkpoint(tmp_path, flat, dict(vars(args)),
                                iteration=5, finetune=True)
    assert out.name == "model_00000005.ckpt"
    args2, models2, state2 = _port(out, "--compute_dtype", "float32")
    for part in ("embedder", "generator"):
        for key, value in models[part].state_dict().items():
            torch.testing.assert_close(models2[part].state_dict()[key], value,
                                       rtol=0, atol=0)
    assert torch.equal(state2["finetune_embedding"],
                       state["finetune_embedding"])


@pytest.mark.parametrize("label,frame,size", [(3, 0, 32), (7, 13, 64),
                                              (0, 31, 256)])
def test_render_face_is_bit_identical(label, frame, size):
    from latentpose_tpu.data.synthetic import _render_face_uncached
    from latentpose_tpu_torch.data.synthetic import render_face
    want_img, want_segm = _render_face_uncached(label, frame, size)
    img, segm = render_face(label, frame, size)
    assert img.dtype == want_img.dtype and segm.dtype == want_segm.dtype
    np.testing.assert_array_equal(img, want_img)
    np.testing.assert_array_equal(segm, want_segm)


FORBIDDEN = ("jax", "flax", "optax", "yaml", "cv2", "PIL", "imageio", "pandas",
             "latentpose_tpu")


def test_card_path_imports_no_jax():
    """Every module of the port imports with jax, flax, optax, yaml, cv2,
    PIL, imageio and pandas made unimportable (the card's path needs none of them),
    and with the JAX package unimportable too: the port stands on its
    own."""
    code = "\n".join([
        "import sys, pkgutil, importlib",
        *[f"sys.modules[{m!r}] = None" for m in FORBIDDEN],
        "import latentpose_tpu_torch as pkg",
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):",
        "    importlib.import_module(m.name)",
        "import latentpose_tpu_torch.cli.drive, latentpose_tpu_torch.ops.adain",
        "import latentpose_tpu_torch.cli.train, latentpose_tpu_torch.ops.conv_bn",
        "import latentpose_tpu_torch.runners.holycow",
        "import latentpose_tpu_torch.data.augmentation",
        "import latentpose_tpu_torch.losses.dis_embed",
        "import latentpose_tpu_torch.runners.drive",
        "import latentpose_tpu_torch.ops.quant",
        "import latentpose_tpu_torch.data.native_loader",
        "import latentpose_tpu_torch.data.voxceleb2_segmentation_nolandmarks",
        "import latentpose_tpu_torch.data.pipeline",
        "import latentpose_tpu_torch.runners.loop",
        "import latentpose_tpu_torch.utils.logging_writer",
        "import latentpose_tpu_torch.utils.weights",
        "import latentpose_tpu_torch.ops.resize",
        "import latentpose_tpu_torch.preprocess.s3fd",
        "import latentpose_tpu_torch.preprocess.croppers",
        "import latentpose_tpu_torch.preprocess.readers",
        "import latentpose_tpu_torch.preprocess.graphonomy",
        "import latentpose_tpu_torch.preprocess.segmentation",
        "import latentpose_tpu_torch.eval.fan",
        "import latentpose_tpu_torch.eval.backends",
        "import latentpose_tpu_torch.cli.crop_as_in_dataset",
        "import latentpose_tpu_torch.cli.preprocess_dataset",
        "import latentpose_tpu_torch.cli.export",
        "import latentpose_tpu_torch.cli.convert_reference_checkpoint",
        "import latentpose_tpu_torch.reference_checkpoint",
        "import latentpose_tpu_torch.models.generators."
        "vector_pose_unsupervised_segmentation_noBottleneck",
        "print('imported', len(sys.modules))",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout
    # nor inside a function, where the import guard cannot see it
    # (`latentpose_tpu\b` leaves `latentpose_tpu_torch` alone)
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|latentpose_tpu)\b", re.M)
    sources = [*(REPO / "latentpose_tpu_torch").rglob("*.py"),
               REPO / "chip_smoke.py"]
    for src in sources:
        assert not pattern.search(src.read_text()), src
