"""PyTorch port, the second half of the ablation families through the
CLIs: X2Face (meta-train with the ``none`` discriminator and ``l1_rgb``,
its identity-image "fine-tune", drive), FAbNet+ and X2Face+ (meta-train
with ragan and rgan, ê and a fine-tune step, drive through the frozen pose
encoder), ``simple_conv`` and ``no_pose_encoder``, ``--quantize``, the
export refusal, and the FFHQ crop through ``crop_as_in_dataset`` and
``preprocess_dataset``.

The checkpoints the port writes are read back by the JAX package array
for array; avatars cross both ways: the port's avatar driven by the JAX
package and a JAX-written avatar driven by the port agree within 1e-4 of
the output's max.  Tiny widths on the CPU (seconds a step; the
pretrained-pose families at 64² with the ResNeXt-50 identity tower cut to
one bottleneck a stage in both packages).  Every checkpoint written is
deleted with its fixture."""

import functools
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from latentpose_tpu import checkpoint as jckpt
from latentpose_tpu import registry as jregistry
from latentpose_tpu.checkpoint import _flatten
from latentpose_tpu.models.embedders import FAbNet_pretrained_embResNeXt \
    as jfab
from latentpose_tpu.models.embedders import X2Face_pretrained_embResNeXt \
    as jx2p
from latentpose_tpu.nn import backbones as jbackbones
from latentpose_tpu.runners import build
from latentpose_tpu.runners import drive as jdrive
from latentpose_tpu.runners import finetune as jft
from latentpose_tpu_torch import checkpoint as tckpt
from latentpose_tpu_torch import registry
from latentpose_tpu_torch.cli import crop_as_in_dataset as tcrop_cli
from latentpose_tpu_torch.cli import drive as tdrive
from latentpose_tpu_torch.cli import export as texport
from latentpose_tpu_torch.cli import preprocess_dataset as tprep
from latentpose_tpu_torch.cli import train as tcli
from latentpose_tpu_torch.eval import backends as tbackends
from latentpose_tpu_torch.models.embedders import \
    unsupervised_pose_separate_embResNeXt_segmentation as tflagship
from latentpose_tpu_torch.nn import backbones as tbackbones
from latentpose_tpu_torch.preprocess import croppers as tcroppers
from latentpose_tpu_torch.runners import drive as tdrive_lib
from latentpose_tpu_torch.utils.png import write_png

torch.set_num_threads(1)

RTOL = 1e-4             # of the output's max
LAYERS = (1, 1, 1, 1)
CPU = ["--device", "cpu"]
SYNTHETIC = ["--dataloader", "synthetic", "--synthetic_num_labels", "4",
             "--num_enc_frames", "2", "--batch_size", "2", "--num_epochs",
             "1"]
TINY_GEN = ["--num_channels", "4", "--max_num_channels", "16",
            "--embed_channels", "16", "--pose_embedding_size", "8",
            "--dis_num_blocks", "3", "--gen_num_residual_blocks", "1"]
X2FACE = ["--embedder", "X2Face", "--generator", "X2Face",
          "--discriminator", "none", "--criterions", "l1_rgb",
          "--image_size", "32", "--optimizer", "Adam"]
FLAGSHIP = ["--generator",
            "vector_pose_unsupervised_segmentation_noBottleneck",
            "--discriminator", "no_landmarks", "--optimizer", "Adam",
            "--criterions", "adversarial, featmat, dis_embed, dice"]


@pytest.fixture(scope="module", autouse=True)
def _shallow_resnext():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jfab, jx2p):
            mp.setattr(mod, "ResNeXt50", functools.partial(
                jbackbones.ResNeXt50, layers=LAYERS))
        mp.setattr(tflagship, "ResNeXt50", functools.partial(
            tbackbones.ResNeXt50, layers=LAYERS))
        yield


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The module's experiments, deleted with it."""
    path = tmp_path_factory.mktemp("ablation_cli")
    yield path
    shutil.rmtree(path, ignore_errors=True)


def _train(argv, workdir, name):
    _, path = tcli.main([*argv, *CPU, "--experiments_dir", str(workdir),
                         "--experiment_name", name])
    return path


class _ShapeInit:
    """A flax module whose ``init`` gives zeros of its variables' shapes
    (traced, not compiled: a restore overwrites every value)."""

    def __init__(self, module):
        self._module = module

    def init(self, *args):
        return jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype),
            jax.eval_shape(self._module.init, *args))

    def __getattr__(self, name):
        return getattr(self._module, name)


def _jax_args(path, **over):
    args = types.SimpleNamespace(**tckpt.peek_args(path))
    arrays = tckpt.load_arrays(path)
    embed = arrays.get("params::discriminator::embed::embedding")
    if embed is not None:
        args.num_labels = int(embed.shape[0])
    for key, value in over.items():
        setattr(args, key, value)
    return args


def _jax_modules(args):
    return {kind: jregistry.load_module(kind, getattr(args, kind[:-1]))
            for kind in ("embedders", "generators", "discriminators")}


def _jax_state(path, finetune_leaves=None, finetune=False):
    """The JAX package's train state of checkpoint ``path`` (its skeleton
    restored), the skeleton, its models and args.  A skeleton is traced
    once a family and structure (``jax.eval_shape`` of each model's init
    takes seconds) and reused for every checkpoint of that structure."""
    args = _jax_args(path)
    key = (args.embedder, args.generator, args.discriminator,
           args.num_labels, args.image_size, finetune,
           tuple(sorted((k, np.shape(v))
                        for k, v in (finetune_leaves or {}).items())))
    if key not in _SKELETONS:
        modules = _jax_modules(args)
        models = build.build_models(args, modules)
        if finetune:
            models["discriminator"] = jft.make_finetune_discriminator(
                modules["discriminators"].Wrapper, args)
        opt_g, opt_d = build.build_optimizers(args, modules)
        _SKELETONS[key] = build.init_train_state(
            args, {k: _ShapeInit(m) for k, m in models.items()}, opt_g,
            opt_d, jax.random.PRNGKey(0), finetune=finetune,
            finetune_leaves=finetune_leaves), models
    skeleton, models = _SKELETONS[key]
    return jckpt.restore_state(path, skeleton), skeleton, models, args


_SKELETONS = {}


def _assert_jax_reads(path):
    """The JAX package restores the port's checkpoint into its own skeleton
    with every array of the file, and nothing else."""
    finetune = tcli.checkpoint_is_finetuned(path)
    leaves = None
    if finetune:
        leaves = {k.split("::")[1]: np.zeros_like(v)
                  for k, v in tckpt.load_arrays(path).items()
                  if k.startswith("params::finetune_")}
    state, skeleton, _, _ = _jax_state(path, leaves, finetune)
    restored = _flatten(serialization.to_state_dict(jax.device_get(state)))
    skeleton = _flatten(serialization.to_state_dict(skeleton))
    saved = tckpt.load_arrays(path)
    assert set(skeleton) == set(saved) == set(restored)
    for key, value in saved.items():
        np.testing.assert_array_equal(np.asarray(restored[key]), value,
                                      err_msg=key)


def _frames(n=4, size=32):
    return np.random.RandomState(n).uniform(0, 1, (n, size, size, 3)) \
        .astype(np.float32)


def _port_drive(path, frames, **over):
    args = tdrive.resolve_args([str(path), "--compute_dtype", "float32",
                                *CPU])
    for key, value in over.items():
        setattr(args, key, value)
    models, state = tdrive.load_finetuned(args, torch.device("cpu"))
    rgbs, _ = tdrive_lib.make_drive_fn(models, args)(
        state, torch.from_numpy(frames))
    return rgbs.numpy()


def _jax_drive(path, frames):
    """The JAX package's drive of avatar ``path`` (EMA weights, f32), its
    state restored as ``cli/drive.py`` ``load_finetuned`` restores it (a
    fine-tune skeleton with the file's per-avatar leaves)."""
    leaves = {k.split("::")[1]: v for k, v in tckpt.load_arrays(path).items()
              if k.startswith("params::finetune_")}
    state, _, models, args = _jax_state(path, leaves, finetune=True)
    args.compute_dtype = "float32"
    key = (args.embedder, args.generator, frames.shape)
    if key not in _JAX_DRIVES:      # one compile a family and shape
        _JAX_DRIVES[key] = jdrive.make_drive_fn(models, args)
    rgbs, _ = _JAX_DRIVES[key](state, jnp.asarray(frames))
    return np.asarray(rgbs)


_JAX_DRIVES = {}


def _close(got, want, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= RTOL, (what, err)


# --- X2Face -------------------------------------------------------------------

@pytest.fixture(scope="module")
def x2face_run(workdir):
    """X2Face: 2 meta steps, the save, the identity-image "fine-tune"."""
    meta = _train([*X2FACE, *SYNTHETIC], workdir, "x2f_meta")
    avatar = _train(["--finetune", "--checkpoint_path", str(meta),
                     "--X2Face_num_identity_images", "2"], workdir,
                    "x2f_avatar")
    return meta, avatar


def test_x2face_cli_trains_and_stores_the_identity_images(x2face_run):
    meta, avatar = x2face_run
    assert tckpt.peek_args(meta)["iteration"] == 2
    before, after = tckpt.load_arrays(meta), tckpt.load_arrays(avatar)
    assert set(after) == set(before) | {"params::finetune_identity_images"}
    for key, value in before.items():
        np.testing.assert_array_equal(after[key], value, err_msg=key)
    images = after["params::finetune_identity_images"]
    assert images.shape == (1, 2, 32, 32, 3) and images.dtype == np.float32
    # the avatar loader's driver frames (the synthetic fine-tune batch)
    args = tcli.resolve_args(["--checkpoint_path", str(meta), "--finetune",
                              *CPU])
    loader = tcli.build_dataloader(args, "train", "train")
    data, _ = next(iter(loader))
    np.testing.assert_array_equal(images[0], data["pose_input_rgbs"][:2, 0])
    # the state stays a meta-train one, as the JAX package saves it
    assert not tcli.checkpoint_is_finetuned(avatar)
    assert not any(k.startswith("opt_state_d") for k in after)


def test_x2face_meta_checkpoint_loads_into_the_jax_package(x2face_run):
    _assert_jax_reads(x2face_run[0])


def test_x2face_avatar_drives_as_in_jax_both_ways(x2face_run, workdir):
    """The port's avatar driven by the JAX package, and a JAX-written
    avatar (the JAX state of the meta checkpoint with identity images
    added) driven by the port."""
    meta, avatar = x2face_run
    frames = _frames()
    _close(_port_drive(avatar, frames), _jax_drive(avatar, frames),
           "port avatar")
    state, _, _, args = _jax_state(meta)
    images = np.random.RandomState(3).uniform(0, 1, (1, 3, 32, 32, 3))
    state = state.replace(params={**state.params,
                                  "finetune_identity_images":
                                  jnp.asarray(images, jnp.float32)})
    written = jckpt.save_checkpoint(workdir / "jax_x2f", state, args)
    _close(_port_drive(written, frames), _jax_drive(written, frames),
           "JAX avatar")


def test_x2face_drive_cli_writes_the_video(x2face_run, workdir):
    videos = tdrive.main([str(x2face_run[1]), "--images_paths",
                          "synthetic://1", "--destination",
                          str(workdir / "x2f_drive"), *CPU])
    assert len(videos) == 1 and videos[0].exists()


def test_x2face_quantize_as_the_jax_cli(x2face_run, workdir):
    """The X2Face generator has no quantized conv: ``--quantize int8``
    drives the exact path, as in the JAX package, and ``int8_static`` has
    nothing to calibrate (the JAX CLI fails there too)."""
    frames = _frames()
    np.testing.assert_array_equal(
        _port_drive(x2face_run[1], frames, quantize="int8"),
        _port_drive(x2face_run[1], frames))
    with pytest.raises(ValueError, match="quantized generator"):
        tdrive.main([str(x2face_run[1]), "--images_paths", "synthetic://1",
                     "--destination", str(workdir / "x2f_int8_static"),
                     "--quantize", "int8_static", *CPU])


def test_export_refuses_an_ablation_avatar(x2face_run):
    with pytest.raises(NotImplementedError, match="A.19"):
        texport.main([str(x2face_run[1]), *CPU])


# --- the pretrained-pose families ---------------------------------------------

@pytest.fixture(scope="module")
def pretrained_runs(workdir):
    """``run(embedder)``: a meta step at 64² (ragan for FAb-Net, rgan for
    X2Face), the save, ê and a fine-tune step, made once an embedder."""
    runs = {}

    def run(embedder):
        if embedder not in runs:
            gan = "ragan" if embedder.startswith("FAbNet") else "rgan"
            meta = _train([*FLAGSHIP, *SYNTHETIC, *TINY_GEN, "--embedder",
                           embedder, "--image_size", "64", "--gan_type",
                           gan], workdir, f"{embedder}_meta")
            ft = _train(["--finetune", "--checkpoint_path", str(meta),
                         "--optimizer", "RAdam", "--criterions",
                         "adversarial, featmat, dice"], workdir,
                        f"{embedder}_ft")
            runs[embedder] = meta, ft
        return runs[embedder]

    return run


PRETRAINED = {"FAbNet_pretrained_embResNeXt": "pose_encoder",
              "X2Face_pretrained_embResNeXt": "pose_unet"}


@pytest.mark.parametrize("embedder", sorted(PRETRAINED))
def test_pretrained_pose_cli_keeps_the_encoder_frozen(pretrained_runs,
                                                      embedder):
    meta, ft = pretrained_runs(embedder)
    args = tckpt.peek_args(meta)
    assert args["gan_type"] in ("rgan", "ragan")
    first = tcli.resolve_args(["--checkpoint_path", str(meta), *CPU])
    init = tcli.init_state(first, types.SimpleNamespace(num_labels=4),
                           torch.device("cpu"))
    from latentpose_tpu_torch import convert
    start = convert.export_train_state(init)
    prefix = PRETRAINED[embedder]
    for path in (meta, ft):
        arrays = tckpt.load_arrays(path)
        frozen = [k for k in arrays if f"::embedder::{prefix}::" in k
                  and k.split("::")[0] in ("params", "batch_stats")]
        assert frozen
        for key in frozen:
            np.testing.assert_array_equal(arrays[key], start[key],
                                          err_msg=key)
    arrays = tckpt.load_arrays(meta)
    for key in arrays:
        if key.startswith("opt_state_g::0::") and f"::{prefix}::" in key:
            assert not arrays[key].any(), key
    assert tckpt.load_arrays(ft)["params::finetune_embedding"].shape == \
        (1, 16)


@pytest.mark.parametrize("which", ["meta", "finetuned"])
def test_pretrained_pose_checkpoints_load_into_the_jax_package(
        pretrained_runs, which):
    """FAbNet+'s (its frozen encoder's statistics too); X2Face+'s state
    crosses from the JAX package in ``tests/test_torch_ablation_steps.py``."""
    _assert_jax_reads(pretrained_runs("FAbNet_pretrained_embResNeXt")[
        which == "finetuned"])


def test_fabnet_avatar_drives_as_in_jax(pretrained_runs):
    """The port's FAbNet+ avatar driven by the JAX package (FAb-Net's
    statistics read from ``batch_stats``), as the port drives it.  (A
    JAX-written avatar drives in the port in the X2Face test above.)"""
    _, ft = pretrained_runs("FAbNet_pretrained_embResNeXt")
    frames = _frames(size=64)
    _close(_port_drive(ft, frames), _jax_drive(ft, frames), "port avatar")


def test_pretrained_pose_avatar_drive_cli(pretrained_runs, workdir):
    _, ft = pretrained_runs("X2Face_pretrained_embResNeXt")
    videos = tdrive.main([str(ft), "--images_paths", "synthetic://1",
                          "--destination", str(workdir / "x2p_drive"),
                          "--drive_batch_size", "8", *CPU])
    assert len(videos) == 1 and videos[0].exists()


# --- simple_conv and no_pose_encoder ------------------------------------------

def test_simple_conv_cli_meta_fine_tune_drive(workdir):
    meta = _train([*FLAGSHIP, *SYNTHETIC, *TINY_GEN, "--embedder",
                   "simple_conv", "--simple_embedder_width", "8",
                   "--image_size", "32", "--gan_type", "ragan"], workdir,
                  "simple_meta")
    ft = _train(["--finetune", "--checkpoint_path", str(meta), "--optimizer",
                 "RAdam", "--criterions", "adversarial, featmat, dice"],
                workdir, "simple_ft")
    _assert_jax_reads(meta)
    _assert_jax_reads(ft)
    frames = _frames()
    _close(_port_drive(ft, frames), _jax_drive(ft, frames), "simple_conv")


def test_no_pose_encoder_cli_trains_with_fsth_plus(workdir):
    meta = _train(["--embedder", "no_pose_encoder", "--generator",
                   "FSTH_plus", "--discriminator", "no_landmarks",
                   "--criterions", "adversarial, featmat, l1_rgb",
                   "--optimizer", "Adam", *SYNTHETIC, "--synthetic_stickmen",
                   *TINY_GEN, "--pose_embedding_size", "136",
                   "--embed_num_blocks", "3", "--image_size", "32",
                   "--gan_type", "rgan"], workdir, "nopose_meta")
    arrays = tckpt.load_arrays(meta)
    assert arrays["params::embedder::encoder::stem_conv0::kernel"] \
        .shape[2] == 3      # RGB alone, no stickman channels
    _assert_jax_reads(meta)


def test_every_registry_name_loads_and_no_refusal_names_a19():
    for kind in ("embedders", "generators", "discriminators", "criterions",
                 "metrics", "dataloaders"):
        for name in registry.names(kind):
            registry.load_wrapper(kind, name)
    with pytest.raises(ValueError, match="Unknown embedder") as error:
        registry.load_wrapper("embedders", "nonexistent")
    assert "A.19" not in str(error.value)
    with pytest.raises(ValueError, match="gan_type"):
        tcli.resolve_args([*FLAGSHIP, *SYNTHETIC, "--embedder", "X2Face",
                           "--gan_type", "wgan", *CPU])


# --- the FFHQ crop through the CLIs -------------------------------------------

class _StubFAN:
    """FAN's interface (``eval/backends.py``): fixed face landmarks placed
    in each frame."""

    def __init__(self, weights_path, device="cuda", timer=None):
        pass

    def __call__(self, images):
        n, h, w = np.asarray(images).shape[:3]
        rng = np.random.RandomState(h + w)
        lm = rng.uniform(-0.1, 0.1, (68, 2)) * w
        lm[36:42] += [-0.15 * w, -0.1 * h]
        lm[42:48] += [0.15 * w, -0.1 * h]
        lm[48] += [-0.1 * w, 0.2 * h]
        lm[54] += [0.1 * w, 0.2 * h]
        lm += [0.45 * w, 0.5 * h]
        return np.repeat(lm[None].astype(np.float32), n, 0), np.ones((n, 68))


def test_ffhq_crop_through_both_preprocessing_clis(tmp_path, monkeypatch):
    monkeypatch.setattr(tbackends, "FANBackend", _StubFAN)
    weights = tmp_path / "weights"
    weights.mkdir()
    np.savez(weights / "fan_2d.npz")
    raw = tmp_path / "images-raw" / "id00001" / "vidA"
    raw.mkdir(parents=True)
    frames = np.random.RandomState(0).randint(0, 256, (3, 80, 72, 3),
                                              np.uint8)
    for i, frame in enumerate(frames):
        write_png(raw / f"{i:05d}.png", frame)
    tprep.main(["--data_root", str(tmp_path), "--do_crop_ffhq",
                "--weights_dir", str(weights), "--image_size", "32", *CPU])
    crops = sorted((tmp_path / "images-cropped-ffhq" / "id00001" / "vidA")
                   .iterdir())
    landmarks = sorted((tmp_path / "keypoints-cropped-ffhq" / "id00001"
                        / "vidA").iterdir())
    assert len(crops) == len(landmarks) == 3
    cropper = tcroppers.FFHQFaceCropper(
        (32, 32), None, lambda imgs: np.concatenate(
            [_StubFAN(None)(imgs)[0], np.zeros((len(imgs), 68, 1),
                                              np.float32)], -1), "cpu")
    want, want_lm = cropper.crop_images(frames)
    from latentpose_tpu_torch.data.native_loader import decode
    for i in range(3):
        np.testing.assert_array_equal(decode(crops[i]), want[i])
        np.testing.assert_array_equal(np.load(landmarks[i]), want_lm[i])
    count = tcrop_cli.main([str(raw), str(tmp_path / "single"),
                            "--crop-style", "ffhq", "--weights_dir",
                            str(weights), "--image-size", "32", *CPU])
    assert count == 3
    np.testing.assert_array_equal(
        decode(tmp_path / "single" / "00001.png"), want[1])
