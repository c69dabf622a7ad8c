"""PyTorch port, the FSTH family through ``cli.train``: meta-training on
``synthetic --synthetic_stickmen``, a save, a fine-tune from that
checkpoint (FSTH trains ``finetune_affine``, FSTH_plus ê), bf16 on the
uint8 wire, the landmark datasets on a tree on disk, and the checkpoints
it writes read back by the JAX package array for array.  Tiny widths on
the CPU (seconds a step)."""

import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from latentpose_tpu import checkpoint as jckpt
from latentpose_tpu.checkpoint import _flatten
from latentpose_tpu.models.discriminators import FSTH as jdis_mod
from latentpose_tpu.models.embedders import FSTH as jemb_mod
from latentpose_tpu.models.generators import FSTH as jgen_mod
from latentpose_tpu.models.generators import FSTH_plus as jgen_plus_mod
from latentpose_tpu.runners import build
from latentpose_tpu.runners import finetune as jft
from latentpose_tpu_torch import checkpoint as tckpt
from latentpose_tpu_torch.cli import train as tcli

TINY = ["--embedder", "FSTH", "--discriminator", "FSTH",
        "--criterions", "adversarial, featmat, l1_rgb, idt_embed",
        "--allow_random_vgg", "--device", "cpu", "--image_size", "32",
        "--num_channels", "4", "--max_num_channels", "16",
        "--embed_channels", "16", "--embed_num_blocks", "3",
        "--gen_num_downsample_blocks", "2", "--gen_num_residual_blocks", "1",
        "--dis_num_blocks", "3", "--batch_size", "2", "--num_epochs", "1"]
SYNTHETIC = ["--dataloader", "synthetic", "--synthetic_stickmen",
             "--synthetic_num_labels", "4", "--num_enc_frames", "2"]
GENERATORS = {"FSTH": jgen_mod, "FSTH_plus": jgen_plus_mod}


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


def _without(argv, *flags):
    """``argv`` without ``flags`` and their values: a flag that the run's
    selection does not register is refused, as by the JAX CLI."""
    out, skip = [], False
    for a in argv:
        if skip and not a.startswith("--"):
            skip = False
            continue
        skip = a in flags
        if not skip:
            out.append(a)
    return out


def _train(argv, tmp_path, name):
    _, path = tcli.main([*argv, "--experiments_dir", str(tmp_path),
                         "--experiment_name", name])
    return path


def _jax_skeleton(path):
    """The JAX CLI's skeleton of checkpoint ``path`` (its saved args): the
    models, a fine-tuned state's one-row discriminator and per-avatar
    leaves, both optimizers."""
    args = types.SimpleNamespace(**tckpt.peek_args(path))
    finetuned = tcli.checkpoint_is_finetuned(path)
    modules = {"embedders": jemb_mod,
               "generators": GENERATORS[args.generator],
               "discriminators": jdis_mod}
    args.num_labels = int(tckpt.load_arrays(path)[
        "params::discriminator::embed::embedding"].shape[0])
    models = {"embedder": jemb_mod.Wrapper.get_net(args),
              "generator": modules["generators"].Wrapper.get_net(args),
              "discriminator": jdis_mod.Wrapper.get_net(args)}
    leaves = None
    if finetuned:
        models["discriminator"] = jft.make_finetune_discriminator(
            jdis_mod.Wrapper, args)
        leaves = {k: v for k, v in tckpt.load_arrays(path).items()
                  if k.startswith("params::finetune_")}
        leaves = {k.split("::")[1]: np.zeros_like(v)
                  for k, v in leaves.items()}
    opt_g, opt_d = build.build_optimizers(args, modules)
    models = {k: _ShapeInit(m) for k, m in models.items()}
    return build.init_train_state(args, models, opt_g, opt_d,
                                  jax.random.PRNGKey(0), finetune=finetuned,
                                  finetune_leaves=leaves)


def _assert_jax_reads(path):
    """The JAX package restores the port's checkpoint into its own skeleton
    with every array of the file, and nothing else."""
    skeleton = _jax_skeleton(path)
    restored = _flatten(serialization.to_state_dict(jax.device_get(
        jckpt.restore_state(path, skeleton))))
    skeleton = _flatten(serialization.to_state_dict(skeleton))
    saved = tckpt.load_arrays(path)
    assert set(skeleton) == set(saved) == set(restored)
    for key, value in saved.items():
        np.testing.assert_array_equal(np.asarray(restored[key]), value,
                                      err_msg=key)


@pytest.fixture(scope="module")
def fsth_run(tmp_path_factory):
    """FSTH: 2 meta steps, the save, 2 fine-tune steps from it."""
    tmp = tmp_path_factory.mktemp("fsth_cli")
    meta = _train([*TINY, *SYNTHETIC, "--generator", "FSTH", "--num_epochs",
                   "2"], tmp, "meta")
    ft = _train(["--finetune", "--checkpoint_path", str(meta),
                 "--optimizer", "RAdam", "--device", "cpu", "--num_epochs",
                 "2", "--batch_size", "2"], tmp, "ft")
    return meta, ft


def test_cli_trains_and_fine_tunes_fsth(fsth_run):
    meta, ft = fsth_run
    assert tckpt.peek_args(meta)["iteration"] == 4
    before, after = tckpt.load_arrays(meta), tckpt.load_arrays(ft)
    assert "params::finetune_embedding" not in after
    affine = after["params::finetune_affine"]
    assert affine.shape[0] == 1 and np.isfinite(affine).all()
    assert after["params::discriminator::embed::embedding"].shape[0] == 1
    # the projector is not read while finetune_affine is trained
    for key in ("params::generator::project::kernel",
                "spectral::generator::project::u"):
        np.testing.assert_array_equal(after[key], before[key], err_msg=key)
    assert not np.array_equal(after["params::generator::head_conv::kernel"],
                              before["params::generator::head_conv::kernel"])


def test_cli_fine_tunes_fsth_sharded_over_two_ranks(fsth_run, tmp_path):
    """``--num_devices 2 --param_sharding fsdp`` (two gloo ranks):
    ``finetune_affine`` is one of the sharded group's tensors, and the
    checkpoint rank 0 writes is the replicated run's, read back by the JAX
    package."""
    meta = fsth_run[0]
    sharded = _train(["--finetune", "--checkpoint_path", str(meta),
                      "--optimizer", "RAdam", "--device", "cpu",
                      "--num_devices", "2", "--param_sharding", "fsdp",
                      "--batch_size", "2"], tmp_path, "fsdp")
    arrays = tckpt.load_arrays(sharded)
    assert np.isfinite(arrays["params::finetune_affine"]).all()
    assert not np.array_equal(arrays["params::finetune_affine"],
                              arrays["ema_params::finetune_affine"])
    _assert_jax_reads(sharded)


def test_drive_refuses_an_fsth_avatar(fsth_run, tmp_path):
    """Drive takes the flagship's latent pose; an FSTH avatar is refused
    by name (neither package's drive computes the driver's stickman)."""
    from latentpose_tpu_torch.cli import drive as tdrive
    with pytest.raises(NotImplementedError, match="FSTH"):
        tdrive.main([str(fsth_run[1]), "--images_paths", "synthetic://3",
                     "--destination", str(tmp_path), "--device", "cpu"])


@pytest.mark.parametrize("which", ["meta", "finetuned"])
def test_port_checkpoints_load_into_the_jax_package(fsth_run, which):
    _assert_jax_reads(fsth_run[which == "finetuned"])


def test_cli_fsth_plus_fine_tunes_the_identity(tmp_path):
    meta = _train([*_without(TINY, "--gen_num_downsample_blocks"),
                   *SYNTHETIC, "--generator", "FSTH_plus"], tmp_path, "meta")
    ft = _train(["--finetune", "--checkpoint_path", str(meta), "--device",
                 "cpu"], tmp_path, "ft")
    arrays = tckpt.load_arrays(ft)
    assert arrays["params::finetune_embedding"].shape == (1, 16)
    assert "params::finetune_affine" not in arrays
    _assert_jax_reads(ft)


def test_cli_fsth_in_bf16_on_the_uint8_wire(tmp_path):
    meta = _train([*TINY, *SYNTHETIC, "--generator", "FSTH",
                   "--compute_dtype", "bfloat16", "--transfer_dtype",
                   "uint8"], tmp_path, "meta")
    ft = _train(["--finetune", "--checkpoint_path", str(meta), "--device",
                 "cpu"], tmp_path, "ft")
    args = tckpt.peek_args(ft)
    assert (args["compute_dtype"], args["transfer_dtype"]) == (
        "bfloat16", "uint8")
    for path in (meta, ft):
        arrays = tckpt.load_arrays(path)
        assert all(np.isfinite(v).all() for v in arrays.values()
                   if v.dtype.kind == "f")


@pytest.mark.parametrize("dataloader", ["voxceleb2", "voxceleb2_segm",
                                        "voxceleb2_FSTH_crop"])
def test_cli_trains_fsth_on_a_landmark_tree(tmp_path, dataloader):
    """One meta epoch on a tree of PNG frames, keypoints and masks, then a
    fine-tune step on one video's frames."""
    rng = np.random.RandomState(0)
    for path in ("id00001/vid0", "id00002/vid0"):
        for f in range(3):
            for sub in ("images-cropped", "keypoints-cropped",
                        "segmentation-cropped"):
                (tmp_path / "data" / sub / path).mkdir(parents=True,
                                                       exist_ok=True)
            base = tmp_path / "data"
            cv2.imwrite(str(base / "images-cropped" / path / f"{f}.png"),
                        rng.randint(0, 256, (40, 40, 3), np.uint8))
            cv2.imwrite(str(base / "segmentation-cropped" / path
                            / f"{f}.png"),
                        rng.randint(0, 256, (40, 40, 3), np.uint8))
            np.save(base / "keypoints-cropped" / path / f"{f}.npy",
                    rng.uniform(0, 40, (68, 3)).astype(np.float32))
    data = ["--dataloader", dataloader, "--data_root",
            str(tmp_path / "data"), "--train_split_path", "none.csv",
            "--n_frames_for_encoder", "2", "--num_workers", "1"]
    meta = _train([*TINY, *data, "--generator", "FSTH"], tmp_path, "meta")
    ft = _train(["--finetune", "--checkpoint_path", str(meta), *data,
                 "--train_split_path", "id00001/vid0", "--device", "cpu"],
                tmp_path, "ft")
    assert "params::finetune_affine" in tckpt.load_arrays(ft)


@pytest.mark.parametrize("flags, item", [
    (["--discriminator", "none"], "A.19"),
    (["--embedder", "no_pose_encoder"], "A.19"),
    (["--generator", "X2Face"], "A.19"),
    (["--dataloader", "voxceleb2_X2Face"], "A.19"),
])
def test_cli_refuses_the_second_slice(flags, item):
    """The second A.19 slice (``none``, ``no_pose_encoder``, X2Face, its
    dataset) was refused here until it was ported; now its names
    resolve (``tests/test_torch_ablation_cli.py`` trains them), each
    without the flags of the plugin it replaces."""
    unregistered = {
        "--discriminator": ["--dis_num_blocks"],
        "--generator": ["--gen_num_downsample_blocks",
                        "--gen_num_residual_blocks"],
        "--dataloader": ["--synthetic_stickmen", "--synthetic_num_labels",
                         "--num_enc_frames"]}.get(flags[0], [])
    argv = _without([*TINY, *SYNTHETIC, "--generator", "FSTH", *flags],
                    *unregistered)
    args = tcli.resolve_args(argv)
    assert getattr(args, flags[0][2:]) == flags[1]


def test_fsth_generator_takes_its_own_default_depth():
    """As the JAX plugin's get_args: 4 residual blocks for FSTH, 2 for the
    flagship and FSTH_plus, unless a flag or a checkpoint says otherwise."""
    base = ["--embedder", "FSTH", "--discriminator", "FSTH", *SYNTHETIC]
    assert tcli.resolve_args([*base, "--generator", "FSTH"]) \
        .gen_num_residual_blocks == 4
    assert tcli.resolve_args([*base, "--generator", "FSTH_plus"]) \
        .gen_num_residual_blocks == 2
    assert tcli.resolve_args([*base, "--generator", "FSTH",
                              "--gen_num_residual_blocks", "1"]) \
        .gen_num_residual_blocks == 1
