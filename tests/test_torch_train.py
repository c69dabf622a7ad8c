"""PyTorch port, the fine-tune slice as a whole, held against the JAX package:
the five criteria, ê and two whole fine-tune steps from a meta-trained
checkpoint written by the JAX package, fine-tuned checkpoints crossing to
drive in both directions, and the train CLI's arguments and refusals.

Small sizes on the CPU: 32² frames, a tiny generator and discriminator, the
ResNeXt-50, MobileNetV2 and VGG towers at their fixed full widths.  Both
packages get the same numpy inputs and the same weights (the JAX VGG
towers' random arrays are handed to the port: no pretrained weights are in
the repository).  The whole-step comparison runs with
``--set_eval_mode_in_train``, since the pose encoder's dropout masks cannot
match across frameworks (its train-mode BatchNorm is held by
``tests/test_torch_models.py``), and with augmentation off (the two packages
draw it from different generators).
"""

import types
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax import serialization

from latentpose_tpu import checkpoint as jckpt
from latentpose_tpu.checkpoint import _flatten
from latentpose_tpu.data.synthetic import SyntheticDataLoader as JaxLoader
from latentpose_tpu.losses import adversarial as jadv
from latentpose_tpu.losses import dice as jdice
from latentpose_tpu.losses import featmat as jfeatmat
from latentpose_tpu.losses import idt_embed as jidt
from latentpose_tpu.losses import perceptual as jperc
from latentpose_tpu.models.discriminators import no_landmarks as jdis_mod
from latentpose_tpu.models.embedders import (
    unsupervised_pose_separate_embResNeXt_segmentation as jemb_mod)
from latentpose_tpu.models.generators import (
    vector_pose_unsupervised_segmentation_noBottleneck as jgen_mod)
from latentpose_tpu.runners import build
from latentpose_tpu.runners import drive as jdrive
from latentpose_tpu.runners import finetune as jft
from latentpose_tpu.runners import holycow as jholycow
from latentpose_tpu_torch import convert
from latentpose_tpu_torch.cli import drive as tdrive_cli
from latentpose_tpu_torch.cli import train as tcli
from latentpose_tpu_torch.losses import adversarial as tadv
from latentpose_tpu_torch.losses import dice as tdice
from latentpose_tpu_torch.losses import featmat as tfeatmat
from latentpose_tpu_torch.losses import idt_embed as tidt
from latentpose_tpu_torch.losses import perceptual as tperc
from latentpose_tpu_torch.losses.common.perceptual_loss import (
    load_tower_arrays)
from latentpose_tpu_torch.runners import drive as tdrive
from latentpose_tpu_torch.runners import holycow as tholycow

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
IMG = 32
CPU = torch.device("cpu")
JAX_CRITERIA = {"adversarial": jadv, "featmat": jfeatmat, "idt_embed": jidt,
                "perceptual": jperc, "dice": jdice}
# f32 on the CPU, sums in another order than XLA's: losses agree to 1e-4
# relative; every updated leaf to ~1e-5 absolute, since an update is lr
# (5e-4, 8e-4) times a rectified or plain Adam step whose entries are O(1)
# and a 1e-2 relative wobble of a gradient entry near 0 moves it ~5e-6
LOSS_RTOL = 1e-4
LEAF_ATOL = 1e-5


def _meta_args():
    return types.SimpleNamespace(
        generator="vector_pose_unsupervised_segmentation_noBottleneck",
        embedder="unsupervised_pose_separate_embResNeXt_segmentation",
        discriminator="no_landmarks", dataloader="synthetic",
        criterions="idt_embed, perceptual, adversarial, featmat, dis_embed, "
                   "dice",
        image_size=IMG, in_channels=3, out_channels=3, num_channels=4,
        max_num_channels=16, embed_channels=16, pose_embedding_size=8,
        gen_padding="zero", gen_constant_input_size=4,
        gen_num_residual_blocks=1, norm_layer="in", dis_padding="zero",
        dis_num_blocks=3, num_labels=4, optimizer="Adam", lr_gen=5e-5,
        lr_dis=2e-4, beta1=0.0, average_function="sum", finetune=False,
        iteration=0, set_eval_mode_in_train=False, batch_size=2,
        random_seed=0, compute_dtype="float32", num_devices=1,
        img_dir="images-cropped", data_root="", gan_type="gan",
        fm_weight=10.0, perc_weight=3e-2, idt_embed_weight=0.6e-2,
        dice_weight=1.0, synthetic_num_labels=4, num_enc_frames=8,
        synthetic_frames_per_video=32, vgg_weights_dir="/nonexistent",
        allow_random_vgg=True, weights_running_average=True)


class _JitInit:
    """A flax module whose ``init`` is jitted (eager init of the towers
    takes tens of seconds on the CPU)."""

    def __init__(self, module):
        self._module = module
        self.init = jax.jit(module.init)

    def __getattr__(self, name):
        return getattr(self._module, name)


def _jax_models(args):
    return {"embedder": jemb_mod.Wrapper.get_net(args),
            "generator": jgen_mod.Wrapper.get_net(args),
            "discriminator": jdis_mod.Wrapper.get_net(args)}


@pytest.fixture(scope="module")
def meta(tmp_path_factory):
    """A JAX meta-trained state (weights, EMA and BatchNorm statistics off
    their init) and its checkpoint."""
    args = _meta_args()
    models = _jax_models(args)
    opt_g, opt_d = build.build_optimizers(args, {"discriminators": jdis_mod})
    state = build.init_train_state(
        args, {k: _JitInit(m) for k, m in models.items()}, opt_g, opt_d,
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(7)

    def jitter(scale, low=None):
        def f(v):
            v = np.asarray(v)
            if low is not None:
                return rng.uniform(low, low + scale, v.shape).astype(v.dtype)
            return v + rng.uniform(-scale, scale, v.shape).astype(v.dtype)
        return f

    state = state.replace(
        params=jax.tree_util.tree_map(jitter(0.02), state.params),
        ema_params=jax.tree_util.tree_map(jitter(0.05), state.ema_params),
        batch_stats=jax.tree_util.tree_map(jitter(1.0, 0.5),
                                           state.batch_stats))
    path = jckpt.save_checkpoint(tmp_path_factory.mktemp("jax_meta"), state,
                                 args)
    return state, path


def _port_args(path, workdir, *flags):
    return tcli.resolve_args([
        "--finetune", "--config_name", "finetuning-base",
        "--checkpoint_path", str(path), "--dataloader",
        "synthetic", "--device", "cpu", "--set_eval_mode_in_train",
        "--allow_random_vgg", "--num_epochs", "1", "--experiments_dir",
        str(workdir), "--no-use_pixelwise_augs", "--no-use_affine_scale",
        "--no-use_affine_shift", *flags])


def _tower_arrays(jax_criterion):
    crit = getattr(jax_criterion, "perceptual_crit", None) \
        or jax_criterion.idt_embed_crit
    return {k.replace("::", "/"): v for k, v in
            _flatten(jax.device_get(crit.variables["params"])).items()}


def _port_criteria(args, jax_criteria):
    """The port's criteria with the JAX criteria's VGG tower arrays."""
    criteria = tcli.build_criteria(args, CPU)
    for crit, jcrit in zip(criteria, jax_criteria):
        tower = getattr(crit, "perceptual_crit", None) \
            or getattr(crit, "idt_embed_crit", None)
        if tower is not None:
            load_tower_arrays(tower.module, _tower_arrays(jcrit))
    return criteria


@pytest.fixture(scope="module")
def runs(meta, tmp_path_factory):
    """ê and two fine-tune steps in both packages from the same meta state;
    the port runs through its CLI's own functions."""
    jmeta, path = meta
    workdir = tmp_path_factory.mktemp("port_ft")
    targs = _port_args(path, workdir)

    # JAX, as latentpose_tpu/cli/train.py runs it
    jargs = types.SimpleNamespace(**vars(targs))
    jargs.num_labels = 4
    modules = {"embedders": jemb_mod, "generators": jgen_mod,
               "discriminators": jdis_mod}
    jmodels = _jax_models(jargs)
    opt_g, opt_d = build.build_optimizers(jargs, modules)
    rng = jax.random.PRNGKey(jargs.random_seed)
    loader = JaxLoader(image_size=IMG, batch_size=2, num_labels=4,
                       finetune=True, seed=jargs.random_seed)
    j_ehat = jft.compute_averaged_identity_embedding(jmodels, jmeta, loader,
                                                     jargs)
    jmodels, jstate = jft.enable_finetuning(
        jmeta, jmodels, jdis_mod.Wrapper, jargs, j_ehat, opt_g, opt_d, rng,
        gen_wrapper=jgen_mod.Wrapper)
    jargs.num_labels = 1
    jcriteria = build.build_criteria(jargs, {"criterions": [
        JAX_CRITERIA[n.strip()] for n in jargs.criterions.split(",")]})
    jstep = jholycow.make_train_step(jmodels, jcriteria, jargs, opt_g, opt_d)
    jscalars = []
    for it, (data, target) in enumerate(loader):
        jstate, scalars = jstep(jstate, {**data, **target},
                                jax.random.fold_in(rng, it))
        jscalars.append({k: float(v) for k, v in scalars.items()})

    # the port
    tloader = tcli.build_dataloader(targs)
    tstate = tcli.load_checkpoint(targs, CPU)
    criteria = _port_criteria(targs, jcriteria)
    tstate = tcli.start_finetuning(targs, tstate, tloader, CPU)
    t_ehat = tstate.finetune_embedding.detach().clone()
    # the fresh one-row embedding's (u, v) init comes from each framework's
    # own RNG; start the port from the JAX draw
    jembed = jax.device_get(jstate.spectral["discriminator"]["embed"])
    dis = tstate.models["discriminator"]
    dis.embed.u.copy_(torch.from_numpy(np.array(jembed["u"])))
    dis.embed.v.copy_(torch.from_numpy(np.array(jembed["v"])))
    step = tholycow.make_train_step(criteria, targs)
    tscalars = []
    for batch in tloader:
        scalars = step(tstate, tholycow.to_device(batch, CPU))
        tscalars.append({k: float(v) for k, v in scalars.items()})
    return dict(jargs=jargs, jmodels=jmodels, jstate=jstate, j_ehat=j_ehat,
                jscalars=jscalars, targs=targs, tstate=tstate, t_ehat=t_ehat,
                tscalars=tscalars, workdir=workdir)


def test_identity_embedding_average_matches_jax(runs):
    """ê over the avatar's 32 frames (2 batches x 2 samples x K=8)."""
    np.testing.assert_allclose(runs["t_ehat"].numpy(),
                               np.asarray(runs["j_ehat"]), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("step", [0, 1])
def test_finetune_step_losses_match_jax(runs, step):
    want, got = runs["jscalars"][step], runs["tscalars"][step]
    assert set(got) == set(want)
    assert len(want) == 8     # 5 criteria (adversarial G and D) + the sums
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=key)


@pytest.mark.parametrize("collection", ["params", "ema_params", "batch_stats",
                                        "spectral"])
def test_two_finetune_steps_leave_the_jax_state(runs, collection):
    """Every updated parameter, EMA leaf, BatchNorm statistic and
    spectral-norm (u, v) after two steps, and the step counter."""
    want = _flatten(serialization.to_state_dict(
        jax.device_get(runs["jstate"])))
    got = convert.export_train_state(runs["tstate"])
    assert int(got["step"]) == int(want["step"]) == 2
    keys = [k for k in got if k.startswith(collection + "::")]
    assert keys and set(keys) == {k for k in want
                                  if k.startswith(collection + "::")}
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=LEAF_ATOL, err_msg=key)


def test_finetune_moved_what_it_trains(runs, meta):
    """The generator, the identity embedding and the discriminator moved
    off the meta state; the frozen pose encoder's weights did not."""
    got = convert.export_train_state(runs["tstate"])
    start = _flatten(serialization.to_state_dict(jax.device_get(meta[0])))
    assert not np.allclose(got["params::finetune_embedding"],
                           runs["t_ehat"].numpy())
    for key in ("params::generator::head_conv::kernel",
                "params::discriminator::linear::kernel"):
        assert not np.allclose(got[key], start[key]), key
    key = "params::embedder::pose_encoder::classifier::kernel"
    np.testing.assert_array_equal(got[key], start[key])


def _drive_frames():
    return np.random.RandomState(20).rand(3, IMG, IMG, 3).astype(np.float32)


def _jax_drive(path, monkeypatch):
    args = types.SimpleNamespace(**tdrive_cli.ckpt_lib.peek_args(path))
    args.checkpoint_path = str(path)
    args.compute_dtype = "float32"
    modules = {"embedders": jemb_mod, "generators": jgen_mod,
               "discriminators": jdis_mod}
    from latentpose_tpu.cli.drive import load_finetuned
    build_models = build.build_models
    monkeypatch.setattr(build, "build_models", lambda *a: {
        k: _JitInit(m) for k, m in build_models(*a).items()})
    models, state = load_finetuned(args, modules)
    rgbs, _ = jdrive.make_drive_fn(models, args)(state, _drive_frames())
    return np.asarray(rgbs)


def _port_drive(path):
    args = tdrive_cli.resolve_args([str(path), "--device", "cpu",
                                    "--compute_dtype", "float32"])
    models, state = tdrive_cli.load_finetuned(args, CPU)
    rgbs, _ = tdrive.make_drive_fn(models, args)(
        state, torch.from_numpy(_drive_frames()))
    return rgbs.numpy()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_finetuned_checkpoint_drives_the_same_in_both_packages(
        runs, writer, tmp_path, monkeypatch):
    """The port's fine-tuned checkpoint (its CLI's writer) read by the JAX
    package's drive, and the JAX one read by the port's drive, give the
    frames the other package gives; f32, 1e-4."""
    if writer == "port":
        args = runs["targs"]
        args.experiment_dir = str(tmp_path)
        path = tcli.save(args, runs["tstate"])
    else:
        path = jckpt.save_checkpoint(tmp_path, runs["jstate"], runs["jargs"])
    assert path.name == "model_00000002.ckpt"
    want, got = _jax_drive(path, monkeypatch), _port_drive(path)
    assert got.shape == (3, IMG, IMG, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


# --- the five criteria ------------------------------------------------------

def _loss_inputs(seed=21):
    rng = np.random.RandomState(seed)
    fake = rng.uniform(-0.2, 1.2, (2, IMG, IMG, 3)).astype(np.float32)
    real = rng.rand(2, 1, IMG, IMG, 3).astype(np.float32)
    return fake, real


def test_adversarial_matches_jax():
    rng = np.random.RandomState(22)
    scores = {k: rng.standard_normal(4).astype(np.float32)
              for k in ("fake_score_G", "fake_score_D", "real_score")}
    jg, jd = jadv.Criterion("gan")({k: jnp.asarray(v)
                                    for k, v in scores.items()})
    tg, td = tadv.Criterion("gan")({k: torch.from_numpy(v)
                                    for k, v in scores.items()})
    np.testing.assert_allclose(float(tg["adversarial_G"]),
                               float(jg["adversarial_G"]), rtol=1e-6)
    np.testing.assert_allclose(float(td["adversarial_D"]),
                               float(jd["adversarial_D"]), rtol=1e-6)
    # the relativistic forms (ported with A.19's second slice; their
    # gradients are held in tests/test_torch_ablation_models.py)
    for other in ("rgan", "ragan"):
        jg, jd = jadv.Criterion(other)({k: jnp.asarray(v)
                                        for k, v in scores.items()})
        tg, td = tadv.Criterion(other)({k: torch.from_numpy(v)
                                        for k, v in scores.items()})
        np.testing.assert_allclose(float(tg["adversarial_G"]),
                                   float(jg["adversarial_G"]), rtol=1e-6)
        np.testing.assert_allclose(float(td["adversarial_D"]),
                                   float(jd["adversarial_D"]), rtol=1e-6)


def test_featmat_matches_jax():
    rng = np.random.RandomState(23)
    shapes = [(2, 8, 8, 4), (2, 4, 4, 8), (2, 2, 2, 16)]
    fake = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    real = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = jfeatmat.Criterion(10.0)({"fake_features": fake,
                                     "real_features": real})
    got = tfeatmat.Criterion(10.0)({
        "fake_features": [torch.from_numpy(f).permute(0, 3, 1, 2)
                          for f in fake],
        "real_features": [torch.from_numpy(r).permute(0, 3, 1, 2)
                          for r in real]})
    np.testing.assert_allclose(float(got["feature_matching"]),
                               float(want["feature_matching"]), rtol=1e-6)


def test_dice_matches_jax():
    rng = np.random.RandomState(24)
    fake = rng.rand(2, IMG, IMG, 1).astype(np.float32)
    real = (rng.rand(2, 1, IMG, IMG, 1) > 0.5).astype(np.float32)
    want = jdice.Criterion(1.0)({"fake_segm": fake, "real_segm": real})
    got = tdice.Criterion(1.0)({"fake_segm": torch.from_numpy(fake),
                                "real_segm": torch.from_numpy(real)})
    np.testing.assert_allclose(float(got["segmentation_dice"]),
                               float(want["segmentation_dice"]), rtol=1e-6)


@pytest.mark.parametrize("name", ["perceptual", "idt_embed"])
def test_vgg_criteria_match_jax_with_gradient(name):
    """VGG19 caffe (perceptual) and VGGFace-16 on the 1/1.8 centre crop
    (idt_embed, through crop_and_resize): the value and its gradient in
    the fake image, with the JAX towers' random arrays in both."""
    fake, real = _loss_inputs()
    if name == "perceptual":
        jcrit = jperc.Criterion(3e-2, None, allow_random=True)
    else:
        jcrit = jidt.Criterion(0.6e-2, None, allow_random=True)
    key = {"perceptual": "VGG", "idt_embed": "VGGFace"}[name]

    def jloss(f):
        return jcrit({"fake_rgbs": f, "target_rgbs": jnp.asarray(real)})[key]

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(fake))
    tcrit = (tperc.Criterion(3e-2, None, allow_random=True)
             if name == "perceptual"
             else tidt.Criterion(0.6e-2, None, allow_random=True))
    tower = getattr(tcrit, "perceptual_crit", None) or tcrit.idt_embed_crit
    load_tower_arrays(tower.module, _tower_arrays(jcrit))
    tfake = torch.from_numpy(fake).requires_grad_()
    got = tcrit({"fake_rgbs": tfake,
                 "target_rgbs": torch.from_numpy(real)})[key]
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    np.testing.assert_allclose(tfake.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-3, atol=1e-6)


def test_vgg_criteria_need_weights_or_the_opt_in():
    with pytest.raises(FileNotFoundError, match="allow_random_vgg"):
        tperc.Criterion(1e-2, "/nonexistent", allow_random=False)


@pytest.mark.parametrize("where", ["explicit", "env", "none"])
def test_weights_search_order_matches_jax(where, tmp_path, monkeypatch):
    """The port's weight discovery finds the file the JAX package's finds
    (explicit dir before $LATENTPOSE_WEIGHTS_DIR) and words a miss alike."""
    from latentpose_tpu.utils import weights as jweights
    from latentpose_tpu_torch.utils import weights as tweights
    name = "vgg_face.npz"
    explicit, env = tmp_path / "explicit", tmp_path / "env"
    explicit.mkdir()
    env.mkdir()
    (env / name).touch()
    if where == "explicit":
        (explicit / name).touch()
    if where != "none":
        monkeypatch.setenv("LATENTPOSE_WEIGHTS_DIR", str(env))
    else:
        monkeypatch.delenv("LATENTPOSE_WEIGHTS_DIR", raising=False)
    want = {"explicit": str(explicit / name), "env": str(env / name),
            "none": None}[where]
    assert jweights.find_weights_file(name, explicit) == want
    assert tweights.find_weights_file(name, explicit) == want
    args = (name, "PerceptualLoss(face)", "--allow_random_vgg", explicit)
    assert str(tweights.missing_weights_error(*args)) == \
        str(jweights.missing_weights_error(*args))


# --- the CLI -----------------------------------------------------------------

def test_finetune_defaults_equal_the_config_file():
    """The port reads configs/finetuning-base.yaml (without yaml, which is
    absent where the card is) as yaml reads it, and the resolved args take
    its numbers through the options' types, as the JAX CLI does."""
    import yaml
    from latentpose_tpu_torch import config as tconfig
    cfg = yaml.safe_load((REPO / "configs" / "finetuning-base.yaml")
                         .read_text())
    got = tconfig.load_yaml_config("finetuning-base", REPO / "configs")
    assert got == cfg and all(type(got[k]) is type(v) for k, v in cfg.items())
    assert cfg["lr_gen"] == "5e-4"      # YAML 1.1: no dot, no float
    args, _, _, _ = tconfig.get_args_and_modules(
        tcli.build_parser(), argv=["--config_name", "finetuning-base",
                                   *NAMES_FOR_CONFIG])
    assert (args.lr_gen, args.lr_dis, args.fixed_val_ids) == \
        (5e-4, 8e-4, [0])


NAMES_FOR_CONFIG = ["--generator",
                    "vector_pose_unsupervised_segmentation_noBottleneck",
                    "--embedder",
                    "unsupervised_pose_separate_embResNeXt_segmentation",
                    "--discriminator", "no_landmarks", "--dataloader",
                    "synthetic"]


@pytest.mark.parametrize("flags,item,error", [
    # multi-device training and FSDP are ported (tests/test_torch_parallel.py,
    # tests/test_torch_fsdp.py): what stays refused is the explicit regimes
    # without a group or with fewer cards than ranks, as the JAX CLI
    # refuses them
    pytest.param(["--finetune", "--grad_dtype", "bfloat16"],
                 "need a device mesh", ValueError, id="flags1-A.17"),
    pytest.param(["--finetune", "--num_devices", "2"],
                 "Requested 2 devices, only", ValueError, id="flags2-A.17"),
    # the second A.19 slice's dataloaders and the none discriminator were
    # refused until it was ported: now they resolve (error None)
    pytest.param(["--finetune", "--dataloader",
                  "voxceleb2_segmentation_nolandmarks_X2Face_FAbNet_crops"],
                 "A.19", None, id="flags3-A.19"),
    pytest.param(["--finetune", "--dataloader", "voxceleb2_X2Face"], "A.19",
                 None, id="flags4-A.19"),
    pytest.param(["--finetune", "--discriminator", "none"],
                 "A.19", None, id="flags5-A.19"),
])
def test_cli_refuses_what_is_not_ported(meta, flags, item, error):
    argv = ["--checkpoint_path", str(meta[1]), "--dataloader", "synthetic"]
    if error is None:
        args = tcli.resolve_args(argv + flags)
        assert getattr(args, flags[1][2:]) == flags[2]
        return
    with pytest.raises(error, match=item):
        tcli.resolve_args(argv + flags)


@pytest.mark.parametrize("flags", [
    [],                                                 # meta-train
    ["--finetune", "--use_pixelwise_augs", "--no-use_affine_scale",
     "--no-use_affine_shift"],
    ["--finetune", "--use_affine_scale", "--no-use_pixelwise_augs",
     "--no-use_affine_shift"],
    ["--finetune", "--use_affine_shift", "--no-use_pixelwise_augs",
     "--no-use_affine_scale"],
    ["--finetune", "--grad_accum_steps", "2"],
])
def test_cli_runs_meta_train_augmentation_and_accumulation(
        meta, flags, tmp_path, monkeypatch):
    """What the CLI refused before the meta-train slice now runs:
    meta-training, each augmentation alone, and gradient accumulation; one
    step each, from the JAX-written meta checkpoint, with the switches each
    run's config and flags give: meta-training resumes the checkpoint's
    args (augmentation off there) with the three switched on by flags;
    fine-tuning takes the fine-tune config."""
    from latentpose_tpu_torch.data import augmentation
    seen = []
    augment = augmentation.augment_data_dict
    monkeypatch.setattr(augmentation, "augment_data_dict", lambda b, d, **k:
                        seen.append(k) or augment(b, d, **k))
    config = ["--config_name", "finetuning-base"] if "--finetune" in flags \
        else ["--use_pixelwise_augs", "--use_affine_scale",
              "--use_affine_shift"]
    state, path = tcli.main([
        "--checkpoint_path", str(meta[1]), "--dataloader", "synthetic",
        "--device", "cpu", "--allow_random_vgg", "--num_epochs", "1",
        "--batch_size", "2", "--synthetic_num_labels", "2",
        "--experiments_dir", str(tmp_path), *config, *flags])
    assert state.step == 1 and path.name == "model_00000001.ckpt"
    assert state.finetune == ("--finetune" in flags)
    assert seen == [{"use_pixelwise": "--no-use_pixelwise_augs" not in flags,
                     "use_scale": "--no-use_affine_scale" not in flags,
                     "use_shift": "--no-use_affine_shift" not in flags}]


def test_cli_refuses_other_families_and_fine_tuned_checkpoints(runs, meta,
                                                               tmp_path):
    """Other model families, and meta-training from a fine-tuned checkpoint
    (it resumes fine-tuning: its saved args carry ``finetune``, as the JAX
    CLI reads them; ``--no-finetune`` is refused)."""
    argv = ["--finetune", "--checkpoint_path", str(meta[1]), "--dataloader",
            "synthetic"]
    with pytest.raises(ValueError, match="Unknown generator"):
        tcli.resolve_args(argv + ["--generator", "nonexistent"])
    path = jckpt.save_checkpoint(tmp_path, runs["jstate"], runs["jargs"])
    assert tcli.resolve_args(["--checkpoint_path", str(path),
                              "--dataloader", "synthetic"]).finetune
    with pytest.raises(ValueError, match="resumes with --finetune"):
        tcli.resolve_args(["--checkpoint_path", str(path), "--dataloader",
                           "synthetic", "--no-finetune"])


def test_cli_resumes_a_fine_tuned_checkpoint(runs, tmp_path):
    """A JAX-written fine-tuned checkpoint resumes in the port's CLI: the
    step and the RAdam count continue from the checkpoint's."""
    path = jckpt.save_checkpoint(tmp_path / "jax", runs["jstate"],
                                 runs["jargs"])
    state, out = tcli.main([
        "--finetune", "--checkpoint_path", str(path), "--dataloader",
        "synthetic", "--device", "cpu", "--allow_random_vgg", "--num_epochs",
        "1", "--experiments_dir", str(tmp_path / "port")])
    assert state.finetune and state.step == 4 and state.opt_g.count == 4
    assert out.name == "model_00000004.ckpt"


def test_meta_checkpoint_keys_neither_read_nor_skipped_are_an_error(meta):
    args = _port_args(meta[1], "/nonexistent")
    flat = tdrive_cli.ckpt_lib.load_arrays(meta[1])
    state = tcli.load_checkpoint(args, CPU)        # the real key set loads
    with pytest.raises(ValueError, match="neither reads nor skips"):
        convert.load_train_state(
            dict(flat, **{"params::generator::extra": np.zeros(1)}), state)


def test_cli_main_finetunes_and_the_result_drives(meta, tmp_path):
    """``main`` end to end on the CPU: one epoch, the checkpoint written at
    the end carries the fine-tune flag and drives through the port."""
    state, path = tcli.main([
        "--finetune", "--config_name", "finetuning-base", "--checkpoint_path",
        str(meta[1]), "--dataloader", "synthetic", "--device", "cpu",
        "--allow_random_vgg", "--num_epochs", "1", "--experiments_dir",
        str(tmp_path)])
    assert state.step == 2 and path.name == "model_00000002.ckpt"
    meta_json = tdrive_cli.ckpt_lib.peek_args(path)
    assert meta_json["finetune"] and meta_json["num_labels"] == 1
    rgbs = _port_drive(path)
    assert rgbs.shape == (3, IMG, IMG, 3) and np.isfinite(rgbs).all()


def test_synthetic_finetune_loader_is_bit_identical():
    """The port's fine-tune loader draws the JAX loader's batches: same
    RandomState sequence, keys, shapes, dtypes and values, over two epochs."""
    from latentpose_tpu_torch.data.synthetic import SyntheticDataLoader
    want = JaxLoader(image_size=IMG, batch_size=3, num_labels=7,
                     finetune=True, seed=5)
    got = SyntheticDataLoader(IMG, 3, num_labels=7, seed=5)
    assert len(got) == len(want) == 2 and got.num_labels == want.num_labels
    for _ in range(2):
        for (wd, wt), (gd, gt) in zip(list(want), list(got)):
            for w, g in ((wd, gd), (wt, gt)):
                assert set(g) == set(w)
                for key in w:
                    assert g[key].dtype == w[key].dtype, key
                    np.testing.assert_array_equal(g[key], w[key], err_msg=key)
