"""PyTorch port, the second half of the ablation families' meta steps held
against the JAX package: one X2Face meta step (the two UNets, the warp,
``l1_rgb``, the ``none`` discriminator) and one meta step each of the
pretrained-pose families, FAbNet+ (``--gan_type ragan``) and X2Face+
(``rgan``), with the flagship generator and discriminator, each from a
JAX-written checkpoint that the port loads through ``cli.train``'s
functions.

Small sizes on the CPU: synthetic faces with seeded noise on the frames,
K=2, B=2; X2Face at 32², the pretrained-pose families at 64² (FAb-Net's six
stride-2 convolutions need it) with the ResNeXt-50 identity tower cut to
one bottleneck a stage in both packages and the criteria adversarial,
featmat, dis_embed and dice (the VGG criteria are held in
``tests/test_torch_metatrain.py``).  For X2Face and FAbNet+ the reference
is the JAX step in f64 and the port's f32 step meets it leaf by leaf
within the first-step bounds of ``tests/test_torch_fsth_steps.py``
(``_ratios``): every gradient and second moment, update, BatchNorm
statistic, (u, v) and EMA leaf.  X2Face+ is held to the JAX step in f32.

The frozen pose encoders (FAb-Net's, X2Face's driving UNet and
``pose_proj``) come out of both steps bit-unchanged, with zero moments,
and FAb-Net's BatchNorm statistics do not move.  The ``none``
discriminator leaves no optimizer state in either checkpoint."""

import functools
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_fsth_steps as fs
from latentpose_tpu import checkpoint as jckpt
from latentpose_tpu.checkpoint import _flatten
from latentpose_tpu.data.synthetic import SyntheticDataLoader as JaxLoader
from latentpose_tpu.losses import adversarial as jadv
from latentpose_tpu.losses import dice as jdice
from latentpose_tpu.losses import dis_embed as jdis_embed
from latentpose_tpu.losses import featmat as jfeatmat
from latentpose_tpu.losses import l1_rgb as jl1
from latentpose_tpu.models.discriminators import no_landmarks as jdis_mod
from latentpose_tpu.models.discriminators import none as jnone
from latentpose_tpu.models.embedders import FAbNet_pretrained_embResNeXt \
    as jfab
from latentpose_tpu.models.embedders import X2Face as jx2e
from latentpose_tpu.models.embedders import X2Face_pretrained_embResNeXt \
    as jx2p
from latentpose_tpu.models.generators import X2Face as jx2g
from latentpose_tpu.models.generators import \
    vector_pose_unsupervised_segmentation_noBottleneck as jgen_mod
from latentpose_tpu.nn import backbones as jbackbones
from latentpose_tpu.runners import build
from latentpose_tpu.runners import holycow as jholycow
from latentpose_tpu_torch import convert
from latentpose_tpu_torch.cli import train as tcli
from latentpose_tpu_torch.models.embedders import \
    unsupervised_pose_separate_embResNeXt_segmentation as tflagship
from latentpose_tpu_torch.nn import backbones as tbackbones
from latentpose_tpu_torch.runners import holycow as tholycow

torch.set_num_threads(1)

K = 2
LAYERS = (1, 1, 1, 1)
# name: (image size, embedder, generator, discriminator, criteria, gan_type)
FAMILIES = {
    "X2Face": (32, jx2e, jx2g, jnone, {"l1_rgb": jl1}, "gan"),
    "FAbNet+": (64, jfab, jgen_mod, jdis_mod,
                {"adversarial": jadv, "featmat": jfeatmat,
                 "dis_embed": jdis_embed, "dice": jdice}, "ragan"),
    "X2Face+": (64, jx2p, jgen_mod, jdis_mod,
                {"adversarial": jadv, "featmat": jfeatmat,
                 "dis_embed": jdis_embed, "dice": jdice}, "rgan"),
}
# the families held leaf by leaf against the JAX step in f64; X2Face+
# (FAbNet+'s tower, generator and discriminator beside another frozen
# encoder) against the JAX step in f32: its losses and frozen leaves
FLOAT64 = ("FAbNet+", "X2Face")
# the frozen sub-networks' parameter prefixes in the JAX tree
FROZEN = {"FAbNet+": ("embedder::pose_encoder::",),
          "X2Face+": ("embedder::pose_unet::", "embedder::pose_proj::")}


@pytest.fixture(scope="module", autouse=True)
def _shallow_resnext():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jfab, jx2p):
            mp.setattr(mod, "ResNeXt50", functools.partial(
                jbackbones.ResNeXt50, layers=LAYERS))
        mp.setattr(tflagship, "ResNeXt50", functools.partial(
            tbackbones.ResNeXt50, layers=LAYERS))
        yield


def _args(name):
    img, emb, gen, dis, criteria, gan_type = FAMILIES[name]
    return types.SimpleNamespace(
        generator=gen.__name__.rsplit(".", 1)[1],
        embedder=emb.__name__.rsplit(".", 1)[1],
        discriminator=dis.__name__.rsplit(".", 1)[1], dataloader="synthetic",
        criterions=", ".join(criteria), image_size=img, in_channels=3,
        out_channels=3, num_channels=4, max_num_channels=16,
        embed_channels=16, pose_embedding_size=8, gen_padding="zero",
        gen_constant_input_size=4, gen_num_residual_blocks=1,
        norm_layer="in", dis_padding="zero", dis_num_blocks=3, num_labels=4,
        optimizer="Adam", lr_gen=5e-5, lr_dis=2e-4, beta1=0.0,
        average_function="sum", finetune=False, iteration=0,
        set_eval_mode_in_train=False, batch_size=2, random_seed=0,
        compute_dtype="float32", num_devices=1, gan_type=gan_type,
        fm_weight=10.0, l1_weight=30.0, dis_embed_weight=1e-2,
        dice_weight=1.0, synthetic_num_labels=4, num_enc_frames=K,
        synthetic_frames_per_video=32, vgg_weights_dir="/nonexistent",
        allow_random_vgg=True, weights_running_average=True,
        grad_accum_steps=1, use_pixelwise_augs=False,
        use_affine_scale=False, use_affine_shift=False,
        transfer_dtype="float32", img_dir="images-cropped", data_root="",
        X2Face_num_identity_images=1)


def _modules(name):
    _, emb, gen, dis, criteria, _ = FAMILIES[name]
    return {"embedders": emb, "generators": gen, "discriminators": dis,
            "criterions": list(criteria.values())}


def _jax_models(args, name):
    modules = _modules(name)
    return {"embedder": modules["embedders"].Wrapper.get_net(args),
            "generator": modules["generators"].Wrapper.get_net(args),
            "discriminator": modules["discriminators"].Wrapper.get_net(args)}


class _SeededInit(fs._SeededInit):
    """:class:`test_torch_fsth_steps._SeededInit` with BatchNorm's leaves:
    scales 1 ± 0.1, means 0.1 x normal, variances U(0.5, 1.5)."""

    def _fill(self, path, shape):
        name, rng = path[-1].key, self._rng
        if name == "scale":
            return jnp.asarray(1.0 + rng.uniform(-0.1, 0.1, shape),
                               jnp.float32)
        if name == "mean":
            return jnp.asarray(0.1 * rng.standard_normal(shape), jnp.float32)
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, shape), jnp.float32)
        return super()._fill(path, shape)


def _meta_state(args, name, seed):
    opt_g, opt_d = build.build_optimizers(args, _modules(name))
    models = {k: _SeededInit(m, seed + i)
              for i, (k, m) in enumerate(_jax_models(args, name).items())}
    skeleton = build.init_train_state(args, models, opt_g, opt_d,
                                      jax.random.PRNGKey(0))
    return fs._jitter(skeleton, seed)


def _batch(img):
    data, target = JaxLoader(image_size=img, batch_size=2, num_labels=4,
                             num_enc_frames=K, finetune=False,
                             seed=0).get_batch(0)
    rng = np.random.RandomState(100)
    for d, key in ((data, "enc_rgbs"), (data, "pose_input_rgbs"),
                   (target, "target_rgbs")):
        d[key] = (d[key] + rng.uniform(0, 0.2, d[key].shape)
                  ).astype(np.float32)
    return data, target


def _jax_step(args, name, jstate, batch, float64):
    """The JAX step from ``jstate``: (the state after it as flat arrays,
    its scalars, its criteria); in f64 (x64, the state and batch in f64,
    the step's own f32 casts read as f64) or in f32."""
    with pytest.MonkeyPatch.context() as mp, \
            jax.enable_x64(float64):
        to = fs._float64 if float64 else (lambda tree: tree)
        if float64:
            mp.setattr(jholycow, "jnp", fs._Float64Numpy())
        opt_g, opt_d = build.build_optimizers(args, _modules(name))
        criteria = build.build_criteria(args, _modules(name))
        step = jholycow.make_train_step(_jax_models(args, name), criteria,
                                        args, opt_g, opt_d)
        data, target = batch
        state, scalars = step(to(jstate), to({**data, **target}),
                              jax.random.PRNGKey(0))
        return (fs._jax_flat(state), {k: float(v) for k, v in
                                      scalars.items()}, criteria)


@pytest.fixture(scope="module")
def meta_runs(tmp_path_factory):
    """``run(name)``: a JAX meta state and checkpoint of family ``name``,
    the JAX step from it (in f64 for :data:`FLOAT64`, else in f32), the
    port's state loaded from the checkpoint (exported) and after its f32
    step, made once a family; the checkpoints are deleted with it."""
    runs, workdir = {}, tmp_path_factory.mktemp("ablation_steps")

    def run(name):
        if name not in runs:
            args = _args(name)
            jstate = _meta_state(args, name, seed=7)
            path = jckpt.save_checkpoint(workdir / f"{name}_jax", jstate,
                                         args)
            batch = _batch(args.image_size)
            want, jscalars, jcriteria = _jax_step(args, name, jstate, batch,
                                                  name in FLOAT64)
            targs = fs._port_args(path, workdir / f"{name}_port")
            state = tcli.load_checkpoint(targs, fs.CPU)
            loaded = {k: np.array(v) for k, v in
                      convert.export_train_state(state).items()}
            scalars = fs._port_step(targs, jcriteria)(
                state, tholycow.to_device(batch, fs.CPU,
                                          tholycow.META_STEP_KEYS))
            got = {k: np.array(v) for k, v in
                   convert.export_train_state(state).items()}
            runs[name] = dict(args=args, jstate=jstate, path=path,
                              batch=batch, want=want, got=got,
                              loaded=loaded, jscalars=jscalars,
                              tscalars={k: float(v) for k, v in
                                        scalars.items()})
        return runs[name]

    yield run
    shutil.rmtree(workdir, ignore_errors=True)     # the checkpoints


@pytest.mark.parametrize("name", FLOAT64)
def test_first_meta_step_matches_jax_in_float64(meta_runs, name):
    """The losses, every gradient and second moment, update, BatchNorm
    statistic, (u, v) and EMA leaf of the port's f32 step against the
    JAX step in f64 from the same checkpoint and batch."""
    fs._assert_first_step(meta_runs(name))


def test_x2face_plus_meta_step_matches_the_jax_f32_step(meta_runs):
    """X2Face+ against the JAX step in f32: the losses, the leaves the
    steps write.  (In f32 its ResNeXt-50 gradients sit up to 29x the
    first-step bound from the JAX step in f64 on this batch, as the JAX
    package's own f32 step's do: train-form BatchNorm's conditioning,
    ROADMAP C.3, with rgan's G loss 0 here; FAbNet+ holds the same tower,
    generator and discriminator to the f64 step.)"""
    run = meta_runs("X2Face+")
    assert set(run["tscalars"]) == set(run["jscalars"])
    for key, want in run["jscalars"].items():
        np.testing.assert_allclose(run["tscalars"][key], want,
                                   rtol=fs.LOSS_RTOL, atol=1e-7, err_msg=key)
    assert set(run["got"]) == set(run["want"])


def test_x2face_step_trains_both_unets_without_a_discriminator(meta_runs):
    run = meta_runs("X2Face")
    got, start = run["got"], fs._jax_flat(run["jstate"])
    assert not any(k.startswith("opt_state_d") or "discriminator" in k
                   for k in got)
    assert not any("::embedder::" in k for k in got)
    assert run["tscalars"]["loss_D"] == run["jscalars"]["loss_D"] == 0.0
    for net in ("embedding_net", "driving_net"):
        key = f"params::generator::{net}::head::kernel"
        assert fs._l2(got[key] - start[key]) > 0, key


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_frozen_pose_encoder_is_bit_unchanged(meta_runs, name):
    """The frozen sub-network's parameters (and FAb-Net's BatchNorm
    statistics) after the step: the JAX step's and the port's, both equal
    to the checkpoint's; their moments zero in both; the identity tower
    moved."""
    run = meta_runs(name)
    got, want, start = run["got"], run["want"], fs._jax_flat(run["jstate"])
    frozen = [k for k in start if k.split("::")[0] in ("params",
                                                       "batch_stats")
              and k.split("::", 1)[1].startswith(FROZEN[name])]
    assert any(k.startswith("params::") for k in frozen)
    assert any(k.startswith("batch_stats::") for k in frozen) \
        == (name == "FAbNet+")
    for key in frozen:
        np.testing.assert_array_equal(got[key], start[key], err_msg=key)
        np.testing.assert_array_equal(want[key], start[key], err_msg=key)
        if key.startswith("params::"):
            for moment in ("mu", "nu"):
                mkey = key.replace("params::", f"opt_state_g::0::{moment}::")
                assert not np.any(got[mkey]) and not np.any(want[mkey]), mkey
    key = "params::embedder::identity_encoder::fc::kernel"
    assert fs._l2(got[key] - start[key]) > 0


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_meta_state_crosses_from_jax_array_for_array(meta_runs, name):
    """The JAX checkpoint read by the port and written back (before its
    step), array for array: the ``none`` discriminator's with no
    parameters and no optimizer state, FAb-Net's statistics included."""
    run = meta_runs(name)
    saved = _flatten(jckpt.load_arrays(run["path"]))
    assert set(run["loaded"]) == set(saved)
    for key, value in saved.items():
        np.testing.assert_array_equal(run["loaded"][key], value,
                                      err_msg=key)
    assert ("opt_state_d::0::count" in saved) == (name != "X2Face")
