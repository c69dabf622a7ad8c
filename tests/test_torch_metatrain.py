"""PyTorch port, the meta-train slice as a whole, held against the JAX
package: two whole meta steps from a JAX-written meta-trained state (with
and without gradient accumulation), optimizer state crossing in both
directions, ``dis_embed``, the meta loader, and the train CLI's meta-train
path.

Small sizes on the CPU: 64² frames, K=2 identity frames, a tiny generator
and discriminator, the ResNeXt-50, MobileNetV2 and VGG towers at their full
widths.  Both packages get the same numpy inputs and weights (the JAX VGG
towers' random arrays are handed to the port).  The steps run with
train-mode BatchNorm in both towers, the pose encoder's dropout replaced by
the identity in both packages (their masks cannot match across frameworks)
and augmentation off (each package draws it from its own generator; the ops
are held one by one in ``tests/test_torch_ops.py``).

The embedder towers are cut in depth, in both packages, to one block a
stage (ResNeXt-50 ``layers`` (1, 1, 1, 1), still its four link shapes;
MobileNetV2 one inverted residual a row of its table), at 64².  A network of
train-mode BatchNorms amplifies rounding at every block, and more where a
channel is nearly flat, since both packages take the one-pass variance
E[x²] - E[x]² in f32: at full depth and 32² the two packages' f32 gradients
of ResNeXt-50 sit 10-60 % off f64 ones (``tools/train_bn_conditioning.py``),
and the JAX package's XLA f32 sits up to 40 % off at this module's cut.
So the reference for the first step is the JAX step in f64 (x64, with the
state and batch in f64; AdaIN and σ keep f32 inside it, as in the port),
and the inputs keep channels from going flat: the generator's constant,
which starts at ones, is drawn from a normal (jittered ones leave its first
instance norm flat: 1 % gradient error in either package's f32), and the
frames get seeded noise (the synthetic faces' flat backgrounds).  There the
port's f32 step meets the f64 one leaf by leaf: every gradient (Adam's
first moment: beta1 = 0) and second moment, update, BatchNorm statistic,
(u, v), EMA leaf and loss (the bounds below, a few times what this module
measured).  Planted faults read far above them: 5 % off the Σy² cotangent
of the conv_bn link, 550 times its bound.

After two steps the states have drifted apart by what f32 rounding does to
Adam: with beta1 = 0 its first steps move each weight by about lr x the sign
of its gradient, so an entry whose gradient is near 0 (or is rounding noise,
as a bias before a train-mode BatchNorm has) moves by up to lr one way in one
package and the other way in the other.  So the second step (both packages
in f32) is held to drift bounds only, a few times what this module
measured; the crossing test reads the resumed state back exactly.
"""

import contextlib
import functools
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen
import torch
from flax import serialization

from latentpose_tpu import checkpoint as jckpt
from latentpose_tpu.checkpoint import _flatten
from latentpose_tpu.data.synthetic import SyntheticDataLoader as JaxLoader
from latentpose_tpu.losses import adversarial as jadv
from latentpose_tpu.losses import dice as jdice
from latentpose_tpu.losses import dis_embed as jdis_embed
from latentpose_tpu.losses import featmat as jfeatmat
from latentpose_tpu.losses import idt_embed as jidt
from latentpose_tpu.losses import perceptual as jperc
from latentpose_tpu.models.discriminators import no_landmarks as jdis_mod
from latentpose_tpu.models.embedders import (
    unsupervised_pose_separate_embResNeXt_segmentation as jemb_mod)
from latentpose_tpu.models.generators import (
    vector_pose_unsupervised_segmentation_noBottleneck as jgen_mod)
from latentpose_tpu.nn import backbones as jbackbones
from latentpose_tpu.runners import build
from latentpose_tpu.runners import holycow as jholycow
from latentpose_tpu_torch import convert
from latentpose_tpu_torch.cli import train as tcli
from latentpose_tpu_torch.losses import dis_embed as tdis_embed
from latentpose_tpu_torch.losses.common.perceptual_loss import (
    load_tower_arrays)
from latentpose_tpu_torch.models.embedders import (
    unsupervised_pose_separate_embResNeXt_segmentation as temb_mod)
from latentpose_tpu_torch.nn import backbones as tbackbones
from latentpose_tpu_torch.runners import holycow as tholycow

torch.set_num_threads(1)

IMG = 64
K = 2
LAYERS = (1, 1, 1, 1)     # ResNeXt-50 cut to one bottleneck a stage
CPU = torch.device("cpu")
JAX_CRITERIA = {"adversarial": jadv, "featmat": jfeatmat, "idt_embed": jidt,
                "perceptual": jperc, "dice": jdice, "dis_embed": jdis_embed}
MODULES = {"embedders": jemb_mod, "generators": jgen_mod,
           "discriminators": jdis_mod}
# the losses of a step from one state: f32 on the CPU, sums in another
# order than XLA's (as in tests/test_torch_train.py), and against f64
LOSS_RTOL = 1e-4
LEAF_ATOL = 1e-5
# the first step against the JAX package's in f64, measured: each moment
# leaf 2.1e-5 of its L2 norm at worst, 4.7e-4 with --grad_accum_steps 2
# (microbatches of one sample: the pose tower's last BatchNorms normalise 4
# values a channel); BatchNorm statistics and (u, v) 8.6e-6 of each leaf's
# largest value; losses 1.1e-6; the EMA 1.3e-7
FIRST_RTOL = {1: 1e-4, 2: 2e-3}      # by --grad_accum_steps
GRAD_FLOOR = 1e-6                    # of the module's moments' L2 norm
STATS_RTOL = 5e-5
UPDATE_RTOL = 5e-2                   # of a leaf's move (see the test)
# after two f32 steps in each package (measured: second-step losses 4.6e-4
# apart; weights 1.6e-3 of their L2 norm at worst; BatchNorm statistics,
# (u, v) and the discriminator's moments 2.2e-3 of each leaf's largest value)
DRIFT_LOSS_RTOL = 5e-3
DRIFT_RTOL = 1e-2
DRIFT_L2 = 5e-3
# the embedder's and generator's moments, in L2 over all of them
DRIFT_MOMENTS = 0.25
COLLECTIONS = ("params", "ema_params", "batch_stats", "spectral",
               "opt_state_g", "opt_state_d")
STEPS = 2


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
        dis_embed_weight=1e-2, dice_weight=1.0, synthetic_num_labels=4,
        num_enc_frames=K, synthetic_frames_per_video=32,
        vgg_weights_dir="/nonexistent", allow_random_vgg=True,
        weights_running_average=True, grad_accum_steps=1,
        use_pixelwise_augs=False, use_affine_scale=False,
        use_affine_shift=False)


class _JitInit:
    """A flax module whose ``init`` is jitted (eager init of the towers
    takes tens of seconds on the CPU)."""

    def __init__(self, module):
        self._module = module
        self.init = jax.jit(module.init)

    def __getattr__(self, name):
        return getattr(self._module, name)


class _NoDropout:
    """Stands in for ``flax.linen.Dropout``: the identity."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x, *args, **kwargs):
        return x


@pytest.fixture(scope="module", autouse=True)
def _shallow_towers():
    """Both packages' embedder towers cut to one block a stage (see the
    module docstring), for this module's tests."""
    short = tuple((t, c, 1, s) for t, c, _, s in
                  jbackbones.MobileNetV2.SETTINGS)
    with pytest.MonkeyPatch.context() as mp:
        for cls in (jbackbones.MobileNetV2, tbackbones.MobileNetV2):
            mp.setattr(cls, "SETTINGS", short)
        mp.setattr(jemb_mod, "ResNeXt50", functools.partial(
            jbackbones.ResNeXt50, layers=LAYERS))
        mp.setattr(temb_mod, "ResNeXt50", functools.partial(
            tbackbones.ResNeXt50, layers=LAYERS))
        yield


@contextlib.contextmanager
def _no_dropout():
    """Dropout as the identity in both packages, inside the block (the JAX
    step is traced, and cached, there)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        mp.setattr(tbackbones, "_dropout", lambda x, rate, generator=None: x)
        yield


def _jax_models(args):
    return {"embedder": jemb_mod.Wrapper.get_net(args),
            "generator": jgen_mod.Wrapper.get_net(args),
            "discriminator": jdis_mod.Wrapper.get_net(args)}


def _jax_skeleton(args):
    opt_g, opt_d = build.build_optimizers(args, MODULES)
    return build.init_train_state(
        args, {k: _JitInit(m) for k, m in _jax_models(args).items()}, opt_g,
        opt_d, jax.random.PRNGKey(0))


def _batch(i):
    """Meta batch ``i`` of the JAX loader (the port's is bit-identical,
    :func:`test_meta_loader_is_bit_identical`), its frames with seeded
    noise added (module docstring)."""
    data, target = JaxLoader(image_size=IMG, batch_size=2, num_labels=4,
                             num_enc_frames=K, finetune=False,
                             seed=0).get_batch(i)
    rng = np.random.RandomState(100 + i)
    for d, key in ((data, "enc_rgbs"), (data, "pose_input_rgbs"),
                   (target, "target_rgbs")):
        d[key] = (d[key] + rng.uniform(0, 0.2, d[key].shape)
                  ).astype(np.float32)
    return data, target


@pytest.fixture(scope="module")
def meta(tmp_path_factory):
    """A JAX meta-trained state (weights, EMA and BatchNorm statistics off
    their init, fresh Adam) and its checkpoint."""
    args = _meta_args()
    state = _jax_skeleton(args)
    rng = np.random.RandomState(7)

    def jitter(scale, low=None):
        def f(v):
            v = np.asarray(v)
            if low is not None:
                return rng.uniform(low, low + scale, v.shape).astype(v.dtype)
            return v + rng.uniform(-scale, scale, v.shape).astype(v.dtype)
        return f

    params = jax.tree_util.tree_map(jitter(0.02), state.params)
    # the generator's constant input starts at ones: jittered, every channel
    # of its first instance norm is nearly flat and the one-pass variance
    # cancels (module docstring); a trained constant is not flat
    params["generator"]["constant"] = rng.standard_normal(
        params["generator"]["constant"].shape).astype(np.float32)
    state = state.replace(
        params=params,
        ema_params=jax.tree_util.tree_map(jitter(0.05), state.ema_params),
        batch_stats=jax.tree_util.tree_map(jitter(1.0, 0.5),
                                           state.batch_stats))
    path = jckpt.save_checkpoint(tmp_path_factory.mktemp("jax_meta"), state,
                                 args)
    return state, path


def _tower_arrays(jax_criterion):
    crit = getattr(jax_criterion, "perceptual_crit", None) \
        or jax_criterion.idt_embed_crit
    return {k.replace("::", "/"): v for k, v in
            _flatten(jax.device_get(crit.variables["params"])).items()}


def _jax_criteria(args):
    return build.build_criteria(args, {"criterions": [
        JAX_CRITERIA[n.strip()] for n in args.criterions.split(",")]})


def _port_args(path, workdir, accum=1):
    return tcli.resolve_args([
        "--checkpoint_path", str(path), "--dataloader", "synthetic",
        "--device", "cpu", "--allow_random_vgg", "--num_epochs", "1",
        "--experiments_dir", str(workdir), "--no-use_pixelwise_augs",
        "--no-use_affine_scale", "--no-use_affine_shift",
        "--grad_accum_steps", str(accum)])


def _port_step(targs, jcriteria):
    """The port's step with the JAX criteria's VGG tower arrays."""
    criteria = tcli.build_criteria(targs, CPU)
    for crit, jcrit in zip(criteria, jcriteria):
        tower = getattr(crit, "perceptual_crit", None) \
            or getattr(crit, "idt_embed_crit", None)
        if tower is not None:
            load_tower_arrays(tower.module, _tower_arrays(jcrit))
    return tcli.make_step(targs, criteria)


def _run_port(step, state, batches):
    out = []
    for i in batches:
        scalars = step(state, tholycow.to_device(
            _batch(i), CPU, tholycow.META_STEP_KEYS))
        out.append({k: float(v) for k, v in scalars.items()})
    return out


def _run_jax(jstep, state, batches):
    out = []
    for i in batches:
        data, target = _batch(i)
        state, scalars = jstep(state, {**data, **target},
                               jax.random.fold_in(jax.random.PRNGKey(0), i))
        out.append({k: float(v) for k, v in scalars.items()})
    return state, out


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``: the JAX step's
    own f32 casts and zero accumulators (the ``--grad_accum_steps`` scan's
    carry), for its f64 run.  AdaIN and the spectral norm's σ keep their
    f32 arithmetic inside the JAX package, as in the port."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _float64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


def _jax_first_step_in_float64(jargs, jstate):
    """The JAX package's first step from ``jstate`` in f64 (x64, the state,
    the batch and the VGG towers' activations in f64): the reference for
    the port's f32 step (module docstring)."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jholycow, "jnp", _Float64Numpy())
        opt_g, opt_d = build.build_optimizers(jargs, MODULES)
        jstep = jholycow.make_train_step(_jax_models(jargs),
                                         _jax_criteria(jargs), jargs, opt_g,
                                         opt_d)
        data, target = _batch(0)
        state, scalars = jstep(_float64(jstate), _float64({**data, **target}),
                               jax.random.fold_in(jax.random.PRNGKey(0), 0))
        return _jax_flat(state), {k: float(v) for k, v in scalars.items()}


@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2"])
def runs(request, meta, tmp_path_factory):
    """Two meta steps in both packages from the same JAX meta state, each
    through its own step, the port's state after its first step, and the
    JAX package's first step in f64; ``--grad_accum_steps`` 1 or 2."""
    accum = request.param
    jmeta, path = meta
    workdir = tmp_path_factory.mktemp(f"port_meta{accum}")
    targs = _port_args(path, workdir, accum)
    jargs = types.SimpleNamespace(**vars(targs))
    jargs.num_labels = 4
    with _no_dropout():
        opt_g, opt_d = build.build_optimizers(jargs, MODULES)
        jcriteria = _jax_criteria(jargs)
        jstep = jholycow.make_train_step(_jax_models(jargs), jcriteria,
                                         jargs, opt_g, opt_d)
        jstate, jscalars = _run_jax(jstep, jmeta, range(STEPS))
        tstate = tcli.load_checkpoint(targs, CPU)
        tstep = _port_step(targs, jcriteria)
        tscalars = _run_port(tstep, tstate, range(1))
        tfirst = {k: np.array(v)     # a copy: the export aliases the state
                  for k, v in convert.export_train_state(tstate).items()}
        tscalars += _run_port(tstep, tstate, range(1, STEPS))
        jfirst64, jscalars64 = _jax_first_step_in_float64(jargs, jmeta)
        yield dict(accum=accum, jargs=jargs, jstep=jstep, jstate=jstate,
                   jscalars=jscalars, targs=targs, tstep=tstep,
                   tstate=tstate, tscalars=tscalars, tfirst=tfirst,
                   jfirst64=jfirst64, jscalars64=jscalars64,
                   start=_jax_flat(jmeta), workdir=workdir)


def _jax_flat(state):
    return _flatten(serialization.to_state_dict(jax.device_get(state)))


def _assert_losses_match(got, want, rtol=LOSS_RTOL):
    assert set(got) == set(want)
    assert len(want) == 9     # 6 criteria (adversarial G and D) + the sums
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=1e-7,
                                   err_msg=key)


@pytest.mark.parametrize("step", range(STEPS))
def test_meta_step_losses_match_jax(runs, step):
    """The first step starts from one state in both packages; the second
    from states that two f32 Adam steps moved apart (module docstring)."""
    _assert_losses_match(runs["tscalars"][step], runs["jscalars"][step],
                         LOSS_RTOL if step == 0 else DRIFT_LOSS_RTOL)


def _l2(a):
    return float(np.sqrt(np.sum(np.square(a, dtype=np.float64))))


def _part(key):
    """(collection or moment, module) of a flat key."""
    fields = key.split("::")
    if fields[0].startswith("opt_state"):
        return fields[2], fields[3]
    return fields[0], fields[1]


def _worst(ratios):
    """The largest of {key: error / bound}, printed with its key."""
    key = max(ratios, key=ratios.get)
    print(f"worst {key}: {ratios[key]:.3g} of its bound")
    return ratios[key]


def test_first_meta_step_matches_jax_in_float64(runs):
    """The port's first f32 step against the JAX package's in f64 from the
    same state and batch (module docstring): the losses; every gradient,
    leaf by leaf, as Adam's first moment (beta1 = 0: mu is the gradient,
    averaged over the microbatches), and the second moment; each weight's
    update; the BatchNorm statistics, (u, v) and the EMA."""
    got, want = runs["tfirst"], runs["jfirst64"]
    _assert_losses_match(runs["tscalars"][0], runs["jscalars64"])
    start = runs["start"]
    norms = {}          # each (moment, module)'s L2 norm: the floor's scale
    for key in want:
        if key.startswith("opt_state") and not key.endswith("::count"):
            norms[_part(key)] = np.hypot(norms.get(_part(key), 0.0),
                                         _l2(want[key]))
    grads, updates, stats = {}, {}, {}
    for key in sorted(set(got) - {"step"}):
        g = np.asarray(got[key], np.float64)
        w = np.asarray(want[key], np.float64)
        collection = key.split("::")[0]
        if key.endswith("::count"):
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif collection.startswith("opt_state"):
            # a bias before a norm has a gradient of 0: its f32 value is
            # rounding, held by the floor
            grads[key] = _l2(g - w) / (
                FIRST_RTOL[runs["accum"]] * _l2(w)
                + GRAD_FLOOR * norms[_part(key)])
        elif collection == "params":
            # against the larger of its move and Adam's full move of lr
            # an entry (a bias before a norm does not move)
            lr = runs["targs"].lr_dis if _part(key)[1] == "discriminator" \
                else runs["targs"].lr_gen
            move = max(_l2(w - np.asarray(start[key], np.float64)),
                       lr * np.sqrt(w.size))
            updates[key] = _l2(g - w) / (UPDATE_RTOL * move)
        elif collection == "ema_params":
            stats[key] = np.abs(g - w).max() / LEAF_ATOL
        else:       # batch_stats, spectral
            stats[key] = np.abs(g - w).max() / (
                STATS_RTOL * np.abs(w).max() + 1e-30)
    assert len(grads) == 2 * len(updates)
    for ratios in (grads, updates, stats):
        assert _worst(ratios) <= 1.0


def test_two_meta_steps_leave_the_jax_state(runs):
    """Every parameter (both towers, generator, discriminator), EMA leaf,
    BatchNorm statistic, spectral-norm (u, v) and Adam moment after two
    f32 steps in each package, and the step and Adam counters, within the
    drift bounds (module docstring)."""
    got = convert.export_train_state(runs["tstate"])
    want = _jax_flat(runs["jstate"])
    assert int(got["step"]) == int(want["step"]) == STEPS
    assert runs["tstate"].opt_g.count == runs["tstate"].opt_d.count == STEPS
    for collection in COLLECTIONS:
        keys = {k for k in got if k.startswith(collection + "::")}
        assert keys and keys == {k for k in want
                                 if k.startswith(collection + "::")}
    weights, stats = {}, {}
    g_moments = [0.0, 0.0]
    for key in sorted(set(got) - {"step"}):
        g = np.asarray(got[key], np.float64)
        w = np.asarray(want[key], np.float64)
        collection = key.split("::")[0]
        if key.endswith("::count"):
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif collection == "ema_params":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=LEAF_ATOL,
                                       err_msg=key)
        elif collection == "params":
            weights[key] = _l2(g - w) / (DRIFT_L2 * _l2(w))
        elif collection == "opt_state_g":
            g_moments[0] += _l2(g - w) ** 2
            g_moments[1] += _l2(w) ** 2
        else:       # batch_stats, spectral, opt_state_d
            stats[key] = np.abs(g - w).max() / (
                DRIFT_RTOL * np.abs(w).max() + 1e-30)
    assert _worst(weights) <= 1.0 and _worst(stats) <= 1.0
    moments = np.sqrt(g_moments[0] / g_moments[1])
    print(f"generator side's moments: {moments:.3g} apart (L2)")
    assert moments <= DRIFT_MOMENTS


def test_meta_train_moved_both_towers(runs, meta):
    """Meta-training trains the embedder: both towers' weights and the
    identity tower's running statistics moved off the meta state."""
    got = convert.export_train_state(runs["tstate"])
    start = _jax_flat(meta[0])
    for key in ("params::embedder::identity_encoder::layer1_0::conv3::kernel",
                "params::embedder::pose_encoder::classifier::kernel",
                "params::generator::head_conv::kernel",
                "batch_stats::embedder::identity_encoder::layer4_0::bn3::"
                "mean"):
        assert not np.allclose(got[key], start[key]), key


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_optimizer_state_crosses_between_the_packages(runs, meta, writer,
                                                      tmp_path):
    """A meta checkpoint after two steps, written by one package with both
    Adam states, is read back by the other exactly (every key, the moments
    and counts included), and the third step from it gives the losses that
    the writer's package gives from the same state; the step and both
    counts continue to 3."""
    targs = runs["targs"]
    if writer == "jax":
        path = jckpt.save_checkpoint(tmp_path / "jax", runs["jstate"],
                                     runs["jargs"])
        jstate = runs["jstate"]
    else:
        targs.experiment_dir = str(tmp_path / "port")
        path = tcli.save(targs, runs["tstate"])
        jstate = jckpt.restore_state(path, meta[0])    # the structure
    tstate = tcli.load_checkpoint(_port_args(path, tmp_path, runs["accum"]),
                                  CPU)
    written = tcli.ckpt_lib.load_arrays(path)
    for name, flat in (("port", convert.export_train_state(tstate)),
                       ("jax", _jax_flat(jstate))):
        assert set(flat) == set(written), name
        for key, value in written.items():
            np.testing.assert_array_equal(flat[key], value,
                                          err_msg=f"{name} {key}")
    with _no_dropout():
        got = _run_port(runs["tstep"], tstate, [STEPS])
        jstate, want = _run_jax(runs["jstep"], jstate, [STEPS])
    _assert_losses_match(got[0], want[0])
    assert tstate.step == int(jstate.step) == STEPS + 1
    assert tstate.opt_g.count == tstate.opt_d.count == STEPS + 1
    assert int(jstate.opt_state_g[0].count) == STEPS + 1


# --- dis_embed, the loader, the CLI ------------------------------------------

def test_dis_embed_matches_jax_with_gradient():
    rng = np.random.RandomState(31)
    elem = rng.standard_normal((3, K, 16)).astype(np.float32)
    rows = rng.standard_normal((3, 16)).astype(np.float32)
    crit = jdis_embed.Criterion(1e-2)

    def jloss(e, r):
        return crit({"embeds_elemwise": e,
                     "real_embedding": r})["embedding_matching"]

    want, (want_de, want_dr) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(elem), jnp.asarray(rows))
    te, tr = (torch.from_numpy(a).requires_grad_() for a in (elem, rows))
    got = tdis_embed.Criterion(1e-2)({"embeds_elemwise": te,
                                      "real_embedding": tr})
    got["embedding_matching"].backward()
    np.testing.assert_allclose(float(got["embedding_matching"].detach()),
                               float(want),
                               rtol=1e-6)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(want_de),
                               rtol=1e-6, atol=1e-9)
    assert tr.grad is None or not tr.grad.any()     # the row is detached
    assert not np.asarray(want_dr).any()


def test_meta_loader_is_bit_identical():
    """The port's meta loader draws the JAX loader's batches: K distinct
    frames per identity, the driver and target from frames[-2], labels over
    num_labels; same keys, dtypes and values over two epochs."""
    from latentpose_tpu_torch.data.synthetic import SyntheticDataLoader
    want = JaxLoader(image_size=IMG, batch_size=3, num_labels=7,
                     num_enc_frames=3, finetune=False, seed=5)
    got = SyntheticDataLoader(IMG, 3, num_labels=7, num_enc_frames=3,
                              finetune=False, seed=5)
    assert len(got) == len(want) == 2 and got.num_labels == want.num_labels
    for _ in range(2):
        for (wd, wt), (gd, gt) in zip(list(want), list(got)):
            for w, g in ((wd, gd), (wt, gt)):
                assert set(g) == set(w)
                for key in w:
                    assert g[key].dtype == w[key].dtype, key
                    np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            assert not np.array_equal(gd["enc_rgbs"][:, 0],
                                      gd["enc_rgbs"][:, 1])


def test_meta_config_equals_the_config_file():
    """The port reads configs/default.yaml (without yaml, which is absent
    where the card is) as yaml reads it, and the resolved args take its
    numbers through the options' types, as the JAX CLI does."""
    import yaml
    from pathlib import Path
    from latentpose_tpu_torch import config as tconfig
    configs = Path(__file__).resolve().parent.parent / "configs"
    cfg = yaml.safe_load((configs / "default.yaml").read_text())
    got = tconfig.load_yaml_config("default", configs)
    assert got == cfg and all(type(got[k]) is type(v) for k, v in cfg.items())
    assert cfg["perc_weight"] == "3e-2"     # YAML 1.1: no dot, no float
    args = tcli.resolve_args(["--config_name", "default", "--dataloader",
                              "synthetic"])
    assert (args.perc_weight, args.idt_embed_weight, args.batch_size) == \
        (3e-2, 0.6e-2, 8)
    assert args.use_pixelwise_augs and args.runner == "holycow"


def test_cli_meta_trains_from_a_fresh_init_and_resumes(tmp_path):
    """``main`` without a checkpoint: a seeded init of the models, one step
    (augmentation on, as the meta config has it), a checkpoint with both
    Adam states; resuming it takes the next step with step and count
    continued."""
    argv = ["--config_name", "default", "--dataloader", "synthetic",
            "--device", "cpu", "--allow_random_vgg", "--image_size", str(IMG),
            "--num_channels", "4", "--max_num_channels", "16",
            "--embed_channels", "16", "--pose_embedding_size", "8",
            "--dis_num_blocks", "3", "--gen_num_residual_blocks", "1",
            "--batch_size", "2", "--synthetic_num_labels", "2",
            "--num_enc_frames", str(K), "--num_epochs", "1",
            "--experiments_dir", str(tmp_path)]
    state, path = tcli.main(argv)
    assert not state.finetune and state.step == 1
    assert state.opt_g.count == state.opt_d.count == 1
    assert path.name == "model_00000001.ckpt"
    args = tcli.ckpt_lib.peek_args(path)
    assert args["use_pixelwise_augs"] and args["num_labels"] == 2
    flat = tcli.ckpt_lib.load_arrays(path)
    assert int(flat["opt_state_g::0::count"]) == 1
    state, path = tcli.main(argv + ["--checkpoint_path", str(path)])
    assert state.step == 2 and state.opt_g.count == 2
    assert path.name == "model_00000002.ckpt"



def test_dropout_masks_are_keyed_on_seed_and_step():
    """The pose encoder's dropout masks of a step are a function of (seed,
    step), as the augmentation's draws are, on a key of their own: a resumed
    run draws the masks that an unbroken run draws at that step."""
    from latentpose_tpu_torch.data import augmentation

    def draws(gen):
        return torch.rand(64, generator=gen)

    def masks(seed, step):
        return draws(tholycow.step_dropout_generator(seed, step))

    assert torch.equal(masks(3, 7), masks(3, 7))
    assert not torch.equal(masks(3, 7), masks(3, 8))
    assert not torch.equal(masks(3, 7), masks(4, 7))
    assert not torch.equal(masks(3, 7),
                           draws(augmentation.step_draw(3, 7, "cpu").gen))
