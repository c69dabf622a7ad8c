"""PyTorch port, the FSTH family's train steps held against the JAX package:
one FSTH meta step, one FSTH fine-tune step (the packed AdaIN parameters
``finetune_affine`` trained, the projector untouched) and one FSTH_plus
meta step, each from a JAX-written checkpoint that the port loads through
``cli.train``'s functions.

Small sizes on the CPU: 32² synthetic faces with their stickmen and
keypoints (``--synthetic_stickmen``) and seeded noise on the frames, K=2,
widths 4-16, one residual block; the criteria adversarial, featmat,
l1_rgb and idt_embed (its box from the keypoints, VGGFace with the JAX
criterion's random tower arrays).  As in ``tests/test_torch_metatrain.py``
the reference is the JAX step in f64 (``jax.enable_x64``, the JAX step's
own f32 casts read as f64; AdaIN and σ keep f32 inside it), and the port's
f32 step meets it leaf by leaf: every gradient (the first moment, beta1 = 0)
and second moment within FIRST_RTOL of its leaf's L2, each update within
UPDATE_RTOL of its move, (u, v) and the EMA.  The family has no
BatchNorm; its worst leaf reads under half its bound, and a planted
fault (the stickman channels of the discriminator's input swapped
with the image's) reads over a hundred times it."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from latentpose_tpu import checkpoint as jckpt
from latentpose_tpu.checkpoint import _flatten
from latentpose_tpu.data.synthetic import SyntheticDataLoader as JaxLoader
from latentpose_tpu.losses import adversarial as jadv
from latentpose_tpu.losses import featmat as jfeatmat
from latentpose_tpu.losses import idt_embed as jidt
from latentpose_tpu.losses import l1_rgb as jl1
from latentpose_tpu.models.discriminators import FSTH as jdis_mod
from latentpose_tpu.models.embedders import FSTH as jemb_mod
from latentpose_tpu.models.generators import FSTH as jgen_mod
from latentpose_tpu.models.generators import FSTH_plus as jgen_plus_mod
from latentpose_tpu.runners import build
from latentpose_tpu.runners import finetune as jft
from latentpose_tpu.runners import holycow as jholycow
from latentpose_tpu_torch import convert
from latentpose_tpu_torch.cli import train as tcli
from latentpose_tpu_torch.losses.common.perceptual_loss import (
    load_tower_arrays)
from latentpose_tpu_torch.models.discriminators import FSTH as tdis_mod
from latentpose_tpu_torch.runners import holycow as tholycow

torch.set_num_threads(1)

IMG = 32
K = 2
CPU = torch.device("cpu")
JAX_CRITERIA = (jadv, jfeatmat, jl1, jidt)
GENERATORS = {"FSTH": jgen_mod, "FSTH_plus": jgen_plus_mod}
FIRST_RTOL = 1e-4                    # of each leaf's L2
GRAD_FLOOR = 1e-6                    # of the module's moments' L2 norm
UPDATE_RTOL = 5e-2                   # of a leaf's move
STATS_RTOL = 5e-5                    # (u, v), of the leaf's max
LEAF_ATOL = 1e-5                     # EMA
LOSS_RTOL = 1e-4
ADAM_EPS = 1e-5                      # runners/finetune.py optimizers


def fsth_args(generator="FSTH", finetune=False):
    return types.SimpleNamespace(
        generator=generator, embedder="FSTH", discriminator="FSTH",
        dataloader="synthetic",
        criterions="adversarial, featmat, l1_rgb, idt_embed",
        image_size=IMG, in_channels=3, out_channels=3, num_channels=4,
        max_num_channels=16, embed_channels=16, pose_embedding_size=136,
        gen_padding="zero", gen_num_downsample_blocks=2,
        gen_num_residual_blocks=1, gen_constant_input_size=4,
        norm_layer="in", dis_padding="zero", dis_num_blocks=3, num_labels=4,
        optimizer="RAdam" if finetune else "Adam",
        lr_gen=5e-4 if finetune else 5e-5, lr_dis=8e-4 if finetune else 2e-4,
        beta1=0.0, average_function="sum", finetune=finetune, iteration=0,
        set_eval_mode_in_train=False, batch_size=2, random_seed=0,
        compute_dtype="float32", num_devices=1, gan_type="gan",
        fm_weight=10.0, l1_weight=30.0, idt_embed_weight=2e-3,
        embed_padding="zero", embed_num_blocks=3, synthetic_num_labels=4,
        num_enc_frames=K, synthetic_frames_per_video=32,
        synthetic_stickmen=True, vgg_weights_dir="/nonexistent",
        allow_random_vgg=True, weights_running_average=True,
        grad_accum_steps=1, use_pixelwise_augs=False,
        use_affine_scale=False, use_affine_shift=False,
        transfer_dtype="float32", img_dir="images-cropped", data_root="")


class _SeededInit:
    """A flax module whose ``init`` fills its variables' shapes (traced
    with ``jax.eval_shape``, not compiled) from a seeded numpy draw:
    kernels U(±1/sqrt(fan_in)), biases U(±0.05), the instance norms'
    weights 1 ± 0.1, the projection table U(±0.1), the constant from a
    normal (a flat one leaves the first instance norm flat), spectral
    (u, v) random unit vectors."""

    def __init__(self, module, seed):
        self._module = module
        self._rng = np.random.RandomState(seed)

    def _fill(self, path, shape):
        name, rng = path[-1].key, self._rng
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            value = rng.uniform(-bound, bound, shape)
        elif name == "bias":
            value = rng.uniform(-0.05, 0.05, shape)
        elif name == "weight":
            value = 1.0 + rng.uniform(-0.1, 0.1, shape)
        elif name == "embedding":
            value = rng.uniform(-0.1, 0.1, shape)
        elif name == "constant":
            value = rng.standard_normal(shape)
        else:       # spectral u, v
            value = rng.standard_normal(shape)
            value /= np.linalg.norm(value)
        return jnp.asarray(value, jnp.float32)

    def init(self, *args):
        return jax.tree_util.tree_map_with_path(
            lambda path, s: self._fill(path, s.shape),
            jax.eval_shape(self._module.init, *args))

    def __getattr__(self, name):
        return getattr(self._module, name)


def _modules(args):
    return {"embedders": jemb_mod, "generators": GENERATORS[args.generator],
            "discriminators": jdis_mod,
            "criterions": list(JAX_CRITERIA)}


def _jax_models(args):
    modules = _modules(args)
    return {"embedder": modules["embedders"].Wrapper.get_net(args),
            "generator": modules["generators"].Wrapper.get_net(args),
            "discriminator": modules["discriminators"].Wrapper.get_net(args)}


def _batch(finetune=False):
    """The first synthetic batch with stickmen and keypoints, its frames
    with seeded noise added."""
    data, target = JaxLoader(image_size=IMG, batch_size=2, num_labels=4,
                             num_enc_frames=K, finetune=finetune, seed=0,
                             stickmen=True).get_batch(0)
    rng = np.random.RandomState(100)
    for d, key in ((data, "enc_rgbs"), (data, "pose_input_rgbs"),
                   (target, "target_rgbs")):
        d[key] = (d[key] + rng.uniform(0, 0.2, d[key].shape)
                  ).astype(np.float32)
    return data, target


def _jitter(state, seed):
    """The state's EMA moved off its parameters."""
    rng = np.random.RandomState(seed)
    return state.replace(ema_params=jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(-0.05, 0.05, np.shape(v))
        .astype(np.float32), state.ema_params))


def _jax_flat(state):
    return _flatten(serialization.to_state_dict(jax.device_get(state)))


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``: the JAX step's
    own f32 casts, for its f64 run."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _float64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


def _jax_step_in_float64(args, models, jstate, batch):
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jholycow, "jnp", _Float64Numpy())
        opt_g, opt_d = build.build_optimizers(args, _modules(args))
        criteria = build.build_criteria(args, _modules(args))
        step = jholycow.make_train_step(models, criteria, args, opt_g, opt_d)
        data, target = batch
        state, scalars = step(_float64(jstate), _float64({**data, **target}),
                              jax.random.PRNGKey(0))
        return (_jax_flat(state), {k: float(v) for k, v in scalars.items()},
                criteria)


def _tower_arrays(jax_criterion):
    crit = jax_criterion.idt_embed_crit
    return {k.replace("::", "/"): v for k, v in
            _flatten(jax.device_get(crit.variables["params"])).items()}


def _port_step(targs, jcriteria):
    """The port's step with the JAX criteria's VGG tower arrays."""
    criteria = tcli.build_criteria(targs, CPU)
    for crit, jcrit in zip(criteria, jcriteria):
        if hasattr(crit, "idt_embed_crit"):
            load_tower_arrays(crit.idt_embed_crit.module,
                              _tower_arrays(jcrit))
    return tcli.make_step(targs, criteria)


def _port_args(path, workdir, finetune=False):
    return tcli.resolve_args(
        ["--checkpoint_path", str(path), "--device", "cpu",
         "--allow_random_vgg", "--num_epochs", "1", "--experiments_dir",
         str(workdir)] + (["--finetune"] if finetune else []))


def _run_port(path, workdir, batch, jcriteria, finetune=False):
    """One port step from the checkpoint: (the state after it as flat
    arrays, its scalars, the state)."""
    targs = _port_args(path, workdir, finetune)
    state = tcli.load_checkpoint(targs, CPU)
    keys = tholycow.STEP_KEYS if finetune else tholycow.META_STEP_KEYS
    scalars = _port_step(targs, jcriteria)(
        state, tholycow.to_device(batch, CPU, keys))
    flat = {k: np.array(v)        # a copy: the export aliases the state
            for k, v in convert.export_train_state(state).items()}
    return flat, {k: float(v) for k, v in scalars.items()}, state


def _meta_state(args, seed):
    opt_g, opt_d = build.build_optimizers(args, _modules(args))
    models = {k: _SeededInit(m, seed + i)
              for i, (k, m) in enumerate(_jax_models(args).items())}
    skeleton = build.init_train_state(args, models, opt_g, opt_d,
                                      jax.random.PRNGKey(0))
    return _jitter(skeleton, seed)


@pytest.fixture(scope="module")
def meta_runs(tmp_path_factory):
    """``run(generator)``: a JAX meta state and checkpoint of
    ``generator``, the JAX step from it in f64 and the port's f32 step from
    the checkpoint, made once a generator."""
    runs = {}

    def run(generator):
        if generator not in runs:
            args = fsth_args(generator)
            jstate = _meta_state(args, seed=7)
            path = jckpt.save_checkpoint(tmp_path_factory.mktemp("jax_meta"),
                                         jstate, args)
            batch = _batch()
            want, jscalars, jcriteria = _jax_step_in_float64(
                args, _jax_models(args), jstate, batch)
            got, tscalars, _ = _run_port(path, tmp_path_factory.mktemp("port"),
                                         batch, jcriteria)
            runs[generator] = dict(
                args=args, jstate=jstate, path=path, batch=batch, want=want,
                got=got, jscalars=jscalars, tscalars=tscalars,
                jcriteria=jcriteria)
        return runs[generator]

    return run


@pytest.fixture(scope="module")
def finetuned(meta_runs, tmp_path_factory):
    """A JAX fine-tune state (``enable_finetuning`` with the FSTH
    generator's wrapper) of the FSTH meta state, its checkpoint, and one
    step of each package from it.  (The FSTH_plus fine-tune trains ê, as
    the flagship's does.)"""
    meta = meta_runs("FSTH")
    args = fsth_args("FSTH", finetune=True)
    models = _jax_models(args)
    opt_g, opt_d = build.build_optimizers(args, _modules(args))
    e_hat = np.random.RandomState(3).normal(0, 1, (1, 16)).astype(np.float32)
    models, jstate = jft.enable_finetuning(
        meta["jstate"], models, jdis_mod.Wrapper, args, jnp.asarray(e_hat),
        opt_g, opt_d, jax.random.PRNGKey(2), gen_wrapper=jgen_mod.Wrapper)
    path = jckpt.save_checkpoint(tmp_path_factory.mktemp("jax_ft"), jstate,
                                 args)
    batch = _batch(finetune=True)
    want, jscalars, jcriteria = _jax_step_in_float64(args, models, jstate,
                                                     batch)
    got, tscalars, _ = _run_port(path, tmp_path_factory.mktemp("port_ft"),
                                 batch, jcriteria, finetune=True)
    return dict(args=args, jstate=jstate, path=path, want=want, got=got,
                jscalars=jscalars, tscalars=tscalars)


def _l2(a):
    return float(np.sqrt(np.sum(np.square(a, dtype=np.float64))))


def _part(key):
    fields = key.split("::")
    if fields[0].startswith("opt_state"):
        return fields[2], fields[3]
    return fields[0], fields[1]


def _ratios(got, want, start, args):
    """{key: error / bound} of every leaf of the port's state after its
    first step against the JAX step's in f64, by kind."""
    norms = {}
    for key in want:
        if key.startswith("opt_state") and not key.endswith("::count"):
            norms[_part(key)] = np.hypot(norms.get(_part(key), 0.0),
                                         _l2(want[key]))
    out = {"grads": {}, "updates": {}, "stats": {}}
    assert set(got) == set(want)
    for key in sorted(set(got) - {"step"}):
        g = np.asarray(got[key], np.float64)
        w = np.asarray(want[key], np.float64)
        collection = key.split("::")[0]
        if key.endswith("::count"):
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif collection.startswith("opt_state"):
            out["grads"][key] = _l2(g - w) / (
                FIRST_RTOL * _l2(w) + GRAD_FLOOR * norms[_part(key)]
                + 1e-30)
        elif collection == "params":
            dis = _part(key)[1] == "discriminator"
            lr = args.lr_dis if dis else args.lr_gen
            move = max(_l2(w - np.asarray(start[key], np.float64)),
                       lr * np.sqrt(w.size))
            # a gradient far below Adam's eps moves its entry by about
            # lr g / eps, so the gradient's own error (held above) moves
            # the update by lr dg / eps: a bias before an instance norm,
            # whose gradient is rounding
            mu = key.replace("params::", f"opt_state_{'d' if dis else 'g'}"
                             "::0::mu::", 1)
            noise = 0.0 if mu not in want else lr * _l2(
                np.asarray(got[mu], np.float64)
                - np.asarray(want[mu], np.float64)) / ADAM_EPS
            out["updates"][key] = _l2(g - w) / (UPDATE_RTOL * move + noise)
        elif collection == "ema_params":
            out["stats"][key] = np.abs(g - w).max() / LEAF_ATOL
        else:       # spectral
            out["stats"][key] = np.abs(g - w).max() / (
                STATS_RTOL * np.abs(w).max() + 1e-30)
    return out


def _assert_first_step(run):
    for key, want in run["jscalars"].items():
        np.testing.assert_allclose(run["tscalars"][key], want,
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=key)
    assert set(run["tscalars"]) == set(run["jscalars"])
    ratios = _ratios(run["got"], run["want"], _jax_flat(run["jstate"]),
                     run["args"])
    assert ratios["grads"] and ratios["updates"]
    for kind, values in ratios.items():
        key = max(values, key=values.get)
        print(f"{kind}: worst {key} {values[key]:.3g} of its bound")
        assert values[key] <= 1.0, (kind, key, values[key])


@pytest.mark.parametrize("generator", sorted(GENERATORS))
def test_first_meta_step_matches_jax_in_float64(meta_runs, generator):
    """FSTH and FSTH_plus: the losses, every gradient and second moment,
    update, (u, v) and EMA leaf of the port's f32 step against the JAX
    step in f64 from the same checkpoint and batch."""
    meta = meta_runs(generator)
    _assert_first_step(meta)
    assert "Loss_l1_rgb" in meta["tscalars"]


def test_first_fine_tune_step_matches_jax_in_float64(finetuned):
    """The FSTH fine-tune trains ``finetune_affine`` (and the generator):
    the step leaf by leaf against the JAX step in f64; the projector, which
    the forward does not read, keeps its weights and its (u, v)."""
    _assert_first_step(finetuned)
    got, start = finetuned["got"], _jax_flat(finetuned["jstate"])
    assert "params::finetune_affine" in got
    assert "params::finetune_embedding" not in got
    assert _l2(got["params::finetune_affine"]
               - start["params::finetune_affine"]) > 0
    for key in ("params::generator::project::kernel",
                "spectral::generator::project::u"):
        np.testing.assert_array_equal(got[key], start[key], err_msg=key)


def test_a_swapped_stickman_reads_above_the_bound(meta_runs, tmp_path,
                                                 monkeypatch):
    """The planted fault: the discriminator's input with the stickman and
    image channels swapped (a plain concatenation in the wrong order reads
    the same way) moves the step far above the first-step bounds."""
    meta = meta_runs("FSTH")

    def swapped(batch, rgbs):
        x = make_input(batch, rgbs)
        return torch.cat([x[..., 1::2], x[..., 0::2]], dim=-1)

    make_input = tdis_mod.Discriminator.make_input
    monkeypatch.setattr(tdis_mod.Discriminator, "make_input",
                        staticmethod(swapped))
    got, _, _ = _run_port(meta["path"], tmp_path, meta["batch"],
                          meta["jcriteria"])
    ratios = _ratios(got, meta["want"], _jax_flat(meta["jstate"]),
                     meta["args"])
    assert max(ratios["grads"].values()) > 100


def _assert_crosses(path, workdir, finetune):
    """The JAX checkpoint read by the port and written back is the JAX
    checkpoint, array for array; returns the port's state."""
    state = tcli.load_checkpoint(_port_args(path, workdir, finetune), CPU)
    written = convert.export_train_state(state)
    saved = _flatten(jckpt.load_arrays(path))
    assert set(written) == set(saved)
    for key, value in saved.items():
        np.testing.assert_array_equal(written[key], value, err_msg=key)
    return state


@pytest.mark.parametrize("generator", sorted(GENERATORS))
def test_meta_state_crosses_from_jax_array_for_array(meta_runs, generator,
                                                     tmp_path):
    state = _assert_crosses(meta_runs(generator)["path"], tmp_path, False)
    assert not state.finetune


def test_fine_tune_state_crosses_from_jax_array_for_array(finetuned,
                                                          tmp_path):
    """``finetune_affine``, its EMA and moments included."""
    state = _assert_crosses(finetuned["path"], tmp_path, True)
    assert state.finetune_affine is not None
    assert state.finetune_embedding is None
