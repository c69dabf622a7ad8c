"""PyTorch port, ROADMAP C.9: on some batches of the metatrain cut the port's
first f32 meta step sits 2-4e-3 of a leaf's L2 from the JAX step in f64 in
the identity tower's gradients.  The cause is f32 rounding at a kink, not
the port: an element of a ReLU's input (or of an L1 loss's difference) lies
within f32's error of 0, lands on the other side of 0 in f32, and its flipped
mask (or sign) moves that element's gradient, its BatchNorm channel's (on
the batch of 4, layer4_0's bn1 channel 232) and every gradient below it in
backward order.

``tests/test_torch_metatrain.py``'s cut and meta state, on the batches C.9
names: its second batch of 2 (``b1``), both batches of 2 as one batch of 4
(``b01``), and its first batch twice over (``b00``).  Every ``torch.relu``
of the step (the towers, the link and AdaIN through their plain versions,
the generator's projector, the discriminator, the VGG towers, the hinge
loss), MobileNetV2's ReLU6 and every L1 loss's ``abs`` is recorded in call
order.  On each batch:

- the port's step in f64 (both kernels plain) meets the first-step bounds
  against the JAX step in f64: the port's arithmetic is the reference's;
- every element whose side of 0 (or of 6) differs between the port's f32
  and f64 steps lies closer to it in f64 than the f32 forward's largest
  error on that tensor;
- the port's f32 step with every such mask and sign taken from its f64
  step meets the first-step bound on every gradient and second moment: the
  flips are the whole gap;
- the port's f32 step as it is: without a flip in the identity tower
  (``b00``) within that bound; with one, some gradient above it, and each
  identity-tower gradient upstream (in backward order) of the tower's last
  flip within it.
"""

import contextlib
import types

import numpy as np
import pytest
import jax
import torch

from latentpose_tpu.runners import build
from latentpose_tpu.runners import holycow as jholycow
from latentpose_tpu_torch import convert
from latentpose_tpu_torch.cli import train as tcli
from latentpose_tpu_torch.losses.common.perceptual_loss import \
    load_tower_arrays
from latentpose_tpu_torch.nn import backbones as tbackbones
from latentpose_tpu_torch.nn import blocks as tblocks
from latentpose_tpu_torch.ops import adain as adain_op
from latentpose_tpu_torch.ops import conv_bn
from latentpose_tpu_torch.runners import holycow as tholycow

import test_torch_metatrain as mt
import torch_parallel_rank as rank_worker
from test_torch_metatrain import _shallow_towers, meta  # noqa: F401

CPU = torch.device("cpu")
BATCHES = ("b1", "b01", "b00")
IDENTITY = "identity_encoder"


def _batches():
    b0 = {**mt._batch(0)[0], **mt._batch(0)[1]}
    b1 = {**mt._batch(1)[0], **mt._batch(1)[1]}
    return {"b1": b1,
            "b01": {k: np.concatenate([b0[k], b1[k]]) for k in b0},
            "b00": {k: np.concatenate([b0[k], b0[k]]) for k in b0}}


@contextlib.contextmanager
def _kinks(signs=None):
    """Inside, each ``torch.relu``, ``_relu6`` and ``Tensor.abs`` call is
    recorded as (kind, site, input), ``site`` the module path of the
    BatchNorm before a ReLU of ResNeXt-50 (None elsewhere); or, given
    ``signs`` from such a record ((x > 0, x >= 6) a call), computed from
    them: ``x * mask`` (+ ``6 * high`` for ReLU6), ``x * ±1``.  AdaIN and
    the link take their plain versions, whose ReLUs are ``torch.relu``.
    Yields the record."""
    record, at = [], {"sites": None, "i": 0}
    relu, relu6, absolute = torch.relu, tbackbones._relu6, torch.Tensor.abs
    resnext, bottleneck = (tbackbones.ResNeXt50.forward,
                           tbackbones.Bottleneck.forward)

    def tower(self, *args, **kwargs):
        at.update(names={id(m): n for n, m in self.named_modules()},
                  sites=["bn1"])
        try:
            return resnext(self, *args, **kwargs)
        finally:
            at["sites"] = None

    def block(self, *args, **kwargs):
        name = at["names"][id(self)]
        last = "downsample_bn" if self.has_downsample else "bn3"
        at["sites"] += [f"{name}.{bn}" for bn in ("bn1", "bn2", last)]
        return bottleneck(self, *args, **kwargs)

    def kink(kind, plain):
        def f(x, *args, **kwargs):
            sites = at["sites"]
            site = sites.pop(0) if kind == "relu" and sites else None
            if signs is None:
                record.append((kind, site, x.detach().clone()))
                return plain(x, *args, **kwargs)
            k, s, (pos, high) = signs[at["i"]]
            at["i"] += 1
            assert (k, s) == (kind, site)
            if kind == "abs":
                return x * torch.where(pos, 1.0, -1.0).to(x.dtype)
            y = x * (pos & ~high).to(x.dtype)
            return y + 6.0 * high.to(x.dtype) if kind == "relu6" else y
        return f

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "relu", kink("relu", relu))
        mp.setattr(tbackbones, "_relu6", kink("relu6", relu6))
        mp.setattr(torch.Tensor, "abs", kink("abs", absolute))
        mp.setattr(tbackbones.ResNeXt50, "forward", tower)
        mp.setattr(tbackbones.Bottleneck, "forward", block)
        mp.setattr(tbackbones, "bn_relu_conv1x1_stats",
                   conv_bn.bn_relu_conv1x1_stats_reference)
        mp.setattr(tblocks, "adain", adain_op.adain_reference)
        yield record


def _port_step(path, workdir, jcriteria, batch, mode, signs=None):
    """The port's first step from the meta checkpoint: ``mode`` 'f64'
    (``torch_parallel_rank.float64_step``) or 'f32', with ``signs`` (or
    recording them, :func:`_kinks`); returns (flat state, scalars,
    record, args)."""
    targs = mt._port_args(path, workdir)
    state = tcli.load_checkpoint(targs, CPU)
    criteria = tcli.build_criteria(targs, CPU)
    for crit, jcrit in zip(criteria, jcriteria):
        for attr in rank_worker.TOWERS:
            if hasattr(crit, attr):
                load_tower_arrays(getattr(crit, attr).module,
                                  mt._tower_arrays(jcrit))
    f64 = rank_worker.float64_step(targs, state, criteria) \
        if mode == "f64" else contextlib.nullcontext()
    with f64, mt._no_dropout(), _kinks(signs) as record:
        if mode == "f64":
            batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                     for k, v in batch.items()}
        scalars = tholycow.make_train_step(criteria, targs)(
            state, tholycow.to_device((batch, {}), CPU,
                                      tholycow.META_STEP_KEYS))
    flat = {k: np.array(v) for k, v in
            convert.export_train_state(state).items()}
    return flat, {k: float(v) for k, v in scalars.items()}, record, targs


@pytest.fixture(scope="module")
def steps(meta, tmp_path_factory):
    """On each batch: the JAX step in f64 (one jitted step a batch shape),
    and the port's in f64, in f32, and in f32 with the f64 signs."""
    jmeta, path = meta
    workdir = tmp_path_factory.mktemp("relu_margin")
    targs = mt._port_args(path, workdir)
    jargs = types.SimpleNamespace(**vars(targs))
    jargs.num_labels = 4
    jcriteria = mt._jax_criteria(jargs)
    batches = _batches()
    out = {}
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True), \
            mt._no_dropout():
        mp.setattr(jholycow, "jnp", mt._Float64Numpy())
        opt_g, opt_d = build.build_optimizers(jargs, mt.MODULES)
        jstep = jholycow.make_train_step(mt._jax_models(jargs), jcriteria,
                                         jargs, opt_g, opt_d)
        for name in BATCHES:
            state, scalars = jstep(
                mt._float64(jmeta), mt._float64(batches[name]),
                jax.random.fold_in(jax.random.PRNGKey(0), 0))
            out[name] = {"jax64": (mt._jax_flat(state),
                                   {k: float(v) for k, v in scalars.items()})}
    for name in BATCHES:
        runs = out[name]
        for mode in ("f64", "f32"):
            runs[mode] = _port_step(path, workdir, jcriteria, batches[name],
                                    mode)
        signs = [(kind, site, (x > 0, (x >= 6) & (kind == "relu6")))
                 for kind, site, x in runs["f64"][2]]
        runs["f32_signs"] = _port_step(path, workdir, jcriteria,
                                       batches[name], "f32", signs)
    embedder = tcli.load_checkpoint(targs, CPU).models["embedder"]
    layers = [n for n, m in getattr(embedder, IDENTITY).named_modules()
              if next(m.parameters(recurse=False), None) is not None]
    return dict(runs=out, start=mt._jax_flat(jmeta), layers=layers)


def _gradient_ratios(steps, name, mode):
    """Each gradient leaf's (Adam's mu, beta1 = 0) and second moment's
    error against the JAX step in f64 over its first-step bound, as
    ``tests/test_torch_metatrain.py`` reckons it."""
    got = steps["runs"][name][mode][0]
    want = steps["runs"][name]["jax64"][0]
    moments = [k for k in want if k.startswith("opt_state")
               and ("::mu::" in k or "::nu::" in k)]
    norms, out = {}, {}
    for key in moments:
        norms[mt._part(key)] = np.hypot(norms.get(mt._part(key), 0.0),
                                        mt._l2(want[key]))
    for key in moments:
        w = np.asarray(want[key], np.float64)
        out[key] = mt._l2(np.asarray(got[key], np.float64) - w) / (
            mt.FIRST_RTOL[1] * mt._l2(w)
            + mt.GRAD_FLOOR * norms[mt._part(key)])
    return out


def _flips(steps, name):
    """(call, kind, site, elements, largest distance to the bound crossed
    in f64 over the f32 forward's error on that tensor) of each call whose
    input has elements on another side of 0 (or of 6, for ReLU6) in f32
    than in f64, in call order."""
    r32, r64 = (steps["runs"][name][m][2] for m in ("f32", "f64"))
    assert [w[:2] for w in r32] == [w[:2] for w in r64]
    out = []
    for i, ((kind, site, x32), (_, _, x64)) in enumerate(zip(r32, r64)):
        low = (x32 > 0) != (x64 > 0)
        high = (x32 >= 6) != (x64 >= 6) if kind == "relu6" \
            else torch.zeros_like(low)
        flipped = low | high
        if flipped.any():
            error = (x32.double() - x64).abs().max()
            distance = torch.where(low, x64.abs(), (x64 - 6).abs())
            out.append((i, kind, site, int(flipped.sum()),
                        float(distance[flipped].max() / error)))
    return out


@pytest.mark.parametrize("name", BATCHES)
def test_port_in_float64_meets_the_first_step_bounds(steps, name):
    """The port's step in f64 against the JAX step in f64."""
    tflat, tscalars, _, targs = steps["runs"][name]["f64"]
    jflat, jscalars = steps["runs"][name]["jax64"]
    mt.test_first_meta_step_matches_jax_in_float64({
        "tfirst": tflat, "jfirst64": jflat, "tscalars": [tscalars],
        "jscalars64": jscalars, "start": steps["start"], "accum": 1,
        "targs": targs})


@pytest.mark.parametrize("name", BATCHES)
def test_float32_flips_lie_within_rounding_of_zero(steps, name):
    """Each element on another side of a kink in f32 than in f64 sits
    closer to it in f64 than the f32 forward's largest error on that
    tensor."""
    flips = _flips(steps, name)
    print(f"{name}: flipped elements (call, kind, site, elements, "
          f"distance / f32 error): {flips}")
    for *where, margin in flips:
        assert margin <= 1.0, where


@pytest.mark.parametrize("name", BATCHES)
def test_float32_step_with_the_float64_signs_meets_the_bounds(steps, name):
    """The port's f32 step with each kink's mask or sign taken from its f64
    step: every gradient and second moment within the first-step bound."""
    assert mt._worst(_gradient_ratios(steps, name, "f32_signs")) <= 1.0


@pytest.mark.parametrize("name", BATCHES)
def test_float32_gap_comes_with_a_flip(steps, name):
    """The port's f32 step as it is: without a flip in the identity tower,
    every gradient and second moment within the first-step bound (a flip
    elsewhere may move nothing beyond it: ``b00``'s two, outside the
    towers);
    with one, some above it, and every identity-tower leaf upstream (in
    backward order) of the tower's last flipped ReLU within it."""
    ratios = _gradient_ratios(steps, name, "f32")
    sites = [site for _, _, site, _, _ in _flips(steps, name)
             if site is not None]
    worst = mt._worst(ratios)
    if not sites:
        assert worst <= 1.0
        return
    assert worst > 1.0
    last = steps["layers"].index(sites[-1])
    upstream = {}
    for key, ratio in ratios.items():
        fields = key.split("::")
        if IDENTITY in fields:
            layer = ".".join(fields[fields.index(IDENTITY) + 1:-1])
            if steps["layers"].index(layer) > last:
                upstream[key] = ratio
    print(f"{name}: the identity tower's first flip in backward order at "
          f"{sites[-1]}")
    assert upstream and mt._worst(upstream) <= 1.0
