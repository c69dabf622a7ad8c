"""PyTorch port, bf16 training (``--compute_dtype bfloat16``) held against the
JAX package: the dtype map of a bf16 step module by module, and the bf16
numerics bounded by bf16's own effect.

bf16 rounds where the two packages' arithmetic differs (XLA and PyTorch sum,
fuse and round in other orders; the port's hand kernels compute AdaIN and
the conv_bn link in f32 and round once), so a bf16 result is held against
the JAX package's bf16 result by the size of bf16's own effect there: for a
quantity computed by the JAX package in f32 (J32) and in bf16 (J16) and by
the port in bf16 (T16), from the same inputs and weights,

    ‖T16 − J16‖ ≤ C · ‖J16 − J32‖,

over the losses (each relative to its J32 value) and over each gradient
group (generator, discriminator, embedder or the identity embedding) of one
meta step and one fine-tune step, and over the outputs and gradients of each
small op that holds a kernel (AdaIN, the conv_bn link, a train-mode
Bottleneck, BatchNorm).  C = 1.5; the ratios this module measured: the
steps 0.55-1.2 (the fine-tune losses highest), AdaIN 0.93-1.01, the link
0.21-0.23, the Bottleneck 0.054, BatchNorm 2e-5.  Planted faults read above
C in the same tests, so C is not vacuous: AdaIN's statistics accumulated in
bf16 (AdaIN alone 3.6-5.4; the meta step's generator gradient 2.4, its
weights' 2.9 and the fine-tune step's 2.0), and the
VGG differences accumulated in bf16 (the losses 2.5 in the meta step, 4.9
in the fine-tune step).  Where an
operation is exact in both packages it is held bit-equal: the casts of the
dtype map, and BatchNorm's running statistics in bf16 on inputs whose sums
are exact in f32 (its output is within one bf16 step: the two packages'
f32 ``rsqrt`` differ in the last bit of 36 % of values).

J16 runs on the CPU, where XLA sums a bf16 ``reduce_sum`` in bf16: the
gradients of the biases that flax adds in bf16 (convs, dense layers) and of
AdaIN's weight and bias, which the JAX package applies in bf16
(``ops/norms.py:55-57``), are sums over the batch and the pixels that stall
in bf16.  The port follows the TPU kernel (AdaIN's affine in f32) and its
backward accumulates these sums in f32 (ROADMAP.md C.5).  So J16's
generator and discriminator gradients sit 10-49 % from J32 and the port's
0.3-6.5 %, and there the ratio reads 0.95-1.0: the bound holds T16 near
J32.  Without its biases the discriminator's gradient reads 0.39 (meta)
and 0.69 (fine-tune), which the bound also holds; the generator's weights
take AdaIN's sums through the projector and read 0.95.  So the generator's
and the discriminator's gradients are also held against J32, by bf16's
effect where J16 takes no bf16 sum (the leaves that are neither a bias nor
the projector's):

    ‖T16 − J32‖ / ‖J32‖ ≤ C · ‖J16 − J32‖_S / ‖J32‖_S

over the whole group, its biases included, S its sound leaves.  Measured:
the generator 1.36 (meta) and 1.16 (fine-tune), the discriminator 1.09 and
1.00.  A fault of bf16's size fails it: AdaIN's statistics in bf16 read
18.6 and 12.7 on the generator, and the discriminator's bias gradients
summed in one bf16 accumulator 36.8 and 46 on the discriminator.  That
fault brings the port's discriminator gradient to J16 (‖T16 − J16‖ falls
to 0.22 and 0.11 of ‖J16 − J32‖), which is how XLA on the CPU sums it.

The steps run where ``tests/test_torch_metatrain.py`` runs its f32 steps and
with its conditioning fixes: 64² frames with seeded noise, K=2, one block a
stage in both towers, the generator's constant drawn from a normal, dropout
as the identity and augmentation off; the meta state is that module's
``meta`` fixture, and the fine-tune state is its fine-tuned re-
parameterisation with a seeded ê.
"""

import contextlib
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch
import torch.nn.functional as F

from latentpose_tpu import checkpoint as jckpt
from latentpose_tpu.checkpoint import _flatten
from latentpose_tpu.models.discriminators import no_landmarks as jdis_mod
from latentpose_tpu.nn import backbones as jbackbones
from latentpose_tpu.ops import norms as jnorms
from latentpose_tpu.runners import build
from latentpose_tpu.runners import finetune as jft
from latentpose_tpu.runners import holycow as jholycow
from latentpose_tpu_torch import convert
from latentpose_tpu_torch.cli import train as tcli
from latentpose_tpu_torch.losses.common import perceptual_loss
from latentpose_tpu_torch.models.discriminators import no_landmarks as tdis
from latentpose_tpu_torch.nn import backbones as tbackbones
from latentpose_tpu_torch.ops import adain as tadain
from latentpose_tpu_torch.ops import conv_bn as tconv_bn
from latentpose_tpu_torch.ops import norms as tnorms
from latentpose_tpu_torch.ops import spectral_norm as tsn
from latentpose_tpu_torch.runners import holycow as tholycow

import test_torch_metatrain as mt
from test_torch_metatrain import _shallow_towers, meta  # noqa: F401

torch.set_num_threads(1)

CPU = torch.device("cpu")
BF16 = ["--compute_dtype", "bfloat16"]
# ‖T16 − J16‖ ≤ C · ‖J16 − J32‖ (module docstring): the largest ratio
# measured here is 1.2, the planted faults read 2.4-5.4
C = 1.5


def _l2(arrays):
    return float(np.sqrt(sum(np.sum(np.square(np.asarray(a, np.float64)))
                             for a in arrays)))


def _ratio(t16, j16, j32):
    """‖T16 − J16‖ / ‖J16 − J32‖ over lists of arrays; over dicts of losses,
    each loss relative to its J32 value (the losses' scales differ by
    orders of magnitude)."""
    if isinstance(j32, dict):
        assert set(t16) == set(j16) == set(j32)
        keys = sorted(j32)
        scale = [abs(j32[k]) for k in keys]
        t16, j16, j32 = ([d[k] / s for k, s in zip(keys, scale)]
                         for d in (t16, j16, j32))
    num = _l2([np.asarray(t, np.float64) - np.asarray(j, np.float64)
               for t, j in zip(t16, j16)])
    den = _l2([np.asarray(j, np.float64) - np.asarray(r, np.float64)
               for j, r in zip(j16, j32)])
    assert den > 0
    return num / den


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _bf16(a):
    """An f32 array rounded to bf16 values, kept in f32 (the inputs that
    the f32 and bf16 runs share)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _bf16_moments(x32):
    """AdaIN's statistics in bf16 arithmetic, the planted fault: Σx and Σx²
    accumulated pixel by pixel in bf16 (as a kernel that kept its running
    sums in the input's dtype would), the mean, E[x²] and the variance in
    bf16."""
    x = x32.to(torch.bfloat16).flatten(1, 2)          # (B, HW, C)
    total = torch.zeros_like(x[:, 0])
    squares = torch.zeros_like(x[:, 0])
    for i in range(x.shape[1]):
        total = total + x[:, i]
        squares = squares + x[:, i] * x[:, i]
    mean = (total / x.shape[1])[:, None, None]
    meansq = (squares / x.shape[1])[:, None, None]
    return mean.float(), torch.clamp(meansq - mean * mean, min=0.0).float()


@contextlib.contextmanager
def planted_fault():
    """The port's AdaIN (its plain forward and backward, which the card's
    kernel is held to) with its statistics (mean, E[x²] and their
    difference) taken in bf16."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnorms, "moments", _bf16_moments)
        yield


def _bf16_vgg_call(self, input, target):
    """PerceptualLoss with its feature differences accumulated in bf16, the
    second planted fault: |f(x) − f(y)| summed by 1024 bf16 accumulators,
    one element of each after another (a reduction that kept its partial
    sums in the features' dtype), then their sum over the map's size."""
    x = (input + 1.0) / 2.0
    y = (target.detach() + 1.0) / 2.0
    feats_x = self.module(self._normalize(x).to(self.dtype))
    feats_y = self.module(self._normalize(y).to(self.dtype))
    loss = 0.0
    for fx, fy in zip(feats_x, feats_y):
        diff = (fx - fy).abs().flatten()
        rows = F.pad(diff, (0, -diff.numel() % 1024)).view(-1, 1024)
        lanes = torch.zeros_like(rows[0])
        for row in rows:
            lanes = lanes + row
        loss = loss + lanes.float().sum() / diff.numel()
    return loss * self.weight


@contextlib.contextmanager
def vgg_fault():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(perceptual_loss.PerceptualLoss, "__call__",
                   _bf16_vgg_call)
        yield


class _BF16BiasSum(torch.autograd.Function):
    """``y + bias`` whose bias gradient is summed over the batch and the
    pixels in one bf16 accumulator a channel, row after row (as XLA on the
    CPU sums a bf16 ``reduce_sum``): the discriminator's planted fault."""

    @staticmethod
    def forward(ctx, y, bias):
        ctx.nchw = y.dim() == 4
        return y + (bias[:, None, None] if ctx.nchw else bias)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            return g, None
        rows = (g.movedim(1, -1) if ctx.nchw else g).reshape(-1, g.shape[1])
        total = torch.zeros_like(rows[0])
        for row in rows:
            total = total + row
        return g, total


def _conv2d_bias_fault(x, w, bias=None, **kw):
    y = F.conv2d(x, w, None, **kw)
    return y if bias is None else _BF16BiasSum.apply(y, bias)


def _linear_bias_fault(x, w, bias=None):
    y = F.linear(x, w)
    return y if bias is None else _BF16BiasSum.apply(y, bias)


@contextlib.contextmanager
def dis_bias_fault():
    """The discriminator's passes with :class:`_BF16BiasSum` biases."""
    faulty = types.SimpleNamespace(conv2d=_conv2d_bias_fault,
                                   linear=_linear_bias_fault)
    pass_inputs = tdis.Discriminator.pass_inputs

    def patched(self, *a, **k):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tsn, "F", faulty)
            return pass_inputs(self, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdis.Discriminator, "pass_inputs", patched)
        yield


# --- ops that hold a kernel ---------------------------------------------------

def _adain_case(shape, seed):
    rng = np.random.RandomState(seed)
    b, _, _, c = shape
    x = _bf16(rng.standard_normal(shape) * 2 + rng.standard_normal(c))
    w, bias = (_bf16(rng.standard_normal((b, c))) for _ in range(2))
    g = _bf16(rng.standard_normal(shape))
    return x, w, bias, g


def _jax_adain(x, w, b, g, dtype):
    def f(x, w, b):
        return jnp.maximum(jnorms.adain(x, w, b), 0.0)
    args = [jnp.asarray(a, dtype) for a in (x, w, b)]
    y, vjp = jax.vjp(f, *args)
    return [y, *vjp(jnp.asarray(g, dtype))]


def _port_adain(x, w, b, g):
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
              for a in (x, w, b)]
    y = tadain.adain(*leaves)
    grads = torch.autograd.grad(y, leaves,
                                torch.from_numpy(g).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert [t.dtype for t in grads] == [torch.bfloat16] * 3
    return [_np(t) for t in (y, *grads)]


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (3, 16, 16, 8)])
def test_adain_bf16_forward_and_backward(shape):
    """The port's AdaIN + ReLU in bf16 (the kernel's function: f32
    statistics and affine, one rounding) and its plain backward (f32
    arithmetic, bf16 dx, dweight, dbias) against the JAX package's
    ``norms.adain`` in bf16 and f32; the planted fault reads above C."""
    case = _adain_case(shape, sum(shape))
    j32 = [_np(t) for t in _jax_adain(*case, jnp.float32)]
    j16 = [_np(t) for t in _jax_adain(*case, jnp.bfloat16)]
    ratio = _ratio(_port_adain(*case), j16, j32)
    with planted_fault():
        fault = _ratio(_port_adain(*case), j16, j32)
    print(f"adain {shape}: ratio {ratio:.3g}, planted fault {fault:.3g}")
    assert ratio <= C < fault


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (3, 16, 16, 8)])
def test_adain_bf16_operator_forward_and_plain_backward(shape):
    """In bf16 the wrapper's forward is the ``latentpose::adain_fused``
    operator (the plain version on the CPU) and its gradients are
    ``adain_backward``'s, bit for bit."""
    x, w, b, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _adain_case(shape, sum(shape) + 1))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y = tadain.adain(*leaves)
    torch.testing.assert_close(
        y.detach(), torch.ops.latentpose.adain_fused(x, w, b, True, 1e-4),
        rtol=0, atol=0)
    got = torch.autograd.grad(y, leaves, g)
    want = tadain.adain_backward(x, w, b, g, True, 1e-4)
    for t, ref in zip(got, want):
        assert t.dtype == torch.bfloat16
        torch.testing.assert_close(t, ref, rtol=0, atol=0)


def _link_case(m, cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = _bf16(rng.standard_normal((m, cin)) + 0.3)
    scale = (rng.rand(cin) + 0.5).astype(np.float32)
    offset = (rng.standard_normal(cin) * 0.2).astype(np.float32)
    w = _bf16(rng.standard_normal((cin, cout)) / np.sqrt(cin))
    gy = _bf16(rng.standard_normal((m, cout)))
    gs = (rng.standard_normal((2, cout)) / m).astype(np.float32)
    return x, scale, offset, w, gy, gs


def _jax_link(x, scale, offset, w, gy, gs, dtype):
    """The TPU kernel's function (``conv_bn_fused.py:_kernel``) in XLA, with
    its gradient: the BN apply and ReLU in f32, rounded to W's dtype before
    the product, the product and the statistics in f32, y in x's dtype."""
    def f(x, scale, offset, w):
        h = jnp.maximum(x.astype(jnp.float32) * scale + offset, 0.0)
        y = jnp.dot(h.astype(w.dtype), w,
                    preferred_element_type=jnp.float32)
        return y.astype(x.dtype), jnp.stack([y.sum(0), (y * y).sum(0)])
    args = (jnp.asarray(x, dtype), jnp.asarray(scale), jnp.asarray(offset),
            jnp.asarray(w, dtype))
    (y, stats), vjp = jax.vjp(f, *args)
    return [y, stats, *vjp((jnp.asarray(gy, dtype), jnp.asarray(gs)))]


@pytest.mark.parametrize("m,cin,cout", [(256, 32, 64), (96, 64, 16)])
def test_conv_bn_link_bf16_forward_and_backward(m, cin, cout):
    """The link in bf16 under autograd (on the CPU its plain version, which
    the card's kernel is held to in ``chip_smoke.py``): y bf16, the
    statistics f32 from the f32 accumulator, dx bf16, dscale and doffset
    f32, dW bf16, against the TPU kernel's function in bf16 and f32."""
    x, scale, offset, w, gy, gs = _link_case(m, cin, cout, m + cin)
    j32 = [_np(t) for t in _jax_link(x, scale, offset, w, gy, gs,
                                     jnp.float32)]
    j16 = [_np(t) for t in _jax_link(x, scale, offset, w, gy, gs,
                                     jnp.bfloat16)]
    leaves = [torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(scale),
              torch.from_numpy(offset), torch.from_numpy(w).to(torch.bfloat16)]
    leaves = [t.requires_grad_() for t in leaves]
    y, stats = tconv_bn.bn_relu_conv1x1_stats(*leaves)
    grads = torch.autograd.grad(
        (y, stats), leaves, (torch.from_numpy(gy).to(torch.bfloat16),
                             torch.from_numpy(gs)))
    assert (y.dtype, stats.dtype) == (torch.bfloat16, torch.float32)
    assert [t.dtype for t in grads] == [torch.bfloat16, torch.float32,
                                        torch.float32, torch.bfloat16]
    t16 = [_np(t) for t in (y, stats, *grads)]
    np.testing.assert_array_equal(t16[0], j16[0])      # y: one rounding
    ratio = _ratio(t16, j16, j32)
    print(f"conv_bn link M={m} {cin}->{cout}: ratio {ratio:.3g}")
    assert ratio <= C


def _bottleneck(dtype):
    return jbackbones.Bottleneck(planes=16, stride=2, has_downsample=True,
                                 dtype=dtype)


def _jax_train_form(module, variables, x, cot, dtype):
    def f(params, x):
        out, mut = module.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                x, train=True, mutable=["batch_stats"])
        return out, mut["batch_stats"]
    (out, stats), vjp = jax.vjp(f, variables["params"],
                                jnp.asarray(x, dtype))
    dparams, dx = vjp((jnp.asarray(cot, dtype),
                       jax.tree_util.tree_map(jnp.zeros_like, stats)))
    return out, dx, _flatten({"params": dparams}), _flatten(
        {"batch_stats": stats})


def test_train_form_bottleneck_in_bf16():
    """One train-mode Bottleneck (the link inside, bn3 from its statistics)
    in bf16: output, input and parameter gradients, and the running
    statistics, against the JAX module (flax BatchNorm, dtype bf16) in bf16
    and f32; every parameter gradient f32."""
    rng = np.random.RandomState(60)
    x = _bf16(rng.rand(4, 16, 16, 32))
    cot = _bf16(rng.standard_normal((4, 8, 8, 64)))
    variables = jax.jit(_bottleneck(None).init)(jax.random.PRNGKey(61),
                                                jnp.asarray(x))
    jitter = np.random.RandomState(62)
    variables = {"params": jax.tree_util.tree_map(
        lambda v: np.asarray(v) + jitter.uniform(-0.05, 0.05, v.shape)
        .astype(np.float32), variables["params"]),
        "batch_stats": variables["batch_stats"]}
    runs = {}
    for name, dtype in (("j32", jnp.float32), ("j16", jnp.bfloat16)):
        out, dx, dparams, stats = _jax_train_form(
            _bottleneck(None if dtype == jnp.float32 else dtype), variables,
            x, cot, dtype)
        runs[name] = [_np(out), _np(dx)], dparams, stats
    tnet = tbackbones.Bottleneck(32, 16, stride=2, has_downsample=True)
    convert.load_into(tnet, _flatten(variables), "")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last).requires_grad_()
    out = tnet(xt, train=True)
    assert out.dtype == torch.bfloat16
    params = dict(tnet.named_parameters())
    grads = torch.autograd.grad(
        out, [xt, *params.values()],
        torch.from_numpy(cot).to(torch.bfloat16).permute(0, 3, 1, 2))
    assert grads[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in grads[1:])
    tgrads = dict(zip(params, grads[1:]))
    rules = [r for r in convert._rules(tnet) if r[1] == "params"]
    keys, t16 = [], [_np(out.permute(0, 2, 3, 1)),
                     _np(grads[0].permute(0, 2, 3, 1))]
    for tkey, _, leaf, (_, to_jax) in rules:
        g = tgrads[tkey].numpy()
        t16.append(g.transpose(to_jax) if to_jax is not None else g)
        keys.append(f"params::{leaf}")
    tstats = convert.export(tnet, "", params=())
    skeys = sorted(runs["j16"][2])
    assert set(tstats) == set(skeys)

    def flat(run):
        acts, dparams, stats = run
        return acts + [dparams[k] for k in keys] + [stats[k] for k in skeys]

    ratio = _ratio(t16 + [tstats[k] for k in skeys], flat(runs["j16"]),
                   flat(runs["j32"]))
    print(f"train-form Bottleneck: ratio {ratio:.3g}")
    assert ratio <= C


def test_batchnorm_train_form_in_bf16_is_flaxs():
    """flax's ``BatchNorm(dtype=bfloat16)`` in train form against the
    port's: the running statistics bit-equal (f32 from the upcast input;
    the inputs are multiples of 1/32 over 32 rows a channel, so every sum
    is exact in f32 in both packages), the output within one bf16 step of
    flax's (the f32 ``rsqrt`` differs in its last bit between XLA and
    PyTorch) and equal in nearly every element; the gradients within C."""
    rng = np.random.RandomState(70)
    x = (rng.randint(-64, 64, (2, 4, 4, 24)) / 32.0).astype(np.float32)
    cot = _bf16(rng.standard_normal(x.shape))
    scale = (1 + 0.2 * rng.standard_normal(24)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(24)).astype(np.float32)
    stats = {"mean": (0.1 * rng.standard_normal(24)).astype(np.float32),
             "var": (1 + 0.1 * rng.rand(24)).astype(np.float32)}
    runs = {}
    for name, dtype in (("j32", None), ("j16", jnp.bfloat16)):
        bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5, dtype=dtype)

        def f(params, x):
            return bn.apply({"params": params, "batch_stats": stats}, x,
                            mutable=["batch_stats"])
        (out, mut), vjp = jax.vjp(
            f, {"scale": scale, "bias": bias},
            jnp.asarray(x, dtype or jnp.float32))
        cot_stats = jax.tree_util.tree_map(jnp.zeros_like, mut)
        dparams, dx = vjp((jnp.asarray(cot, out.dtype), cot_stats))
        runs[name] = (out, dx, dparams, mut["batch_stats"])
    tbn = tbackbones.BatchNorm(24, eps=1e-5)
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
        tbn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        tbn.running_var.copy_(torch.from_numpy(stats["var"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16) \
        .requires_grad_()
    out = tbn(xt, train=True)
    assert out.dtype == torch.bfloat16
    dx, dscale, dbias = torch.autograd.grad(
        out, (xt, tbn.weight, tbn.bias),
        torch.from_numpy(cot).to(torch.bfloat16).permute(0, 3, 1, 2))
    jout, jdx, jdparams, jstats = runs["j16"]
    assert jout.dtype == jnp.bfloat16
    for got, key in ((tbn.running_mean, "mean"), (tbn.running_var, "var")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jstats[key]))
    got = _np(out.permute(0, 2, 3, 1))
    want = _np(jout)
    step = np.abs(want) * 2.0 ** -7 + 1e-30      # one bf16 step of |want|
    assert np.all(np.abs(got - want) <= step)
    same = float(np.mean(got == want))
    print(f"BatchNorm bf16: {same:.4%} of the outputs bit-equal to flax's")
    assert same >= 0.99
    t16 = [got, _np(dx.permute(0, 2, 3, 1)), _np(dscale), _np(dbias)]

    def flat(run):
        out, dx, dparams, _ = run
        return [_np(out), _np(dx), _np(dparams["scale"]),
                _np(dparams["bias"])]

    ratio = _ratio(t16, flat(runs["j16"]), flat(runs["j32"]))
    print(f"BatchNorm bf16: ratio {ratio:.3g}")
    assert ratio <= C


# --- the dtype map -------------------------------------------------------------

class _Capture:
    """A flax module whose ``apply`` records the dtypes of every submodule's
    ``__call__`` output (``capture_intermediates``), one dict a call."""

    def __init__(self, module, record):
        self._module, self._record = module, record

    def __getattr__(self, name):
        return getattr(self._module, name)

    def apply(self, variables, *args, mutable=False, **kwargs):
        wanted = [] if mutable is False else list(mutable)
        out, state = self._module.apply(
            variables, *args, mutable=wanted + ["intermediates"],
            capture_intermediates=True, **kwargs)
        inter = state.pop("intermediates") if "intermediates" in state \
            else {}
        self._record.append(_dtypes(inter))
        return out if mutable is False else (out, state)


def _dtypes(tree, prefix=""):
    """{module path: (output dtypes)} of a captured intermediates tree."""
    out = {}
    for key, value in dict(tree).items():
        if key == "__call__":
            leaves = jax.tree_util.tree_leaves(value)
            out[prefix] = tuple(str(jnp.dtype(v.dtype)) for v in leaves)
        else:
            out.update(_dtypes(value, f"{prefix}.{key}" if prefix else key))
    return out


def _torch_dtypes(output):
    if isinstance(output, torch.Tensor):
        return (str(output.dtype).replace("torch.", ""),)
    if isinstance(output, (list, tuple)):
        return tuple(d for o in output for d in _torch_dtypes(o))
    return ()


def _hooks(models, record):
    handles = []
    for part, model in models.items():
        for name, module in model.named_modules():
            def hook(mod, inputs, output, key=(part, name)):
                record.setdefault(key, []).append(_torch_dtypes(output))
            handles.append(module.register_forward_hook(hook))
    return handles


def _port_args(path, workdir, *flags):
    return tcli.resolve_args([
        "--checkpoint_path", str(path), "--dataloader", "synthetic",
        "--device", "cpu", "--allow_random_vgg", "--num_epochs", "1",
        "--experiments_dir", str(workdir), "--no-use_pixelwise_augs",
        "--no-use_affine_scale", "--no-use_affine_shift", *flags])


def _jax_args(targs, compute_dtype, num_labels):
    jargs = types.SimpleNamespace(**vars(targs))
    jargs.compute_dtype, jargs.num_labels = compute_dtype, num_labels
    return jargs


def test_dtype_map_is_the_jax_packages(meta, tmp_path):
    """One bf16 meta forward and its criteria in both packages: every
    module output's dtype in the embedder's two towers, the generator, the
    discriminator's embedding lookup and three passes, and the two VGG
    towers (each module the two packages share, by name), and the step's
    data_dict; then the port's bf16 step: every gradient and parameter
    f32, as the JAX bf16 step's gradients (Adam's first moment)."""
    jmeta, path = meta
    targs = _port_args(path, tmp_path, *BF16)
    jargs = _jax_args(targs, "bfloat16", 4)
    data, target = mt._batch(0)
    batch = {**data, **target}

    # the JAX package's forward and criteria, traced (eval_shape)
    jrecord = {}
    models = {k: _Capture(m, jrecord.setdefault(k, []))
              for k, m in mt._jax_models(jargs).items()}
    jcriteria = mt._jax_criteria(jargs)
    towers = {}
    for crit in jcriteria:
        for attr in ("perceptual_crit", "idt_embed_crit"):
            if hasattr(crit, attr):
                loss = getattr(crit, attr)
                loss.module = _Capture(loss.module,
                                       towers.setdefault(attr, []))

    def jforward(params, bstats, spectral, batch):
        dd, _, _ = jholycow.forward(
            models, params, bstats, spectral, batch,
            rng=jax.random.PRNGKey(0), train=True,
            compute_dtype=jnp.bfloat16)
        jholycow.apply_criteria(jcriteria, dd)
        return {k: v for k, v in dd.items()
                if k in ("embeds", "embeds_elemwise", "pose_embedding",
                         "fake_rgbs", "fake_segm", "real_embedding",
                         "fake_score_G", "fake_score_D", "real_score",
                         "fake_features", "real_features")}

    with mt._no_dropout():
        jdd = jax.eval_shape(jforward, jmeta.params, jmeta.batch_stats,
                             jmeta.spectral, batch)

    # the port's
    tstate = tcli.load_checkpoint(targs, CPU)
    criteria = tcli.build_criteria(targs, CPU)
    trecord = {}
    handles = _hooks(tstate.models, trecord)
    for crit in criteria:
        for attr in ("perceptual_crit", "idt_embed_crit"):
            if hasattr(crit, attr):
                handles += _hooks({attr: getattr(crit, attr).module},
                                  trecord)
    try:
        with mt._no_dropout():
            tbatch = tholycow.dequantize(tholycow.to_device(
                (data, target), CPU, tholycow.META_STEP_KEYS))
            tdd = tholycow.forward(tstate, tbatch, True, None, torch.bfloat16)
            tholycow.apply_criteria(criteria, tdd)
    finally:
        for h in handles:
            h.remove()

    def port_calls(part):
        return {name: calls for (p, name), calls in trecord.items()
                if p == part}

    compared = {}
    for part in ("embedder", "generator", "discriminator"):
        want = {}
        for call in jrecord[part]:
            for name, dtypes in call.items():
                want.setdefault(name, []).append(dtypes)
        got = port_calls(part)
        shared = sorted(set(want) & set(got) - {""})
        for name in shared:
            assert got[name] == want[name], (part, name)
        compared[part] = len(shared)
    for attr, calls in towers.items():
        got = port_calls(attr)[""]
        want = [c[""] for c in calls]
        assert got == want and set(want[0]) == {"bfloat16"}, attr
        assert len(want) == 2 and len(want[0]) == 13
        compared[attr] = 2
    print(f"dtype map: modules compared {compared}")
    assert compared["embedder"] >= 40 and compared["generator"] >= 8 \
        and compared["discriminator"] >= 8
    # the towers output bf16; the discriminator's passes see bf16 inputs
    assert port_calls("embedder")["identity_encoder"] == [("bfloat16",)]
    assert port_calls("discriminator")["stem_conv0"] == [("bfloat16",)] * 3

    # the step's data_dict
    for key, want in jdd.items():
        got = tdd[key]
        want_dtypes = [str(jnp.dtype(a.dtype))
                       for a in jax.tree_util.tree_leaves(want)]
        assert list(_torch_dtypes(got)) == want_dtypes, key
    assert tdd["fake_rgbs"].dtype == tdd["real_score"].dtype == torch.float32
    assert tdd["pose_embedding"].dtype == torch.bfloat16

    # gradients and parameters: f32
    seen = []
    step = tholycow.make_train_step(criteria, targs)
    for opt in (tstate.opt_g, tstate.opt_d):
        real = opt.step
        opt.step = lambda grads, real=real: seen.append(
            {g.dtype for g in grads}) or real(grads)
    with mt._no_dropout():
        step(tstate, tholycow.to_device((data, target), CPU,
                                        tholycow.META_STEP_KEYS))
    assert seen == [{torch.float32}, {torch.float32}]
    for model in tstate.models.values():
        assert {p.dtype for p in model.parameters()} == {torch.float32}
        assert {b.dtype for b in model.buffers()} <= {torch.float32,
                                                      torch.int64}


def test_identity_embedding_in_bf16(meta, tmp_path):
    """ê through the bf16 identity tower (eval form), stored as an f32 leaf
    by the fine-tune runner, against the JAX package's ê in bf16 and f32
    over the same frames (two batches of the fine-tune loader).  The JAX
    package averages the bf16 rows in numpy's bf16; the port averages them
    in f32 (ROADMAP.md C.5)."""
    jmeta, path = meta
    targs = _port_args(path, tmp_path, "--finetune", "--config_name",
                       "finetuning-base", "--batch_size", "2", *BF16)
    loader = [b for b in mt.JaxLoader(image_size=mt.IMG, batch_size=2,
                                      num_labels=4, num_enc_frames=mt.K,
                                      finetune=True, seed=0)][:2]
    want = {}
    for name, dtype in (("J32", "float32"), ("J16", "bfloat16")):
        jargs = _jax_args(targs, dtype, 4)
        want[name] = np.asarray(jft.compute_averaged_identity_embedding(
            mt._jax_models(jargs), jmeta, loader, jargs), np.float32)
    tstate = tcli.load_checkpoint(targs, CPU)
    tstate = tcli.start_finetuning(targs, tstate, loader, CPU)
    got = tstate.finetune_embedding
    assert got.dtype == torch.float32 and got.shape == want["J16"].shape
    assert tstate.ema_params["finetune_embedding"].dtype == torch.float32
    ratio = _ratio([_np(got)], [want["J16"]], [want["J32"]])
    print(f"ê in bf16: ratio {ratio:.3g}")
    assert ratio <= C


# --- whole steps ---------------------------------------------------------------

def _groups(flat, scalars):
    """{'losses': {name: value}, 'generator': [...], 'generator weights':
    [...], 'generator sound': [...], ...}: the losses, each gradient group's
    leaves (Adam's or RAdam's first moment with beta1 = 0 is the step's
    gradient), by module, each group's leaves other than biases, and of
    those the ones outside the generator's projector (the module docstring
    says why)."""
    out = {"losses": scalars}
    for key in sorted(flat):
        fields = key.split("::")
        if fields[0].startswith("opt_state") and fields[2] == "mu":
            leaf = np.asarray(flat[key])
            out.setdefault(fields[3], []).append(leaf)
            if fields[-1] != "bias":
                out.setdefault(fields[3] + " weights", []).append(leaf)
                if not any(f.startswith("projector") for f in fields[4:]):
                    out.setdefault(fields[3] + " sound", []).append(leaf)
    return out


def _jax_step(jargs, jmodels, jstate, batch, seed=0):
    opt_g, opt_d = build.build_optimizers(jargs, mt.MODULES)
    jcriteria = mt._jax_criteria(jargs)
    jstep = jholycow.make_train_step(jmodels, jcriteria, jargs, opt_g, opt_d)
    state, scalars = jstep(jstate, batch, jax.random.PRNGKey(seed))
    return jcriteria, _groups(mt._jax_flat(state),
                              {k: float(v) for k, v in scalars.items()})


def _port_step(targs, jcriteria, batch, keys):
    tstate = tcli.load_checkpoint(targs, CPU)
    step = mt._port_step(targs, jcriteria)
    scalars = step(tstate, tholycow.to_device(batch, CPU, keys))
    flat = {k: np.array(v) for k, v in
            convert.export_train_state(tstate).items()}
    return _groups(flat, {k: float(v) for k, v in scalars.items()})


def _finetune_checkpoint(jmeta, targs, workdir):
    """The meta state re-parameterised for fine-tuning (a seeded ê) by the
    JAX package's ``enable_finetuning``, written by its writer."""
    jargs = _jax_args(targs, "float32", 4)
    opt_g, opt_d = build.build_optimizers(jargs, mt.MODULES)
    ehat = np.random.RandomState(80).standard_normal(
        (1, jargs.embed_channels)).astype(np.float32) * 0.1
    _, state = jft.enable_finetuning(
        jmeta, mt._jax_models(jargs), jdis_mod.Wrapper, jargs,
        jnp.asarray(ehat), opt_g, opt_d, jax.random.PRNGKey(81),
        gen_wrapper=mt.jgen_mod.Wrapper)
    jargs.num_labels = 1
    return state, jckpt.save_checkpoint(workdir, state, jargs)


def _jax_finetune_models(jargs):
    models = mt._jax_models(jargs)
    models["discriminator"] = jft.make_finetune_discriminator(
        jdis_mod.Wrapper, jargs)
    return models


def _port_runs(targs, jcriteria, batch, keys):
    """The port's step in bf16 (T16), and with each planted fault."""
    runs = {"T16": _port_step(targs, jcriteria, batch, keys)}
    for name, fault in (("adain fault", planted_fault),
                        ("vgg fault", vgg_fault),
                        ("dis fault", dis_bias_fault)):
        with fault():
            runs[name] = _port_step(targs, jcriteria, batch, keys)
    return runs


@pytest.fixture(scope="module")
def steps(meta, tmp_path_factory):
    """One meta step and one fine-tune step from one state and batch: the
    JAX step in f32 and in bf16, the port's in bf16, and the port's in bf16
    with each planted fault; each as :func:`_groups`."""
    jmeta, path = meta
    workdir = tmp_path_factory.mktemp("bf16_steps")
    data, target = mt._batch(0)
    batch = {**data, **target}
    out = {}
    with mt._no_dropout():
        targs = _port_args(path, workdir, *BF16)
        runs = {}
        for name, dtype in (("J32", "float32"), ("J16", "bfloat16")):
            jargs = _jax_args(targs, dtype, 4)
            jcriteria, runs[name] = _jax_step(jargs, mt._jax_models(jargs),
                                              jmeta, batch)
        runs.update(_port_runs(targs, jcriteria, (data, target),
                               tholycow.META_STEP_KEYS))
        out["meta"] = runs

        jft_state, ft_path = _finetune_checkpoint(
            jmeta, targs, workdir / "jax_ft")
        targs = _port_args(ft_path, workdir, "--finetune", "--config_name",
                           "finetuning-base", *BF16)
        target = {**target, "label": np.zeros_like(target["label"])}
        batch = {**data, **target}       # one avatar: the row of label 0
        runs = {}
        for name, dtype in (("J32", "float32"), ("J16", "bfloat16")):
            jargs = _jax_args(targs, dtype, 1)
            jcriteria, runs[name] = _jax_step(
                jargs, _jax_finetune_models(jargs), jft_state, batch)
        runs.update(_port_runs(targs, jcriteria, (data, target),
                               tholycow.STEP_KEYS))
        out["finetune"] = runs
    return out


@pytest.mark.parametrize("regime,group", [
    ("meta", "losses"), ("meta", "generator"), ("meta", "discriminator"),
    ("meta", "discriminator weights"), ("meta", "embedder"),
    ("finetune", "losses"), ("finetune", "generator"),
    ("finetune", "discriminator"), ("finetune", "discriminator weights"),
    ("finetune", "finetune_embedding")])
def test_bf16_step_is_within_bf16s_effect_of_the_jax_step(steps, regime,
                                                          group):
    """‖T16 − J16‖ ≤ C · ‖J16 − J32‖ for the losses and each gradient group
    of one step, and for the discriminator's gradient without its biases
    (the planted faults of the same runs:
    :func:`test_planted_faults_fail_the_step_bound`)."""
    runs = steps[regime]
    ratio = _ratio(runs["T16"][group], runs["J16"][group],
                   runs["J32"][group])
    print(f"{regime} step, {group}: ratio {ratio:.3g}")
    assert ratio <= C
    assert set(runs["T16"]) == set(runs["J16"])


@pytest.mark.parametrize("regime", ["meta", "finetune"])
def test_planted_faults_fail_the_step_bound(steps, regime):
    """In the same runs as the bound: the VGG differences accumulated in
    bf16 move the losses above C in both regimes; AdaIN's statistics in
    bf16 move the generator's gradient without its biases above C in both
    (meta 2.9, fine-tune 2.0), and the meta step's whole generator
    gradient (2.4; in the fine-tune step 1.1, printed)."""
    runs = steps[regime]
    ratios = {fault: {g: _ratio(runs[fault][g], runs["J16"][g],
                                runs["J32"][g]) for g in runs["J16"]}
              for fault in ("adain fault", "vgg fault", "dis fault")}
    for fault, by_group in ratios.items():
        print(f"{regime} step, {fault}: " + ", ".join(
            f"{g} {r:.3g}" for g, r in by_group.items()))
    assert ratios["vgg fault"]["losses"] > C
    assert ratios["adain fault"]["generator weights"] > C
    if regime == "meta":
        assert ratios["adain fault"]["generator"] > C


def _f32_ratio(t16, j16, j32, sound):
    """‖T16 − J32‖/‖J32‖ over a group, in units of bf16's effect on the
    group's sound leaves, ‖J16 − J32‖/‖J32‖ there."""
    effect = _l2([a - b for a, b in zip(j16[sound], j32[sound])]) \
        / _l2(j32[sound])
    group = sound.split()[0]
    return _l2([a - b for a, b in zip(t16[group], j32[group])]) \
        / _l2(j32[group]) / effect


@pytest.mark.parametrize("regime,group", [
    ("meta", "generator"), ("meta", "discriminator"),
    ("finetune", "generator"), ("finetune", "discriminator")])
def test_bf16_gradient_is_within_bf16s_effect_of_the_f32_step(steps, regime,
                                                              group):
    """The generator's and the discriminator's gradient, biases included,
    against J32: ‖T16 − J32‖/‖J32‖ ≤ C · bf16's effect on the group's sound
    leaves (module docstring), with a planted fault in the same runs that
    reads above C: AdaIN's statistics in bf16 on the generator, the
    discriminator's bias gradients summed in bf16 on the discriminator."""
    runs = steps[regime]
    fault = {"generator": "adain fault", "discriminator": "dis fault"}[group]
    ratio, planted = (_f32_ratio(runs[r], runs["J16"], runs["J32"],
                                 group + " sound") for r in ("T16", fault))
    print(f"{regime} step, {group} against f32: ratio {ratio:.3g}; "
          f"{fault} {planted:.3g}")
    assert ratio <= C
    assert planted > C


def test_the_port_takes_no_autocast_and_no_loss_scaling():
    """Mixed precision is written out where the JAX package casts: no
    ``torch.autocast`` (its per-op lists would give another dtype map) and
    no ``GradScaler`` or loss scaling (bf16 has f32's exponent range)."""
    import re
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    sources = [*(root / "latentpose_tpu_torch").rglob("*.py"),
               root / "chip_smoke.py"]
    use = re.compile(r"autocast\(|GradScaler|torch\.(cuda\.)?amp\b")
    for src in sources:
        assert not use.search(src.read_text()), src
