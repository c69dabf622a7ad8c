"""PyTorch port, int8 serving (drive's ``--quantize int8|int8_static``) held
against the JAX package on the CPU.

- The int8 convolution (``ops/quant.py``): the int8 activation and kernel,
  their scales, the int32 accumulators and the bf16 / f32 outputs of
  ``conv2d_int8`` and ``conv2d_int8_static`` are bit-equal to the JAX
  package's, for a 3x3 pad-1 conv, a 1x1 conv and the polyphase upsample
  kernel; so are the accumulators past 2^24, where int32 -> bf16 rounds
  twice.  The card's route (im2col + ``torch._int_mm``) runs here on CPU
  tensors too and is bit-equal to the plain route.
- ``s2d_up_kernel`` and ``depth_to_space`` equal the JAX package's; in f64
  the polyphase conv then the interleave equals upsample-then-conv.
- Each quantized conv's calibration (the running per-input-channel max of
  |x|) is bit-equal to the JAX conv's ``quant_calib`` update over batches.
- The int8 and int8_static generators loaded from a JAX-written fine-tuned
  checkpoint, through ``drive_sequence``: each within 40 dB PSNR of the
  JAX package's quantized output, and each >= 40 dB against the exact path
  (the JAX package's quality gate, ``tests/test_quantize.py``).
- ``calibrate_quant_scales`` against the JAX package's on the same frames
  and batch size: bit-equal (1e-6 relative stated) where each quantized
  conv sees the JAX conv's input; free-running, the two packages' f32
  rounding differs by ~1e-7, which flips a few int8 roundings by one step,
  and the flips move the later convs' maxima (bound stated below).

The JAX fine-tuned state is ``tests/test_torch_drive.py``'s, with the
generator's learned constant drawn from a normal (a constant near its ones
init leaves the first instance norm nearly flat, where both packages' f32
one-pass variance cancels; ``tests/test_torch_metatrain.py`` draws it so
for the same reason) and the pose tower's BatchNorm means drawn near zero
(means near one leave every activation after its first ReLU at zero, so
every frame gets the same pose and the same output, and the per-batch
dynamic scales could not differ from the calibrated ones).
"""

import contextlib
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentpose_tpu import checkpoint as jckpt
from latentpose_tpu.models.generators import (
    vector_pose_unsupervised_segmentation_noBottleneck as jgen_mod)
from latentpose_tpu.ops import image as jimage
from latentpose_tpu.ops import quant as jquant
from latentpose_tpu.ops import spectral_norm as jsn
from latentpose_tpu.runners import drive as jdrive
from latentpose_tpu_torch import convert
from latentpose_tpu_torch.models.generators import (
    vector_pose_unsupervised_segmentation_noBottleneck as tgen_mod)
from latentpose_tpu_torch.ops import image as timage
from latentpose_tpu_torch.ops import quant as tquant
from latentpose_tpu_torch.ops.spectral_norm import SNConv, calibrating
from latentpose_tpu_torch.runners import drive as tdrive
from test_torch_drive import IMG, _port, jax_finetuned_state

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the JAX package's quality gate for both int8 modes (tests/test_quantize.py)
MIN_PSNR = 40.0
BATCH = 2
FRAMES = 5          # two full batches and a padded tail


def _nchw(a, dtype):
    """NHWC numpy -> NCHW torch in channels_last, cast to ``dtype``."""
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2) \
        .contiguous(memory_format=torch.channels_last).to(dtype)


def _oihw(k, dtype):
    return torch.from_numpy(np.array(k, np.float32)).permute(3, 2, 0, 1) \
        .to(dtype)


def _np(t):
    """torch (any dtype, NCHW) -> numpy NHWC, bf16 through f32 exactly."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.permute(0, 2, 3, 1).numpy() if t.ndim == 4 else t.numpy()


def _jnp(a):
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def _case(kind, seed=0):
    """(x NHWC, HWIO kernel, padding) of one conv kind; the s2d kind is the
    polyphase kernel of a 3x3 upsample conv, taken in f32 as the JAX
    SNConv takes it."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 7, 9, 24) * 1.7).astype(np.float32)
    if kind == "conv1x1":
        return x, (rng.randn(1, 1, 24, 16) * 0.2).astype(np.float32), 0
    k = (rng.randn(3, 3, 24, 16) * 0.1).astype(np.float32)
    if kind == "s2d":
        k = np.asarray(jimage.s2d_up_kernel(jnp.asarray(k)))
    return x, k, 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("kind", ["conv3x3", "conv1x1", "s2d"])
def test_int8_conv_is_bit_equal_to_jax(kind, mode, dtype):
    x, k, pad = _case(kind)
    jdt, tdt = DTYPES[dtype]
    jx, jk = jnp.asarray(x).astype(jdt), jnp.asarray(k).astype(jdt)
    tx, tk = _nchw(x, tdt), _oihw(k, tdt)
    calib = np.abs(x).max(axis=(0, 1, 2)) * 0.8     # saturates some values
    if mode == "dynamic":
        jxq, jsx = jquant.quantize_dynamic(jx)
        txq, tsx = tquant.quantize_dynamic(tx)
    else:
        jsx = jnp.maximum(jnp.max(jnp.asarray(calib)) / 127.0, 1e-12)
        jxq = jnp.clip(jnp.round(jx.astype(jnp.float32) * (1.0 / jsx)),
                       -127.0, 127.0).astype(jnp.int8)
        txq, tsx = tquant.quantize_static(tx, torch.from_numpy(calib))
    jkq, jsk = jquant.quantize_kernel_per_channel(jk)
    tkq, tsk = tquant.quantize_kernel_per_channel(tk)
    np.testing.assert_array_equal(_np(txq), np.asarray(jxq))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(tkq.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jkq))
    np.testing.assert_array_equal(tsk.numpy(), np.asarray(jsk))
    jpad = ((pad, pad), (pad, pad))
    np.testing.assert_array_equal(
        _np(tquant.int8_conv(txq, tkq, pad)),
        np.asarray(jquant._int8_conv(jxq, jkq, (1, 1), jpad)))
    if mode == "dynamic":
        want = jquant.conv2d_int8(jx, jk, padding=jpad, out_dtype=jdt)
        got = tquant.conv2d_int8(tx, tk, pad, out_dtype=tdt)
    else:
        want = jquant.conv2d_int8_static(jx, jk, jnp.asarray(calib),
                                         padding=jpad, out_dtype=jdt)
        got = tquant.conv2d_int8_static(tx, tk, torch.from_numpy(calib), pad,
                                        out_dtype=tdt)
    assert got.dtype == tdt and got.shape[1] == k.shape[-1]
    np.testing.assert_array_equal(_np(got), _jnp(want))


def test_accumulators_past_2_24_round_to_bf16_as_jax():
    """All-positive int8 values over 9 x 1024 inputs: sums up to ~1.5e8,
    where the int32 -> bf16 cast rounds through f32 first in both
    packages; the epilogue stays bit-equal."""
    rng = np.random.RandomState(1)
    x = rng.uniform(0.9, 1.0, (1, 3, 3, 1024)).astype(np.float32)
    k = rng.uniform(0.9, 1.0, (3, 3, 1024, 8)).astype(np.float32)
    jpad = ((1, 1), (1, 1))
    xq, _ = tquant.quantize_dynamic(_nchw(x, torch.float32))
    kq, _ = tquant.quantize_kernel_per_channel(_oihw(k, torch.float32))
    acc = tquant.int8_conv(xq, kq, 1)
    assert int(acc.abs().max()) > 2 ** 24
    want = jquant.conv2d_int8(jnp.asarray(x), jnp.asarray(k), padding=jpad,
                              out_dtype=jnp.float32)
    got = tquant.conv2d_int8(_nchw(x, torch.float32),
                             _oihw(k, torch.float32), 1,
                             out_dtype=torch.float32)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("case", [
    dict(b=2, c=24, hw=(7, 9), o=16, k=3, pad=1),
    dict(b=1, c=20, hw=(4, 4), o=12, k=3, pad=1),     # 16 rows; K, O padded
    dict(b=3, c=32, hw=(5, 6), o=40, k=1, pad=0),
    dict(b=3, c=12, hw=(6, 5), o=8, k=3, pad=1, chunk=True),
])
def test_card_route_im2col_is_exact(case, monkeypatch):
    """The card's im2col + ``torch._int_mm`` (run here on CPU tensors) is
    bit-equal to the plain float64 route, rows at or under 16, K and O off
    multiples of 8 and the sample chunks included."""
    if case.get("chunk"):
        monkeypatch.setattr(tquant, "IM2COL_BYTES", 1)   # one sample a GEMM
    g = torch.Generator().manual_seed(case["c"])
    xq = torch.randint(-127, 128, (case["b"], case["c"], *case["hw"]),
                       generator=g, dtype=torch.int8) \
        .contiguous(memory_format=torch.channels_last)
    kq = torch.randint(-127, 128, (case["o"], case["c"], case["k"],
                                   case["k"]), generator=g, dtype=torch.int8)
    got = tquant._im2col_int_mm(xq, kq, case["pad"])
    want = tquant.int8_conv_reference(xq, kq, case["pad"])
    assert got.dtype == torch.int32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_s2d_kernel_and_interleave_match_jax():
    rng = np.random.RandomState(2)
    k = rng.randn(3, 3, 8, 6).astype(np.float32)
    want = np.asarray(jimage.s2d_up_kernel(jnp.asarray(k)))
    got = timage.s2d_up_kernel(_oihw(k, torch.float32)).permute(2, 3, 1, 0)
    np.testing.assert_array_equal(got.numpy(), want)
    y = rng.randn(2, 5, 7, 24).astype(np.float32)
    np.testing.assert_array_equal(
        _np(timage.depth_to_space(_nchw(y, torch.float32), 6)),
        np.asarray(jimage.depth_to_space(jnp.asarray(y), 6)))


def test_s2d_conv_then_interleave_is_upsample_then_conv_in_f64():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 5, 6, generator=g, dtype=torch.float64)
    k = torch.randn(6, 8, 3, 3, generator=g, dtype=torch.float64)
    want = torch.nn.functional.conv2d(timage.upsample_nearest_2x(x), k,
                                      padding=1)
    got = timage.depth_to_space(torch.nn.functional.conv2d(
        x, timage.s2d_up_kernel(k), padding=1), 6)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def _gen_args(quantize, image_size=16):
    return types.SimpleNamespace(
        gen_padding="zero", out_channels=3, num_channels=4,
        max_num_channels=16, embed_channels=16, pose_embedding_size=8,
        gen_constant_input_size=4, gen_num_residual_blocks=1,
        image_size=image_size, quantize=quantize)


def test_quantized_modules_keep_the_float_state_keys():
    """The dynamic generator's state is the float one's (the same checkpoint
    loads); the static one adds each quantized conv's ``act_absmax``."""
    keys = {q: set(tgen_mod.Wrapper.get_net(_gen_args(q)).state_dict())
            for q in ("", "int8", "int8_static")}
    assert keys["int8"] == keys[""]
    extra = keys["int8_static"] - keys[""]
    assert keys[""] <= keys["int8_static"] and extra and all(
        k.endswith(".act_absmax") for k in extra)


def test_flagship_quantizes_22_convs_and_not_the_head():
    args = _gen_args("int8", image_size=256)
    args.num_channels, args.max_num_channels = 64, 512
    args.embed_channels, args.pose_embedding_size = 512, 256
    args.gen_num_residual_blocks = 2
    gen = tgen_mod.Wrapper.get_net(args)
    convs = {n for n, m in gen.named_modules()
             if isinstance(m, SNConv) and m.quantize}
    plan = tgen_mod.quantized_conv_shapes()
    assert len(convs) == 22 == len(plan) and gen.head_conv.quantize == ""
    assert convs == {name for name, *_ in plan}
    assert len(gen.adain_features) == 17


def test_a_forward_runs_one_int8_product_per_quantized_conv(monkeypatch):
    calls = []
    plain = tquant.int8_conv_reference

    def counted(xq, kq, padding):
        calls.append((tuple(xq.shape), tuple(kq.shape)))
        return plain(xq, kq, padding)

    monkeypatch.setattr(tquant, "int8_conv_reference", counted)
    args = _gen_args("int8")
    gen = tgen_mod.Wrapper.get_net(args, generator=torch.Generator()
                                   .manual_seed(0)).eval()
    with torch.no_grad():
        gen(torch.randn(2, 16), torch.randn(2, 8))
    plan = tgen_mod.quantized_conv_shapes(4, 16, 4, 1, 16)
    assert [(c[0][1], c[1][0], c[1][2], c[0][2]) for c in calls] == \
        [(cin, cout, k, side) for _, cin, cout, k, side in plan]


@pytest.mark.parametrize("kind", ["conv3x3", "conv1x1", "upsample"])
def test_conv_calibration_is_bit_equal_to_jax(kind):
    """A quantized SNConv's running per-input-channel max over three
    batches in both packages, from the same weights; then the static
    conv's output with it."""
    rng = np.random.RandomState(4)
    size = 1 if kind == "conv1x1" else 3
    jconv = jsn.SNConv(6, (size, size), padding=size // 2, quantize=True,
                       upsample_2x=kind == "upsample")
    xs = [(rng.randn(2, 5, 5, 8) * (1 + i)).astype(np.float32)
          for i in range(3)]
    variables = jconv.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    tconv = SNConv(8, 6, size, size // 2, True, quantize="int8_static")
    flat = {f"params::c::{k}": np.asarray(v)
            for k, v in variables["params"].items()}
    flat.update({f"spectral::c::{k}": np.asarray(v)
                 for k, v in variables["spectral"].items()})
    convert.load_into(tconv, flat, "c")
    calib = {}
    for x in xs:
        vs = dict(variables, **({"quant_calib": calib} if calib else {}))
        _, mut = jconv.apply(vs, jnp.asarray(x), mutable=["quant_calib"])
        calib = mut["quant_calib"]
        with torch.no_grad(), calibrating(tconv):
            tconv(_nchw(x, torch.float32), upsample_2x=kind == "upsample")
    np.testing.assert_array_equal(tconv.act_absmax.numpy(),
                                  np.asarray(calib["act_absmax"]))
    jstatic = jsn.SNConv(6, (size, size), padding=size // 2, quantize=True,
                         quant_static=True, upsample_2x=kind == "upsample")
    want = jstatic.apply(dict(variables, quant_calib=calib),
                         jnp.asarray(xs[1]))
    with torch.no_grad():
        got = tconv(_nchw(xs[1], torch.float32),
                    upsample_2x=kind == "upsample")
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.fixture(scope="module")
def jax_conditioned(tmp_path_factory):
    """``tests/test_torch_drive.py``'s JAX fine-tuned state with the
    generator's constant (EMA and raw) drawn from a seeded normal and the
    BatchNorm statistics redrawn (module docstring), saved; (args, models,
    state, path, frames)."""
    args, models, state = jax_finetuned_state()
    rng = np.random.RandomState(11)
    params = {}
    for coll in ("params", "ema_params"):
        tree = dict(getattr(state, coll))
        gen = dict(tree["generator"])
        gen["constant"] = jnp.asarray(
            rng.randn(*np.shape(gen["constant"])).astype(np.float32))
        tree["generator"] = gen
        params[coll] = tree

    def stats(path, leaf):
        low, high = (-0.1, 0.1) if path[-1].key == "mean" else (0.5, 1.5)
        return jnp.asarray(rng.uniform(low, high, np.shape(leaf))
                           .astype(np.float32))

    params["batch_stats"] = jax.tree_util.tree_map_with_path(
        stats, state.batch_stats)
    state = state.replace(**params)
    path = jckpt.save_checkpoint(tmp_path_factory.mktemp("jax_q"), state,
                                 args)
    frames = np.random.RandomState(3).rand(FRAMES, IMG, IMG, 3) \
        .astype(np.float32)
    return args, models, state, path, frames


def _jax_quantized(args, models, quantize, compute_dtype):
    jargs = types.SimpleNamespace(**vars(args))
    jargs.quantize, jargs.compute_dtype = quantize, compute_dtype
    return jargs, dict(models, generator=jgen_mod.Wrapper.get_net(jargs))


def _jax_drive(args, models, state, frames, quantize, compute_dtype,
               calib_observer=None):
    """The JAX package's drive_sequence (and its calibration for
    int8_static, on ``frames``, as the CLI does on a short sequence)."""
    jargs, jmodels = _jax_quantized(args, models, quantize, compute_dtype)
    calib = None
    if quantize == "int8_static":
        _, dyn = _jax_quantized(args, models, "int8", compute_dtype)
        with calib_observer or contextlib.nullcontext():
            calib = jdrive.calibrate_quant_scales(dyn, jargs, state, frames,
                                                  batch_size=BATCH)
    out = jdrive.drive_sequence(
        jdrive.make_drive_fn(jmodels, jargs, quant_calib=calib), state,
        frames, batch_size=BATCH)
    return out, calib


def _port_drive(path, frames, quantize, compute_dtype):
    args, models, state = _port(path, "--compute_dtype", compute_dtype,
                                *(["--quantize", quantize] if quantize
                                  else []))
    calib = None
    if quantize == "int8_static":
        calib = tdrive.calibrate_quant_scales(models, args, state, frames,
                                              batch_size=BATCH)
    out = tdrive.drive_sequence(
        tdrive.make_drive_fn(models, args, quant_calib=calib), state, frames,
        batch_size=BATCH)
    return out, calib


def _psnr(a, b):
    return float(10 * np.log10(1.0 / np.mean((a - b) ** 2)))


def test_static_scales_are_the_calibrated_ones(jax_conditioned, monkeypatch):
    """int8_static serves with each conv's calibrated per-tensor scale,
    which differs from the batch's own (dynamic) one in some batches: the
    frames' poses differ, so their activations do."""
    args, models, state, path, frames = jax_conditioned
    targs, tmodels, tstate = _port(path, "--compute_dtype", "float32",
                                   "--quantize", "int8_static")
    calib = tdrive.calibrate_quant_scales(tmodels, targs, tstate, frames,
                                          batch_size=BATCH)
    seen = []
    static = tquant.quantize_static

    def spy(x, act_absmax):
        q, scale = static(x, act_absmax)
        seen.append((float(scale), float(tquant.quantize_dynamic(x)[1])))
        return q, scale

    monkeypatch.setattr(tquant, "quantize_static", spy)
    tdrive.drive_sequence(tdrive.make_drive_fn(tmodels, targs, calib),
                          tstate, frames, batch_size=BATCH)
    scales = sorted({float(torch.clamp(v.max() / 127.0, min=1e-12))
                     for v in calib.values()})
    assert len(seen) == len(calib) * -(-FRAMES // BATCH)
    assert all(s in scales for s, _ in seen)
    assert any(s != d for s, d in seen)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", ["int8", "int8_static"])
def test_quantized_drive_sequence_matches_jax(jax_conditioned, quantize,
                                              compute_dtype):
    """``drive_sequence`` through the int8 generator loaded from the JAX
    checkpoint against the JAX package's: the int8 roundings that the two
    packages' f32 rounding flips keep them apart by more than the exact
    path's 1e-4, so they are held at the quality gate, 40 dB PSNR to each
    other (read 56.8-66.9 dB); each is >= 40 dB against its exact path
    (read 56.4-63.6 dB in both packages)."""
    args, models, state, path, frames = jax_conditioned
    want, _ = _jax_drive(args, models, state, frames, quantize,
                         compute_dtype)
    got, _ = _port_drive(path, frames, quantize, compute_dtype)
    exact, _ = _port_drive(path, frames, "", compute_dtype)
    jexact, _ = _jax_drive(args, models, state, frames, "", compute_dtype)
    assert got.shape == (FRAMES, IMG, IMG, 3) and np.isfinite(got).all()
    readings = (_psnr(got, want), _psnr(got, exact), _psnr(want, jexact))
    assert min(readings) >= MIN_PSNR, readings


class _JaxConvInputs:
    """Records every quantized JAX conv's input, per call, in order
    (``jax.debug.callback`` from inside the jitted calibration step)."""

    def __init__(self):
        self.seen = {}

    def _intercept(self, next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, jsn.SNConv) and mod.quantize \
                and context.method_name == "__call__":
            name = ".".join(mod.scope.path)
            jax.debug.callback(
                lambda x: self.seen.setdefault(name, []).append(
                    np.asarray(x, np.float32)), args[0], ordered=True)
        return next_fun(*args, **kwargs)

    def __enter__(self):
        self._ctx = nn.intercept_methods(self._intercept)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        jax.effects_barrier()
        return self._ctx.__exit__(*exc)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_calibration_matches_jax(jax_conditioned, compute_dtype):
    """``calibrate_quant_scales`` on the same frames and batch size (a
    padded tail batch).  With each of the port's quantized convs fed the
    JAX conv's input of the same batch, every act_absmax is within 1e-6
    relative of the JAX package's in f32 (read 0: bit-equal); in bf16
    within 2^-8, one bf16 rounding (read 3.4e-3 on the skips alone: XLA
    keeps the residual sum that feeds a skip in f32 inside the fused absmax,
    its excess-precision rewrite, where the port rounds it to bf16 as the
    program says).  Free-running, each conv's maxima within 2e-2 (f32) and
    5e-2 (bf16) of its largest, the per-tensor scale that serving takes
    (read 7.7e-3 / 2.1e-2: the int8 roundings that the packages' f32
    rounding flips move the later convs' inputs)."""
    args, models, state, path, frames = jax_conditioned
    observer = _JaxConvInputs()
    _, jcalib = _jax_drive(args, models, state, frames, "int8_static",
                           compute_dtype, observer)
    want = convert.quant_calib_from_jax(jcalib)
    targs, tmodels, tstate = _port(path, "--compute_dtype", compute_dtype,
                                   "--quantize", "int8_static")
    free = tdrive.calibrate_quant_scales(tmodels, targs, tstate, frames,
                                         batch_size=BATCH)
    assert set(free) == set(want) and len(want) == 8

    calls = {name: 0 for name in want}

    def feed(name):
        def hook(module, inputs, kwargs):
            x = observer.seen[name][calls[name]]
            calls[name] += 1
            return (_nchw(x, inputs[0].dtype), *inputs[1:]), kwargs
        return hook

    gen = tmodels["generator"]
    hooks = [gen.get_submodule(name).register_forward_pre_hook(
        feed(name), with_kwargs=True) for name in want]
    try:
        forced = tdrive.calibrate_quant_scales(tmodels, targs, tstate, frames,
                                               batch_size=BATCH)
    finally:
        for h in hooks:
            h.remove()
    batches = -(-FRAMES // BATCH)
    assert all(len(observer.seen[n]) == batches == calls[n] for n in want)

    def rel(got):
        return {n: float(((got[n] - want[n]).abs()
                          / want[n].abs().clamp(min=1e-30)).max())
                for n in want}

    forced_bound = 1e-6 if compute_dtype == "float32" else 2.0 ** -8
    assert max(rel(forced).values()) <= forced_bound, rel(forced)
    of_max = {n: float((free[n] - want[n]).abs().max() / want[n].max())
              for n in want}
    bound = 2e-2 if compute_dtype == "float32" else 5e-2
    assert max(of_max.values()) <= bound, of_max


def test_quant_calib_crosses_to_and_from_jax(jax_conditioned):
    args, models, state, path, frames = jax_conditioned
    _, jcalib = _jax_drive(args, models, state, frames[:BATCH],
                           "int8_static", "float32")
    port = convert.quant_calib_from_jax(jcalib)
    back = convert.quant_calib_to_jax(port)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jax.device_get(jcalib))
    for (kp, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(jax.device_get(jcalib))[0]):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(kp))
    assert convert.quant_calib_from_jax({"generator": jcalib}).keys() == \
        port.keys()
    # and it loads into the static generator the drive fn runs
    targs, tmodels, tstate = _port(path, "--compute_dtype", "float32",
                                   "--quantize", "int8_static")
    tdrive.make_drive_fn(tmodels, targs, quant_calib=port)
    gen = tmodels["generator"]
    for name, value in port.items():
        assert torch.equal(gen.get_submodule(name).act_absmax, value)
