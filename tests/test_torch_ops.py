"""PyTorch port, ops: AdaIN (plain version and wrapper), spectral-norm
layers and image ops, held against the JAX package on the same numpy
inputs.  CPU only: the wrapper serves CPU tensors with its plain version."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from latentpose_tpu.checkpoint import _flatten
from latentpose_tpu.ops import image as jimage
from latentpose_tpu.ops import norms as jnorms
from latentpose_tpu.ops import spectral_norm as jsn
from latentpose_tpu_torch import convert
from latentpose_tpu_torch.ops import adain as tadain
from latentpose_tpu_torch.ops import image as timage
from latentpose_tpu_torch.ops import spectral_norm as tsn

torch.set_num_threads(1)

# the shapes of tests/test_pallas_kernels.py
SHAPES = [(2, 8, 8, 128), (1, 16, 8, 256), (2, 32, 16, 64)]
# (H*W, C) of the flagship generator's 17 AdaINs at 256²
FLAGSHIP_HWC = [(16, 512), (64, 512), (256, 512), (1024, 512), (4096, 256),
                (16384, 128), (65536, 64)]


def _adain_inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    b, _, _, c = shape
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    w = rng.standard_normal((b, c)).astype(np.float32)
    bias = rng.standard_normal((b, c)).astype(np.float32)
    return x, w, bias


def _jax_adain(x, w, b, relu):
    y = jnorms.adain(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return np.asarray(jnp.maximum(y, 0.0) if relu else y)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_adain_reference_matches_jax_norms(shape, relu):
    x, w, b = _adain_inputs(shape)
    got = tadain.adain_reference(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b), relu=relu)
    np.testing.assert_allclose(got.numpy(), _jax_adain(x, w, b, relu),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["instance_norm", "adain",
                                  "instance_norm_affine"])
def test_plain_norms_match_jax(name):
    from latentpose_tpu_torch.ops import norms as tnorms
    x, w, b = _adain_inputs((2, 8, 4, 16), seed=6)
    if name == "instance_norm_affine":
        w, b = w[0], b[0]
    args = () if name == "instance_norm" else (w, b)
    want = getattr(jnorms, name)(jnp.asarray(x), *map(jnp.asarray, args))
    got = getattr(tnorms, name)(torch.from_numpy(x),
                                *map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_adain_matches_pallas_kernel_interpret(shape, relu):
    """The port's wrapper (CPU -> plain version) against the TPU kernel it
    replaces, run in interpret mode as tests/test_pallas_kernels.py runs it."""
    from jax.experimental.pallas import tpu as pltpu
    from latentpose_tpu.ops.pallas.adain_fused import adain_fused

    x, w, b = _adain_inputs(shape, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(adain_fused(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), relu=relu))
    got = tadain.adain(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), relu=relu)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("value", [1.5, 3000.3])
def test_adain_constant_channels_clamp_variance(value):
    """Constant channels.  At 1.5 every sum is exact: the variance is 0,
    the output is relu(bias) there, as in the JAX norms.  At 3000.3 the
    one-pass E[x²] − E[x]² cancels to a negative f32 number below −eps, so
    without the clamp at 0 (ops/norms.py) rsqrt would give NaN; the clamp
    keeps the output finite (its value there is rounding noise in either
    framework, so only the other channels are compared)."""
    b, h, w, c = 2, 8, 16, 64
    rng = np.random.RandomState(2)
    x = (rng.standard_normal((b, h, w, c)) * 2).astype(np.float32)
    x[..., ::2] = np.float32(value)
    wt = rng.standard_normal((b, c)).astype(np.float32)
    bias = rng.standard_normal((b, c)).astype(np.float32)
    xt = torch.from_numpy(x)
    raw_var = xt.square().mean(dim=(1, 2)) - xt.mean(dim=(1, 2)).square()

    got = tadain.adain(xt, torch.from_numpy(wt), torch.from_numpy(bias))
    want = _jax_adain(x, wt, bias, True)
    assert torch.isfinite(got).all()
    if value == 1.5:
        assert (raw_var[:, ::2] == 0).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(
            got.numpy()[..., ::2],
            np.broadcast_to(np.maximum(bias, 0)[:, None, None, ::2],
                            (b, h, w, c // 2)))
    else:
        assert (raw_var[:, ::2] < -1e-4).any(), "case no longer needs the clamp"
        np.testing.assert_allclose(got.numpy()[..., 1::2], want[..., 1::2],
                                   rtol=2e-4, atol=2e-4)


def test_adain_wrapper_rejects_what_the_kernel_does_not_take():
    x, w, b = (torch.from_numpy(a) for a in _adain_inputs((2, 4, 4, 64)))
    with pytest.raises(TypeError):
        tadain.adain(x.half(), w.half(), b.half())
    with pytest.raises(TypeError):
        tadain.adain(x, w.bfloat16(), b)
    with pytest.raises(ValueError, match="contiguous"):
        tadain.adain(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError):
        tadain.adain(x, w[:1], b)
    # channel counts the kernel cannot vectorise (checked before a launch)
    tadain.check_kernel_layout(x)
    tadain.check_kernel_layout(x.bfloat16())
    for bad in (x[..., :6].contiguous(), x[..., :60].bfloat16(),
                torch.zeros(1, 1, 1, 4096)):
        with pytest.raises(ValueError, match="multiple"):
            tadain.check_kernel_layout(bad)
    # a tensor on a device other than the CPU never reaches the plain version
    with pytest.raises(ValueError, match="device"):
        tadain.adain(x.to("meta"), w.to("meta"), b.to("meta"))
    assert tadain.adain.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
def test_adain_operator_cpu_is_the_plain_version(relu, dtype):
    """``latentpose::adain_fused``'s CPU implementation is
    ``adain_reference``, bit for bit, and the wrapper calls the operator."""
    x, w, b = (torch.from_numpy(a).to(dtype)
               for a in _adain_inputs((2, 8, 4, 32), seed=21))
    want = tadain.adain_reference(x, w, b, relu, 1e-4)
    got = torch.ops.latentpose.adain_fused(x, w, b, relu, 1e-4)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(tadain.adain(x, w, b, relu), want, rtol=0,
                               atol=0)


def test_adain_operator_rejects_what_the_kernel_does_not_take():
    """Called directly, not through the wrapper, the operator checks its
    inputs as the wrapper did: a (1, C) weight, a weight in another dtype
    and a non-contiguous x raise before any implementation reads them."""
    x, w, b = (torch.from_numpy(a) for a in _adain_inputs((2, 4, 4, 64)))
    op = torch.ops.latentpose.adain_fused
    with pytest.raises(ValueError, match=r"\(B, C\)"):
        op(x, w[:1], b, True, 1e-4)
    with pytest.raises(ValueError, match=r"\(B, C\)"):
        op(x, w, b[:, None], True, 1e-4)
    with pytest.raises(TypeError, match="dtype"):
        op(x.bfloat16(), w, b.bfloat16(), True, 1e-4)
    with pytest.raises(ValueError, match="contiguous"):
        op(x.transpose(1, 2), w, b, True, 1e-4)
    assert tadain.adain.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adain_operator_passes_opcheck(dtype):
    """The operator's schema, its fake implementation (the output's shape,
    dtype and strides) and its dispatch, as ``torch.library.opcheck``
    checks them; no input needs a gradient, since the operator has no
    autograd kernel (``_AdaIN`` differentiates it)."""
    x, w, b = (torch.from_numpy(a).to(dtype)
               for a in _adain_inputs((2, 4, 4, 16), seed=22))
    for relu in (False, True):
        torch.library.opcheck(torch.ops.latentpose.adain_fused.default,
                              (x, w, b, relu, 1e-4))
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fx = mode.from_tensor(x)
        out = tadain.adain(fx, mode.from_tensor(w), mode.from_tensor(b))
        assert out.shape == x.shape and out.dtype == dtype
    assert tadain.adain.launches == 0


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("hw,c", FLAGSHIP_HWC)
@pytest.mark.parametrize("batch", [1, 8, 32])
def test_launch_plan_covers_every_pixel(batch, hw, c, itemsize):
    """One cluster per sample: its blocks' slices cover the sample's pixels
    once, the cluster and each block's shared memory fit the card, the
    resident part fits its mbarriers, and in bf16 every sample up to
    (4096, 256) stays on chip (x read from device memory once)."""
    plan = tadain.plan_launch(hw, c, itemsize)
    assert 1 <= plan.cluster <= 16
    slices = [(r * plan.block_pixels, min((r + 1) * plan.block_pixels, hw))
              for r in range(plan.cluster)]
    covered = np.zeros(hw, np.int64)
    for lo, hi in slices:
        assert lo < hi                      # no block without pixels
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert plan.smem <= tadain.SMEM_LIMIT
    assert plan.smem == tadain.smem_bytes(c, itemsize, plan.resident)
    assert 1 <= plan.resident <= plan.block_pixels
    assert -(-plan.resident // plan.chunk_pixels) <= 16   # kMaxChunks
    assert plan.chunk_pixels * c * itemsize % 16 == 0      # bulk-copy sizes
    if itemsize == 2 and hw * c <= 4096 * 256:
        assert plan.holds_sample
    # the grid: batch clusters of plan.cluster blocks
    assert batch * plan.cluster <= 65535 * 16


def _jax_sn_layer(module, x):
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    out = module.apply(variables, jnp.asarray(x))
    return _flatten(jax.device_get(dict(variables))), np.asarray(out)


@pytest.mark.parametrize("kernel,padding,bias", [(3, 1, True), (3, 1, False),
                                                  (1, 0, True)])
def test_snconv_matches_jax(kernel, padding, bias):
    x = np.random.RandomState(3).standard_normal((2, 8, 8, 6)) \
        .astype(np.float32)
    flat, want = _jax_sn_layer(jsn.SNConv(5, (kernel, kernel), padding=padding,
                                          use_bias=bias), x)
    layer = tsn.SNConv(6, 5, kernel, padding, bias)
    convert.load_into(layer, flat, "")
    got = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_sndense_matches_jax():
    x = np.random.RandomState(4).standard_normal((3, 12)).astype(np.float32)
    flat, want = _jax_sn_layer(jsn.SNDense(7), x)
    layer = tsn.SNDense(12, 7)
    convert.load_into(layer, flat, "")
    got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["upsample_nearest_2x", "avg_pool_2x"])
def test_image_ops_match_jax(name):
    x = np.random.RandomState(5).standard_normal((2, 6, 4, 3)) \
        .astype(np.float32)
    want = np.asarray(getattr(jimage, name)(jnp.asarray(x)))
    got = getattr(timage, name)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-6)


# --- the fused BN -> ReLU -> 1x1 conv -> stats kernel's plain version ------

@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape,cout", [((2, 8, 8, 256), 128),
                                        ((1, 16, 16, 128), 256)])
def test_conv_bn_matches_pallas_kernel_interpret(shape, cout, relu):
    """The port's wrapper (CPU -> plain version) against the TPU kernel it
    replaces, in interpret mode, at the shapes of
    tests/test_pallas_kernels.py; f32, tolerance 2e-4."""
    from jax.experimental.pallas import tpu as pltpu
    from latentpose_tpu.ops.pallas import conv_bn_fused as jconv
    from latentpose_tpu_torch.ops import conv_bn

    rng = np.random.RandomState(10)
    cin = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = (rng.standard_normal((cin, cout)) * 0.06).astype(np.float32)
    bn = [rng.uniform(lo, hi, cin).astype(np.float32)
          for lo, hi in ((-0.5, 0.5), (0.5, 4.0), (0.8, 1.2), (-0.1, 0.1))]
    scale, offset = jconv.fold_bn(*map(jnp.asarray, bn))
    with pltpu.force_tpu_interpret_mode():
        want_y, want_stats = jconv.bn_relu_conv1x1_stats(
            jnp.asarray(x), scale, offset, jnp.asarray(w), relu=relu,
            m_tile=32)
    tscale, toffset = conv_bn.fold_bn(*map(torch.from_numpy, bn))
    np.testing.assert_allclose(tscale.numpy(), np.asarray(scale), rtol=1e-6)
    np.testing.assert_allclose(toffset.numpy(), np.asarray(offset),
                               rtol=1e-6, atol=1e-7)
    y, stats = conv_bn.bn_relu_conv1x1_stats(
        torch.from_numpy(x), tscale, toffset, torch.from_numpy(w), relu=relu)
    assert y.shape == shape[:-1] + (cout,) and stats.shape == (2, cout)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(stats.numpy(), np.asarray(want_stats),
                               rtol=2e-4, atol=2e-4)


# (M, Cin, Cout): ResNeXt-50's bn2 -> ReLU -> conv3 links at 64 frames of
# 256², and ragged shapes
CONV_PLAN_SHAPES = [(64 * 4096, 128, 256), (64 * 1024, 256, 512),
                    (64 * 256, 512, 1024), (64 * 64, 1024, 2048),
                    (1000, 64, 200), (7, 8, 8)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("m,cin,cout", CONV_PLAN_SHAPES)
def test_conv_bn_tile_plan(m, cin, cout, itemsize):
    """The kernel's tiles cover y, its ring has at least 3 stages within
    the shared memory a block may take beside the staged y tile, and the TMA
    maps' row strides are multiples of 16 bytes."""
    from latentpose_tpu_torch.ops import conv_bn
    plan = conv_bn.plan_tiles(m, cin, cout, itemsize)
    assert plan.block_k * itemsize == 128          # the 128-byte swizzle span
    assert (plan.row_tiles - 1) * conv_bn.BLOCK_M < m <= \
        plan.row_tiles * conv_bn.BLOCK_M
    assert plan.block_n == conv_bn.BLOCK_N[itemsize] <= 256   # a TMA box
    assert (plan.col_tiles - 1) * plan.block_n < cout <= \
        plan.col_tiles * plan.block_n
    assert 3 <= plan.stages <= conv_bn.MAX_STAGES
    assert plan.smem <= conv_bn.SMEM_LIMIT == 232448
    w_tiles = 2 if itemsize == 4 else 1
    ring = plan.stages * (conv_bn.BLOCK_M + w_tiles * plan.block_n) * 128
    assert plan.smem >= ring + conv_bn.staging_bytes(itemsize)
    assert plan.row_bytes == cin * itemsize and plan.row_bytes % 16 == 0


def _tf32(a):
    """numpy: keep sign, exponent and the top 10 mantissa bits (truncate)."""
    return (np.ascontiguousarray(a, np.float32).view(np.int32)
            & np.int32(-(1 << 13))).view(np.float32)


@pytest.mark.parametrize("m,cin,cout", [(256, 128, 256), (64, 512, 1024),
                                        (16, 1024, 2048)])
def test_three_tf32_products_keep_f32_accuracy(m, cin, cout):
    """The f32 kernel's arithmetic, emulated in numpy: the activation split
    in registers (a_big = tf32(a), a_small = tf32(a - a_big)), W split by
    the wrapper (split_tf32), three products summed in f32.  It stays within
    the card gate (2e-4 of max |y|) of the plain f32 version; one TF32
    product does not, which is why the kernel takes three."""
    from latentpose_tpu_torch.ops import conv_bn
    rng = np.random.RandomState(m + cin)
    x = (rng.standard_normal((m, cin)) * 2 + 0.5).astype(np.float32)
    w = (rng.standard_normal((cin, cout)) / cin ** 0.5).astype(np.float32)
    scale = (rng.rand(cin) + 0.5).astype(np.float32)
    offset = (rng.standard_normal(cin) * 0.1).astype(np.float32)
    want, _ = conv_bn.bn_relu_conv1x1_stats_reference(
        *map(torch.from_numpy, (x, scale, offset, w)))
    want = want.numpy()
    a = np.maximum(x * scale + offset, np.float32(0))
    a_big = _tf32(a)
    a_small = _tf32(a - a_big)
    w_big, w_small = (t.numpy() for t in conv_bn.split_tf32(
        torch.from_numpy(np.ascontiguousarray(w.T))))
    w_big, w_small = w_big.T, w_small.T
    np.testing.assert_array_equal(w_big, _tf32(w))
    three = a_small @ w_big + a_big @ w_small + a_big @ w_big
    one = a_big @ w_big
    gate = 2e-4 * np.abs(want).max()
    assert np.abs(three - want).max() <= gate
    assert np.abs(one - want).max() > gate


def test_conv_bn_wrapper_refuses_what_it_does_not_take():
    from latentpose_tpu_torch.ops import conv_bn
    x = torch.randn(4, 16)
    scale, offset, w = torch.ones(16), torch.zeros(16), torch.randn(16, 8)
    with pytest.raises(TypeError):
        conv_bn.bn_relu_conv1x1_stats(x.half(), scale, offset, w.half())
    with pytest.raises(ValueError, match="contiguous"):
        conv_bn.bn_relu_conv1x1_stats(x.t().contiguous().t(), scale, offset,
                                      w)
    with pytest.raises(ValueError, match="Cin"):
        conv_bn.bn_relu_conv1x1_stats(x, scale, offset, w[:8])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv_bn.bn_relu_conv1x1_stats(x.double(), scale.double(),
                                      offset.double(), w.double())
    with torch.no_grad():
        conv_bn.bn_relu_conv1x1_stats(x, scale, offset, w)
    # channels the kernel cannot vectorise, checked before a launch
    conv_bn.check_kernel_layout(x, w)
    for bad_x, bad_w in ((x[:, :6].contiguous(), w[:6]),
                         (x.bfloat16(), w[:, :4].contiguous().bfloat16()),
                         (x, w[:, :6].contiguous())):
        with pytest.raises(ValueError, match="multiple"):
            conv_bn.check_kernel_layout(bad_x, bad_w)
    with torch.no_grad(), pytest.raises(ValueError, match="device"):
        conv_bn.bn_relu_conv1x1_stats(x.to("meta"), scale.to("meta"),
                                      offset.to("meta"), w.to("meta"))
    assert conv_bn.bn_relu_conv1x1_stats.launches == 0


# --- AdaIN under autograd ---------------------------------------------------

@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_adain_gradient_matches_jax_grad(shape, relu):
    """The autograd.Function's backward against jax.grad through
    norms.adain (+ ReLU) for the same cotangent; f32 on the CPU."""
    x, w, b = _adain_inputs(shape, seed=11)
    cot = np.random.RandomState(12).standard_normal(shape).astype(np.float32)

    def jloss(x, w, b):
        y = jnorms.adain(x, w, b)
        return ((jnp.maximum(y, 0.0) if relu else y) * cot).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    (tadain.adain(*leaves, relu=relu) * torch.from_numpy(cot)).sum() \
        .backward()
    for got, ref in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("relu", [False, True])
def test_adain_gradients_are_the_plain_backward(relu):
    """Under autograd the wrapper's forward is the operator and its
    gradients are ``adain_backward``'s, bit for bit; within 1e-4 of
    autograd through the plain version."""
    shape = SHAPES[0]
    x, w, b = _adain_inputs(shape, seed=13)
    cot = torch.from_numpy(
        np.random.RandomState(14).standard_normal(shape).astype(np.float32))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    y = tadain.adain(*leaves, relu=relu)
    assert y.grad_fn is not None and "_AdaIN" in type(y.grad_fn).__name__
    got = torch.autograd.grad(y, leaves, cot)
    want = tadain.adain_backward(*(t.detach() for t in leaves), cot, relu,
                                 1e-4)
    plain = torch.autograd.grad(
        tadain.adain_reference(*leaves, relu=relu), leaves, cot)
    for g, w_, p in zip(got, want, plain):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)
        torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-4)


# --- spectral norm in train form --------------------------------------------

def _sn_flat(variables):
    return _flatten(jax.device_get(dict(variables)))


@pytest.mark.parametrize("layer", ["conv", "dense", "embed"])
def test_sn_power_iteration_matches_jax(layer):
    """Two forwards with update_stats: outputs and the (u, v) state after
    each agree with the JAX layer threading its 'spectral' collection."""
    rng = np.random.RandomState(13)
    if layer == "conv":
        x = rng.standard_normal((2, 6, 6, 5)).astype(np.float32)
        jmod, tmod = jsn.SNConv(7, (3, 3), padding=1), tsn.SNConv(5, 7, 3, 1)
        tx = torch.from_numpy(x).permute(0, 3, 1, 2)
        back = lambda t: t.permute(0, 2, 3, 1)   # noqa: E731
    elif layer == "dense":
        x = rng.standard_normal((3, 9)).astype(np.float32)
        jmod, tmod = jsn.SNDense(4), tsn.SNDense(9, 4)
        tx, back = torch.from_numpy(x), (lambda t: t)
    else:
        x = np.array([2, 0, 2], np.int32)
        jmod, tmod = jsn.SNEmbed(3, 6), tsn.SNEmbed(3, 6)
        tx, back = torch.from_numpy(x).long(), (lambda t: t)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    convert.load_into(tmod, _sn_flat(variables), "")
    for _ in range(2):
        want, mut = jmod.apply(variables, jnp.asarray(x), update_stats=True,
                               mutable=["spectral"])
        variables = {**variables, "spectral": mut["spectral"]}
        got = back(tmod(tx, update_stats=True))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        flat = _sn_flat(mut)
        np.testing.assert_allclose(tmod.u.numpy(), flat["spectral::u"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tmod.v.numpy(), flat["spectral::v"],
                                   rtol=1e-5, atol=1e-6)


def test_sn_gradient_flows_through_sigma():
    """σ keeps its gradient through W (the JAX layer stops it only at u, v)."""
    rng = np.random.RandomState(14)
    x = rng.standard_normal((3, 9)).astype(np.float32)
    jmod = jsn.SNDense(4)
    variables = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))

    def jloss(params):
        out = jmod.apply({**variables, "params": params}, jnp.asarray(x))
        return (out ** 2).sum()

    want = jax.grad(jloss)(variables["params"])["kernel"]
    tmod = tsn.SNDense(9, 4)
    convert.load_into(tmod, _sn_flat(variables), "")
    (tmod(torch.from_numpy(x)) ** 2).sum().backward()
    np.testing.assert_allclose(tmod.weight.grad.numpy().T, np.asarray(want),
                               rtol=1e-4, atol=1e-5)


# --- crop_and_resize ----------------------------------------------------------

def test_crop_and_resize_matches_jax_with_gradient():
    from latentpose_tpu.ops import resample as jres
    from latentpose_tpu_torch.ops import resample as tres
    rng = np.random.RandomState(15)
    img = rng.rand(2, 18, 14, 3).astype(np.float32)
    boxes = np.array([[2.5, 15.0, 1.0, 12.5], [-3.0, 20.0, 4.0, 9.0]],
                     np.float32)
    cot = rng.standard_normal((2, 18, 14, 3)).astype(np.float32)

    def jloss(i):
        return (jres.crop_and_resize(i, jnp.asarray(boxes)) * cot).sum()

    want = jres.crop_and_resize(jnp.asarray(img), jnp.asarray(boxes))
    want_grad = jax.grad(jloss)(jnp.asarray(img))
    timg = torch.from_numpy(img).requires_grad_()
    got = tres.crop_and_resize(timg, torch.from_numpy(boxes))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(timg.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-5)


# --- RAdam as optax computes it -----------------------------------------------

@pytest.mark.parametrize("b1", [0.0, 0.5])
def test_radam_matches_optax_over_ten_steps(b1, monkeypatch):
    """Ten steps cover both of optax's branches: ρ_t < 5 (the plain,
    bias-corrected momentum step) for t <= 5 and the rectified step after.
    Gradients of the size of eps make eps's place count (torch.optim.RAdam
    puts it elsewhere); parameters start at 0 so the comparison sees the
    updates at full f32 precision.  XLA's f32 pow is 1-2 ulps off the
    correctly rounded power the port takes, which moves ρ_t by ~0.02, so
    both sides are handed XLA's powers here."""
    import optax
    from latentpose_tpu_torch.runners import optim
    from latentpose_tpu_torch.runners.optim import RAdam
    monkeypatch.setattr(optim, "_pow", lambda base, count: np.float32(
        base ** jnp.int32(count)))
    rng = np.random.RandomState(16)
    p0 = np.zeros((5, 3), np.float32)
    grads = (rng.standard_normal((10, 5, 3)) * 1e-5).astype(np.float32)
    opt = optax.radam(5e-4, b1=b1, b2=0.999, eps=1e-5)
    params = jnp.asarray(p0)
    state = opt.init(params)
    tp = torch.from_numpy(p0.copy())
    topt = RAdam([tp], 5e-4, b1=b1, b2=0.999, eps=1e-5)
    branches = set()
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        branches.add(bool(topt.schedule(topt.count + 1)[0] >= 5))
        topt.step([torch.from_numpy(g)])
        np.testing.assert_allclose(tp.numpy(), np.asarray(params),
                                   rtol=1e-5, atol=1e-10)
    assert branches == {False, True}


def test_ema_update_is_the_jax_formula():
    from latentpose_tpu_torch.runners.optim import ema_update
    rng = np.random.RandomState(17)
    a, b = rng.standard_normal((2, 6)).astype(np.float32)
    ta = torch.from_numpy(a.copy())
    ema_update([ta], [torch.from_numpy(b)], 0.972)
    want = jnp.asarray(a) * 0.972 + jnp.asarray(b) * (1.0 - 0.972)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(want))


# --- the BN -> ReLU -> 1x1 conv -> stats link under autograd ---------------

def _link_leaves(rng, m, cin, cout, dtype):
    """x (M, Cin), scale, offset (Cin,), and conv3's weight (Cout, Cin), which
    the link takes viewed as (Cin, Cout); leaves that require grad."""
    x = rng.standard_normal((m, cin)) * 2 + 0.5
    scale = rng.rand(cin) + 0.5
    offset = rng.standard_normal(cin) * 0.1
    w = rng.standard_normal((cout, cin)) / cin ** 0.5
    return [torch.tensor(a, dtype=dtype).requires_grad_()
            for a in (x, scale, offset, w)]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m,cin,cout", [(7, 5, 3), (13, 8, 6), (5, 4, 9)])
def test_conv_bn_function_gradcheck_float64(m, cin, cout, relu):
    """The autograd.Function's backward (the stats' gradient folded into
    y's, the recomputed ReLU mask) against finite differences in f64, on
    ragged shapes: through (y, stats), and through the stats alone.  The
    Function is called directly: the wrapper takes f32 and bf16 only."""
    from latentpose_tpu_torch.ops import conv_bn
    leaves = _link_leaves(np.random.RandomState(m * cin), m, cin, cout,
                          torch.float64)

    def link(x, scale, offset, w):
        return conv_bn._Link.apply(x, scale, offset, w.t(), relu)

    assert torch.autograd.gradcheck(link, leaves, eps=1e-6, atol=1e-7)
    assert torch.autograd.gradcheck(lambda *a: link(*a)[1], leaves,
                                    eps=1e-6, atol=1e-7)


@pytest.mark.parametrize("relu", [True, False])
def test_conv_bn_function_matches_autograd_through_plain(relu):
    """f32: y, stats and the gradients of x, scale, offset and conv3's
    weight (through its (Cin, Cout) view) from the Function, against
    autograd through the plain version, for cotangents on y and on the
    stats; within 1e-5 of each tensor's max |.|."""
    from latentpose_tpu_torch.ops import conv_bn
    rng = np.random.RandomState(41)
    m, cin, cout = 2 * 8 * 8, 128, 64
    cot_y = torch.from_numpy(rng.standard_normal((m, cout)).astype(np.float32))
    cot_s = torch.from_numpy(rng.standard_normal((2, cout))
                             .astype(np.float32) / m)
    results = []
    for fn in (conv_bn.bn_relu_conv1x1_stats,
               conv_bn.bn_relu_conv1x1_stats_reference):
        x, scale, offset, w = _link_leaves(np.random.RandomState(42), m, cin,
                                           cout, torch.float32)
        y, stats = fn(x, scale, offset, w.t(), relu)
        grads = torch.autograd.grad((y, stats), (x, scale, offset, w),
                                    (cot_y, cot_s))
        results.append((y, stats, *grads))
    for got, want in zip(*results):
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-5 * scale


# --- affine_resample ------------------------------------------------------------

def test_affine_resample_matches_jax_with_gradient():
    from latentpose_tpu.ops import resample as jres
    from latentpose_tpu_torch.ops import resample as tres
    rng = np.random.RandomState(43)
    img = rng.rand(3, 18, 14, 3).astype(np.float32)
    params = [np.array(v, np.float32) for v in
              ([1.0, 1.15, 0.85], [0.9, 1.0, 1.2], [0.0, 0.08, -0.1],
               [-0.06, 0.0, 0.1])]
    cot = rng.standard_normal(img.shape).astype(np.float32)

    def jloss(i):
        return (jres.affine_resample(i, *map(jnp.asarray, params))
                * cot).sum()

    want = jres.affine_resample(jnp.asarray(img), *map(jnp.asarray, params))
    want_grad = jax.grad(jloss)(jnp.asarray(img))
    timg = torch.from_numpy(img).requires_grad_()
    got = tres.affine_resample(timg, *map(torch.from_numpy, params))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(timg.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-5)


# --- augmentation: each op's apply with the JAX op's draws ------------------------

def _jax_draws(name, key, shape):
    """The draws the JAX op ``name`` takes from ``key``, split as it splits
    it, in the port's apply's keywords (per-sample values as (B,))."""
    from latentpose_tpu.data import augmentation as jaug
    r = jax.random
    b, h, w, _ = shape

    def u(k, low=0.0, high=1.0, size=None):
        return np.asarray(r.uniform(k, size or (b, 1, 1, 1), minval=low,
                                    maxval=high)).reshape(
                                        (b,) if size is None else size)

    def coin(k, p=jaug._OP_P):
        return np.asarray(r.bernoulli(k, p, (b,)))

    if name == "gaussian_blur":
        ka, kb = r.split(key)
        return dict(apply=coin(ka), alpha=u(kb))
    if name == "sharpen":
        ka, kb, kc = r.split(key, 3)
        return dict(apply=coin(ka), alpha=u(kb), lightness=u(kc, 1.0, 1.5))
    if name == "emboss":
        ka, kb, kc = r.split(key, 3)
        return dict(apply=coin(ka), alpha=u(kb), strength=u(kc) * 0.5)
    if name == "edge_detect_blobby":
        ka, kb, kc = r.split(key, 3)
        return dict(apply=coin(ka), alpha=u(kb) * 0.15,
                    mask=u(kc, size=(b, h // 8, w // 8, 1)))
    if name == "additive_noise":
        ka, kb, kc = r.split(key, 3)
        return dict(apply=coin(ka), scale=u(kb) * 0.05,
                    noise=np.asarray(r.normal(kc, shape)))
    if name == "brightness":
        ka, kb = r.split(key)
        return dict(apply=coin(ka), add=u(kb, -10.0 / 255.0, 10.0 / 255.0))
    if name == "multiply":
        ka, kb = r.split(key)
        return dict(apply=coin(ka), mul=u(kb, 0.5, 1.5))
    if name == "contrast":
        ka, kp, kc, kg = r.split(key, 4)
        return dict(apply=coin(ka), linear=coin(kp, 0.5),
                    contrast=u(kc, 0.75, 1.25), gain=u(kg, 3.0, 11.0))
    if name == "saturation":
        ka, kb = r.split(key)
        return dict(apply=coin(ka), shift=u(kb, -20.0 / 255.0, 20.0 / 255.0))
    if name == "jpeg_artifacts":
        ka, kb = r.split(key)
        return dict(apply=coin(ka), quality=u(kb, 70.0, 99.0, size=(b,)))
    ka, kb, kc = r.split(key, 3)        # elastic
    return dict(apply=coin(ka, jaug._OP_P * 0.5),
                alpha=u(kb, 0.5, 3.5, size=(b, 1, 1)).reshape(b),
                field=np.asarray(r.uniform(kc, (b, h, w, 2), minval=-1.0,
                                           maxval=1.0)))


AUG_OPS = ("gaussian_blur", "sharpen", "emboss", "edge_detect_blobby",
           "additive_noise", "brightness", "multiply", "contrast",
           "saturation", "jpeg_artifacts", "elastic")


@pytest.mark.parametrize("name", AUG_OPS)
def test_augmentation_apply_matches_jax_op(name):
    """The port's apply, given the draws the JAX op takes from its key,
    gives the JAX op's images (f32, 1e-5; JPEG's quantisation rounds a DCT
    coefficient to a step either way where the two land within rounding of
    a half, so there the image must agree to 1e-5 outside those 8x8
    blocks).  The key is the first whose coins fire on some samples and
    not on others."""
    from latentpose_tpu.data import augmentation as jaug
    from latentpose_tpu_torch.data import augmentation as taug
    shape = (8, 32, 48, 3)
    images = np.random.RandomState(44).rand(*shape).astype(np.float32)
    for seed in range(50):
        key = jax.random.PRNGKey(seed)
        draws = _jax_draws(name, key, shape)
        if 0 < draws["apply"].sum() < shape[0]:
            break
    want = np.asarray(getattr(jaug, name)(key, jnp.asarray(images)))
    op = dict((n, a) for n, _, a in taug.PIXELWISE_OPS)[name]
    got = op(torch.from_numpy(images), **{k: torch.from_numpy(np.asarray(v))
                                          for k, v in draws.items()}).numpy()
    err = np.abs(got - want)
    if name == "jpeg_artifacts":       # (sample, block row, block col, ...)
        err = err.reshape(8, 4, 8, 6, 8, 3).transpose(0, 1, 3, 2, 4, 5)
        blocks = err.max(axis=(3, 4, 5))
        assert (blocks > 1e-5).mean() <= 0.02
        err = err[blocks <= 1e-5]
    assert err.max() <= 1e-5
    untouched = ~draws["apply"]
    np.testing.assert_array_equal(got[untouched], images[untouched])


@pytest.mark.parametrize("name", AUG_OPS)
def test_augmentation_coins_fire_at_the_reference_rate(name):
    """Each op's application coin, over 4096 samples from one draw, fires
    at the SomeOf((0, 5), 11 ops) marginal 2.5/11 (elastic half that, for
    its extra ``sometimes``), within 5 binomial sigmas + 0.01 as
    tests/test_augmentation_distribution.py holds the JAX ops."""
    from latentpose_tpu_torch.data import augmentation as taug
    draw = taug.step_draw(3, 0, "cpu")
    draw_op = dict((n, d) for n, d, _ in taug.PIXELWISE_OPS)[name]
    apply = draw_op(draw, (4096, 8, 8, 3))["apply"].numpy()
    p = taug.OP_P * (0.5 if name == "elastic" else 1.0)
    sigma = np.sqrt(p * (1 - p) / len(apply))
    assert abs(apply.mean() - p) <= 5 * sigma + 0.01


def _faces(size=64):
    from latentpose_tpu_torch.data.synthetic import render_face
    return np.stack([render_face(lb, f, size)[0] for lb in range(8)
                     for f in range(8)]).astype(np.float32)


@pytest.mark.parametrize("name", ["brightness", "multiply", "additive_noise"])
def test_augmentation_moments_match_the_reference_ranges(name):
    """The closed-form moments of the reference's ranges on the samples
    where the op fired, as tests/test_augmentation_distribution.py checks
    the JAX ops: Add(-10, 10) -> E|delta| = 10/510; Multiply(0.5, 1.5) ->
    E|delta| = 0.25 E[x]; AdditiveGaussianNoise(0, 0.05 * 255) -> std
    0.05/sqrt(3)."""
    from latentpose_tpu_torch.data import augmentation as taug
    lo, hi = {"brightness": (0.1, 0.9), "multiply": (0.05, 0.6),
              "additive_noise": (0.2, 0.8)}[name]
    images = np.tile(np.clip(_faces(), lo, hi), (8, 1, 1, 1))
    draw_op, op = [(d, a) for n, d, a in taug.PIXELWISE_OPS if n == name][0]
    draws = draw_op(taug.step_draw(5, 0, "cpu"), images.shape)
    out = op(torch.from_numpy(images), **draws).numpy()
    fired = draws["apply"].numpy()
    assert fired.sum() >= 50
    delta = (out - images)[fired]
    if name == "brightness":
        assert abs(delta.mean()) <= 0.004
        np.testing.assert_allclose(np.abs(delta).mean(), 10.0 / 510.0,
                                   rtol=0.25)
    elif name == "multiply":
        mean = images[fired].mean()
        assert abs(delta.mean()) <= 0.25 * 0.15 * mean
        np.testing.assert_allclose(np.abs(delta).mean(), 0.25 * mean,
                                   rtol=0.3)
    else:
        np.testing.assert_allclose(delta.std(), 0.05 / np.sqrt(3.0),
                                   rtol=0.2)
        assert abs(delta.mean()) <= 0.002


def test_affine_coins_and_ranges():
    from latentpose_tpu_torch.data import augmentation as taug
    sx, sy, tx, ty = (t.numpy() for t in taug.sample_affine_params(
        taug.step_draw(4, 0, "cpu"), 4096, use_scale=True, use_shift=True))
    assert abs((sx != 1.0).mean() - 0.5) <= 0.05
    assert abs((tx != 0.0).mean() - 0.5) <= 0.05
    assert np.array_equal(sx != 1.0, sy != 1.0)
    assert np.array_equal(tx != 0.0, ty != 0.0)
    scaled = sx[sx != 1.0]
    assert scaled.min() >= 0.8 and scaled.max() <= 1.2
    assert np.abs(tx).max() <= 0.1 and np.abs(ty).max() <= 0.1


def test_augment_triplet_shifts_driver_target_and_segmentation_alike():
    """The shift moves the three alike; the pixelwise ops and the scale
    touch only the driver; a step's draw is a function of (seed, step)."""
    from latentpose_tpu_torch.data import augmentation as taug
    rng = np.random.RandomState(45)
    img = torch.from_numpy(rng.rand(4, 32, 32, 3).astype(np.float32))
    segm = img[..., :1].clone()
    batch = {"pose_input_rgbs": img[:, None].clone(),
             "target_rgbs": img[:, None].clone(), "real_segm": segm[:, None]}
    out = taug.augment_data_dict(batch, taug.step_draw(6, 2, "cpu"),
                                 use_shift=True)
    assert torch.equal(out["pose_input_rgbs"], out["target_rgbs"])
    assert torch.equal(out["real_segm"][..., 0], out["target_rgbs"][..., 0])
    again = taug.augment_data_dict(batch, taug.step_draw(6, 2, "cpu"),
                                   use_pixelwise=True, use_scale=True,
                                   use_shift=True)
    same = taug.augment_data_dict(batch, taug.step_draw(6, 2, "cpu"),
                                  use_pixelwise=True, use_scale=True,
                                  use_shift=True)
    assert torch.equal(again["pose_input_rgbs"], same["pose_input_rgbs"])
    assert not torch.equal(again["pose_input_rgbs"], again["target_rgbs"])
    assert taug.augment_data_dict(batch, taug.step_draw(6, 2, "cpu")) \
        is batch


# --- Adam as optax computes it ---------------------------------------------------

@pytest.mark.parametrize("scale", [1e-9, 1e-5])
@pytest.mark.parametrize("b1", [0.0, 0.9])
def test_adam_matches_optax_over_ten_steps(b1, scale, monkeypatch):
    """optax.adam(lr, b1, 0.999, eps=1e-5) over ten steps, gradients near 0
    and near eps (where eps's place decides the step); parameters start at
    0 so the comparison sees the updates at full f32 precision.  Both sides
    get XLA's f32 powers for the bias corrections (as for RAdam)."""
    import optax
    from latentpose_tpu_torch.runners import optim
    monkeypatch.setattr(optim, "_pow", lambda base, count: np.float32(
        base ** jnp.int32(count)))
    rng = np.random.RandomState(46)
    grads = (rng.standard_normal((10, 5, 3)) * scale).astype(np.float32)
    opt = optax.adam(5e-5, b1=b1, b2=0.999, eps=1e-5)
    params = jnp.zeros((5, 3), jnp.float32)
    state = opt.init(params)
    tp = torch.zeros(5, 3)
    topt = optim.Adam([tp], 5e-5, b1=b1, b2=0.999, eps=1e-5)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        topt.step([torch.from_numpy(g)])
        np.testing.assert_allclose(tp.numpy(), np.asarray(params), rtol=1e-5,
                                   atol=1e-10)
        np.testing.assert_allclose(topt.mu[0].numpy(),
                                   np.asarray(state[0].mu), rtol=1e-6)
        np.testing.assert_allclose(topt.nu[0].numpy(),
                                   np.asarray(state[0].nu), rtol=1e-6)
    assert topt.count == int(state[0].count) == 10
