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


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("hw,c", FLAGSHIP_HWC)
@pytest.mark.parametrize("batch", [1, 8, 32])
def test_chunk_plan_covers_every_pixel(batch, hw, c, itemsize):
    chunk_pixels, chunks = tadain.plan_chunks(batch, hw, c, itemsize)
    rows = tadain.THREADS // (c // (16 // itemsize))
    assert chunk_pixels % rows == 0
    assert (chunks - 1) * chunk_pixels < hw <= chunks * chunk_pixels
    # enough blocks to fill the card wherever the tensor has the pixels
    assert batch * chunks >= min(tadain.TARGET_BLOCKS, batch * hw // rows) // 2


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
