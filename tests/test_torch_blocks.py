"""PyTorch port, the block library's variants (``latentpose_tpu_torch/nn/
blocks.py``): ``channel_shuffle``, ``ShuffleConv``, ``ResBlockShuffle``,
``ResBlockV2``, ``ResBlockV2Shuffle``, ``ResBlockNoSpectralNorm``,
``GatedBlock``, ``GatedResBlock``, ``MobileNetBlock`` and
``SelfAttention``, each held against the JAX module of the same name with
the same weights (seeded, converted by ``convert.load_into``) and the same numpy inputs, for each
``norm_layer`` it takes, in f32 on the CPU: within 1e-4 of the JAX output's
max.  Small widths; the JAX modules run eagerly (no step compile)."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import flax.linen as fnn

from latentpose_tpu.checkpoint import _flatten
from latentpose_tpu.nn import blocks as jblocks
from latentpose_tpu_torch import convert
from latentpose_tpu_torch.nn import blocks as tblocks

torch.set_num_threads(1)

RTOL = 1e-4     # of the JAX output's max
BATCH, SIDE = 2, 6


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _variables(jmod, x, *ada):
    """The JAX module's variables, filled from a seed (``jax.eval_shape``
    of its init, no compile): kernels normal over the root of their fan-in,
    every bias 0.1 sin(k), instance-norm weights 1 + 0.1 sin(k), ``gamma``
    0.1, and each spectral (u, v) one power iteration from a random u on
    its kernel (so that σ sits near the largest singular value).

    Biases stay small: both packages take an instance norm's variance in
    one pass in f32 (E[x²] − E[x]²), which cancels where a channel's mean
    is many times its spread.  With the init's biases (up to ±0.7 on the
    shuffle convs' 1x1s, whose fan-in is 2) a channel's mean reached 46
    times its spread, and there the JAX package's variance sat 3.5e-3 from
    the exact one on the same input (the port's 8.6e-4): the comparison
    then measures that cancellation, not the port."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x, *ada)
    rng = np.random.RandomState(zlib.crc32(repr(jmod).encode()))
    wave = lambda shape: 0.1 * np.sin(np.arange(1, np.prod(shape) + 1)
                                      ).reshape(shape).astype(np.float32)

    def param(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(leaf.shape)
                    / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return wave(leaf.shape) + (name == "weight")

    params = jax.tree_util.tree_map_with_path(param, shapes["params"])
    variables = {"params": params}
    if "spectral" in shapes:
        flat = _flatten({"params": params})

        def spectral(path, leaf):
            keys = [p.key for p in path]
            kernel = flat["::".join(["params", *keys[:-1], "kernel"])]
            w2d = kernel.transpose(3, 2, 0, 1).reshape(kernel.shape[3], -1)
            u = np.random.RandomState(len(keys)).standard_normal(
                w2d.shape[0])
            v = w2d.T @ u / np.linalg.norm(w2d.T @ u)
            u = w2d @ v / np.linalg.norm(w2d @ v)
            return (u if keys[-1] == "u" else v).astype(np.float32)

        variables["spectral"] = jax.tree_util.tree_map_with_path(
            spectral, shapes["spectral"])
    return variables


def _ada(rng, features, norm):
    if norm != "adain":
        return None
    return tuple(rng.standard_normal((BATCH, features)).astype(np.float32)
                 for _ in range(2))


def _check(jmod, tmod, x, *ada, update_stats=False):
    """Init ``jmod`` on x, load its moved variables into ``tmod``, and hold
    the two outputs (and, with ``update_stats``, the power iterations'
    (u, v)) together."""
    jada = [None if a is None else tuple(map(jnp.asarray, a)) for a in ada]
    variables = _variables(jmod, jnp.asarray(x), *jada)
    convert.load_into(tmod, _flatten(dict(variables)), "")
    tada = [None if a is None else tuple(map(torch.from_numpy, a))
            for a in ada]
    if update_stats:
        want, mutated = jmod.apply(variables, jnp.asarray(x), *jada,
                                   update_stats=True, mutable=["spectral"])
    else:
        want = jmod.apply(variables, jnp.asarray(x), *jada)
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x), *tada, update_stats=update_stats))
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= RTOL, err
    if update_stats:
        flat = _flatten({"spectral": mutated["spectral"]})
        for name, mod in tmod.named_modules():
            if hasattr(mod, "u"):
                key = "::".join(["spectral", *name.split("."), "u"])
                np.testing.assert_allclose(mod.u.numpy(), flat[key],
                                           atol=1e-5)


def _input(seed, cin, side=SIDE):
    return np.random.RandomState(seed).standard_normal(
        (BATCH, side, side, cin)).astype(np.float32)


def test_channel_shuffle_permutes_as_the_jax_package():
    x = _input(0, 12)
    want = np.asarray(jblocks.channel_shuffle(jnp.asarray(x), 4))
    got = _nhwc(tblocks.channel_shuffle(_nchw(x), 4))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, x)


@pytest.mark.parametrize("cin,cout", [(8, 12), (6, 8)])
def test_shuffle_conv_matches_jax(cin, cout):
    """Grouped (both widths divide 4) and the one-conv fallback."""
    _check(jblocks.ShuffleConv(cin, cout), tblocks.ShuffleConv(cin, cout),
           _input(1, cin))


NORMS = ["none", "in", "adain"]
# (in, out, upsample, downsample): a block without a skip, and with an
# up or a down resize (each with a skip)
RESIZES = {"same": (16, 16, False, False), "up": (16, 8, True, False),
           "down": (16, 24, False, True)}


def _resize_args(resize, v2):
    cin, cout, up, down = RESIZES[resize]
    if v2:
        layer = "nearest" if up else "avgpool" if down else "none"
        return cin, cout, dict(resize_layer=layer)
    return cin, cout, dict(upsample=up, downsample=down)


BLOCKS = {"ResBlockShuffle": False, "ResBlockV2": True,
          "ResBlockV2Shuffle": True, "ResBlockNoSpectralNorm": False,
          "GatedResBlock": False}


@pytest.mark.parametrize("resize", sorted(RESIZES))
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_residual_variant_matches_jax(block, norm, resize):
    cin, cout, kw = _resize_args(resize, BLOCKS[block])
    rng = np.random.RandomState(zlib.crc32(f"{block}{norm}{resize}".encode()))
    x = rng.standard_normal((BATCH, SIDE, SIDE, cin)).astype(np.float32)
    ada = [_ada(rng, cin, norm), _ada(rng, cout, norm)]
    jmod = getattr(jblocks, block)(cin, cout, norm_layer=norm, **kw)
    tmod = getattr(tblocks, block)(cin, cout, norm_layer=norm, **kw)
    _check(jmod, tmod, x, *ada)


@pytest.mark.parametrize("norm", NORMS)
def test_resblock_v2_with_another_activation_matches_jax(norm):
    """ReLU6 after each norm: the norm's kernel call without its ReLU."""
    rng = np.random.RandomState(3)
    x = rng.standard_normal((BATCH, SIDE, SIDE, 8)).astype(np.float32) * 3
    ada = [_ada(rng, 8, norm), _ada(rng, 4, norm)]
    for v2 in ("ResBlockV2", "ResBlockV2Shuffle"):
        _check(getattr(jblocks, v2)(8, 4, "nearest", norm, fnn.relu6),
               getattr(tblocks, v2)(8, 4, "nearest", norm, F.relu6), x, *ada)


def test_gated_resblock_reflection_padding_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.standard_normal((BATCH, SIDE, SIDE, 8)).astype(np.float32)
    ada = [_ada(rng, 8, "adain"), _ada(rng, 4, "adain")]
    _check(jblocks.GatedResBlock(8, 4, "adain", padding="reflection"),
           tblocks.GatedResBlock(8, 4, "adain", padding="reflection"), x,
           *ada)


def test_gated_block_normalises_each_conv_by_its_own_sigma():
    """One power iteration on each of the two convs, as the JAX module's
    two spectral states advance (not one σ for the 2C outputs)."""
    _check(jblocks.GatedBlock(4, (3, 3), padding=1),
           tblocks.GatedBlock(8, 4, 3, padding=1), _input(5, 8),
           update_stats=True)


@pytest.mark.parametrize("resize", sorted(RESIZES))
@pytest.mark.parametrize("norm", NORMS)
def test_mobilenet_block_matches_jax(norm, resize):
    cin, cout, kw = _resize_args(resize, False)
    rng = np.random.RandomState(6)
    x = rng.standard_normal((BATCH, SIDE, SIDE, cin)).astype(np.float32)
    _check(jblocks.MobileNetBlock(cin, cout, norm, expansion=2, **kw),
           tblocks.MobileNetBlock(cin, cout, norm, expansion=2, **kw), x,
           _ada(rng, cout, norm))


def test_self_attention_matches_jax():
    _check(jblocks.SelfAttention(16), tblocks.SelfAttention(16),
           _input(7, 16))


def test_adain_variants_call_the_adain_operator(monkeypatch):
    """With 'adain' each variant's norms run through the operator that the
    card's kernel implements (``ops/adain.py``), as ``ResBlock``'s do."""
    calls = []
    real = tblocks.adain

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tblocks, "adain", counted)
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.standard_normal((BATCH, 8, SIDE, SIDE))
                         .astype(np.float32))
    ada = [tuple(torch.randn(BATCH, c) for _ in range(2)) for c in (8, 4)]
    want = {"ResBlockShuffle": 2, "ResBlockV2": 2, "ResBlockV2Shuffle": 2,
            "ResBlockNoSpectralNorm": 2, "GatedResBlock": 2}
    for name, count in want.items():
        calls.clear()
        v2 = BLOCKS[name]
        kw = dict(resize_layer="nearest") if v2 else dict(upsample=True)
        getattr(tblocks, name)(8, 4, norm_layer="adain", **kw)(x, *ada)
        assert len(calls) == count, name
    calls.clear()
    tblocks.MobileNetBlock(8, 4, "adain", expansion=2)(x, ada[1])
    assert len(calls) == 3      # norm0, norm1 (shared affine) and ada2
