"""PyTorch port, models: ResBlock, generator and MobileNetV2 pose encoder
held against the JAX modules with the same weights (JAX init, converted)
and the same numpy inputs, in f32 on the CPU."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from latentpose_tpu.checkpoint import _flatten
from latentpose_tpu.models.generators import (
    vector_pose_unsupervised_segmentation_noBottleneck as jgen_mod)
from latentpose_tpu.nn import backbones as jbackbones
from latentpose_tpu.nn import blocks as jblocks
from latentpose_tpu_torch import convert
from latentpose_tpu_torch.models.generators import (
    vector_pose_unsupervised_segmentation_noBottleneck as tgen_mod)
from latentpose_tpu_torch.nn import backbones as tbackbones
from latentpose_tpu_torch.nn import blocks as tblocks

torch.set_num_threads(1)

# f32 on the CPU; sums run in another order than XLA's, and the JAX up path
# goes through the polyphase conv + s2d AdaIN where the port upsamples first
TOL = dict(rtol=1e-4, atol=1e-4)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("norm,up,down,padding", [
    ("adain", True, False, "zero"),
    ("adain", False, False, "zero"),
    ("in", False, True, "reflection"),
    ("none", True, False, "zero"),
])
def test_resblock_matches_jax(norm, up, down, padding):
    cin, cout = 8, (8 if not (up or down) else 4)
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 6, 6, cin)).astype(np.float32)
    ada = [tuple(rng.standard_normal((2, c)).astype(np.float32)
                 for _ in range(2)) for c in (cin, cout)]
    jblock = jblocks.ResBlock(cin, cout, norm_layer=norm, upsample=up,
                              downsample=down, padding=padding)
    jada = [tuple(map(jnp.asarray, a)) for a in ada] if norm == "adain" \
        else [None, None]
    variables = jax.jit(jblock.init)(jax.random.PRNGKey(1), jnp.asarray(x),
                                      *jada)
    if norm == "in":   # non-trivial affine
        variables = jax.tree_util.tree_map(
            lambda v: v + 0.3 * jnp.sin(jnp.arange(v.size).reshape(v.shape)),
            variables)
    want = np.asarray(jax.jit(jblock.apply)(variables, jnp.asarray(x),
                                            *jada))

    tblock = tblocks.ResBlock(cin, cout, norm_layer=norm, upsample=up,
                              downsample=down, padding=padding)
    convert.load_into(tblock, _flatten(dict(variables)), "")
    tada = [tuple(map(torch.from_numpy, a)) for a in ada] \
        if norm == "adain" else [None, None]
    got = tblock(_nchw(x), *tada)
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


TINY = dict(num_channels=4, max_num_channels=16, identity_embedding_size=16,
            pose_embedding_size=8, num_residual_blocks=1,
            output_image_size=16)
FLAGSHIP = dict(num_channels=64, max_num_channels=512,
                identity_embedding_size=512, pose_embedding_size=256,
                num_residual_blocks=2, output_image_size=256)


def test_generator_matches_jax_tiny():
    rng = np.random.RandomState(2)
    embeds = rng.standard_normal((2, 16)).astype(np.float32)
    pose = rng.standard_normal((2, 8)).astype(np.float32)
    jgen = jgen_mod.Generator(**TINY)
    inputs = {"embeds": jnp.asarray(embeds), "pose_embedding": jnp.asarray(pose)}
    variables = jax.jit(jgen.init)(jax.random.PRNGKey(3), inputs)
    want_rgb, want_segm = jax.jit(jgen.apply)(variables, inputs)

    tgen = tgen_mod.Generator(**TINY)
    convert.load_into(tgen, _flatten(dict(variables)), "")
    with torch.no_grad():
        rgb, segm = tgen(torch.from_numpy(embeds), torch.from_numpy(pose))
    assert rgb.shape == (2, 16, 16, 3) and segm.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), **TOL)
    np.testing.assert_allclose(segm.numpy(), np.asarray(want_segm), **TOL)


def test_generator_schedule_matches_jax_at_flagship_width():
    jgen = jgen_mod.Generator(**FLAGSHIP)
    tgen = tgen_mod.Generator(**FLAGSHIP)
    assert tgen._schedule() == jgen._schedule()
    assert tgen.num_affine_params() == jgen.num_affine_params()
    # 17 AdaINs per frame, and the projector emits one (bias, weight) each
    assert len(tgen.adain_features) == 17
    assert tgen.projector_1.weight.shape == (jgen.num_affine_params(), 768)


def test_mobilenetv2_pose_encoder_matches_jax_full_width():
    x = np.random.RandomState(4).rand(2, 32, 32, 3).astype(np.float32)
    jnet = jbackbones.MobileNetV2(num_classes=256)
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(5), jnp.asarray(x))
    # non-trivial running statistics and affine, so eval-mode BN is tested
    rng = np.random.RandomState(6)
    stats = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(-0.1, 0.1, v.shape)
        .astype(np.float32), variables["params"])
    variables = {"params": params, "batch_stats": stats}
    want = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(x)))

    tnet = tbackbones.MobileNetV2(num_classes=256)
    convert.load_into(tnet, _flatten(variables), "")
    with torch.no_grad():
        got = tnet(_nchw(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
