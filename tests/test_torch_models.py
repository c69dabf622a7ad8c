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


# --- the fine-tune slice: identity tower, train-mode pose BN, discriminator --

def _jitter_variables(variables, seed):
    """Non-trivial running statistics (so eval-mode BN is tested) and
    weights moved off their init."""
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(-0.05, 0.05, v.shape)
        .astype(np.float32), variables["params"])
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def embedders():
    """The flagship embedder at full width (ResNeXt-50 + MobileNetV2), JAX
    init (jitted), jittered, converted into the port's module."""
    from latentpose_tpu.models.embedders import (
        unsupervised_pose_separate_embResNeXt_segmentation as jemb_mod)
    from latentpose_tpu_torch.models.embedders import (
        unsupervised_pose_separate_embResNeXt_segmentation as temb_mod)
    jemb = jemb_mod.Embedder(identity_embedding_size=512,
                             pose_embedding_size=256)
    frames = jnp.zeros((1, 1, 32, 32, 3))
    variables = _jitter_variables(
        jax.jit(jemb.init)(jax.random.PRNGKey(7), frames, frames), seed=8)
    temb = temb_mod.Embedder(identity_embedding_size=512,
                             pose_embedding_size=256)
    convert.load_into(temb, _flatten(variables), "")
    return jemb, variables, temb


@pytest.mark.parametrize("average", ["sum", "max"])
def test_identity_embedding_matches_jax_full_width(embedders, average):
    """ResNeXt-50 in eval form (its 16 bn2 -> ReLU -> conv3 links through
    the fused kernel's plain version) and the mean / max over K frames, on
    32² frames; f32, 1e-4."""
    from latentpose_tpu_torch.ops import conv_bn
    jemb, variables, temb = embedders
    jemb = jemb.clone(average_function=average)
    temb.average_function = average
    enc = np.random.RandomState(9).rand(2, 3, 32, 32, 3).astype(np.float32)
    want_agg, want_elem = jax.jit(lambda v, x: jemb.apply(
        v, x, method="get_identity_embedding"))(variables, jnp.asarray(enc))
    calls = []
    real = conv_bn.bn_relu_conv1x1_stats
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr("latentpose_tpu_torch.nn.backbones.bn_relu_conv1x1_stats",
                   lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
        agg, elem = temb.get_identity_embedding(torch.from_numpy(enc))
    assert len(calls) == 16            # one per bottleneck
    assert elem.shape == (2, 3, 512) and agg.shape == (2, 512)
    np.testing.assert_allclose(elem.numpy(), np.asarray(want_elem), **TOL)
    np.testing.assert_allclose(agg.numpy(), np.asarray(want_agg), **TOL)


def test_pose_encoder_train_mode_batch_norm_matches_jax(embedders):
    """Train-mode BatchNorm: the updated running statistics (flax momentum
    0.9, biased batch variance) equal the JAX module's.  They are computed
    before the dropout, whose masks cannot match across frameworks.
    Tolerance 1e-3 relative: the deepest blocks see 2x2 maps, and the
    one-pass variance over 16 values per channel, 17 train-mode blocks
    deep, magnifies f32 summation-order differences to ~2e-4."""
    jemb, variables, temb = embedders
    pose = np.random.RandomState(10).rand(4, 1, 32, 32, 3).astype(np.float32)
    _, mut = jax.jit(lambda v, x: jemb.apply(
        v, x, train=True, method="get_pose_embedding",
        rngs={"dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats"]))(variables, jnp.asarray(pose))
    with torch.no_grad():
        out = temb.get_pose_embedding(torch.from_numpy(pose), train=True,
                                      dropout_generator=torch.Generator()
                                      .manual_seed(0))
    assert out.shape == (4, 256) and torch.isfinite(out).all()
    want = _flatten({"batch_stats": mut["batch_stats"]})
    got = convert.export(temb, "", params=())
    pose_keys = [k for k in want if "pose_encoder" in k]
    assert len(pose_keys) == 2 * 52       # 52 BatchNorms, mean and var each
    for key in pose_keys:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-5,
                                   err_msg=key)
    # the identity tower did not run, so its statistics did not move
    for key in (k for k in want if "identity_encoder" in k):
        np.testing.assert_array_equal(got[key], want[key])
    # restore the eval-mode statistics for the other tests of this module
    convert.load_into(temb, _flatten(variables), "")


def test_discriminator_matches_jax_with_power_iterations():
    """The embedding lookup and two passes with update_stats: scores,
    every feature map (the ReLU'd aliases included), and the spectral state
    after each; f32, tiny widths."""
    from latentpose_tpu.models.discriminators import no_landmarks as jdis_mod
    from latentpose_tpu_torch.models.discriminators import (
        no_landmarks as tdis_mod)
    kw = dict(num_channels=4, max_num_channels=16, embed_channels=16,
              num_blocks=3, image_size=16, num_labels=4)
    jdis = jdis_mod.Discriminator(**kw)
    rng = np.random.RandomState(11)
    x = rng.rand(2, 16, 16, 3).astype(np.float32)
    labels = np.array([3, 1], np.int32)
    variables = jax.jit(jdis.init)(jax.random.PRNGKey(12), jnp.asarray(x),
                                   jnp.asarray(labels))
    tdis = tdis_mod.Discriminator(**kw)
    convert.load_into(tdis, _flatten(dict(variables)), "")
    assert tdis_mod.plan(4, 16, 16, 3, 16) == jdis._plan()

    rows, mut = jdis.apply(variables, jnp.asarray(labels), update_stats=True,
                           method="embed_labels", mutable=["spectral"])
    spectral = mut["spectral"]
    trows = tdis.embed_labels(torch.from_numpy(labels).long(),
                              update_stats=True)
    np.testing.assert_allclose(trows.detach().numpy(), np.asarray(rows),
                               **TOL)
    for _ in range(2):
        (score, feats), mut = jdis.apply(
            {"params": variables["params"], "spectral": spectral},
            jnp.asarray(x), rows, update_stats=True, method="pass_inputs",
            mutable=["spectral"])
        spectral = mut["spectral"]
        tscore, tfeats = tdis.pass_inputs(torch.from_numpy(x), trows,
                                          update_stats=True)
        np.testing.assert_allclose(tscore.detach().numpy(),
                                   np.asarray(score), **TOL)
        assert len(tfeats) == len(feats) == 3       # stem + 2 blocks
        for f, tf in zip(feats, tfeats):
            np.testing.assert_allclose(_nhwc(tf), np.asarray(f), **TOL)
    want = _flatten({"spectral": spectral})
    got = convert.export(tdis, "", params=())
    assert set(want) <= set(got)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)


# --- the meta-train slice: ResNeXt-50 in train form -------------------------

def _train_form_grads(net, variables, x, cot):
    """The JAX module's train-form output, parameter gradients of
    sum(out * cot) and updated batch_stats, in f64."""
    with jax.enable_x64(True):
        f64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)

        def loss(params):
            out, mut = net.apply({"params": params,
                                  "batch_stats": f64["batch_stats"]},
                                 jnp.asarray(x, jnp.float64), train=True,
                                 mutable=["batch_stats"])
            return (out * jnp.asarray(cot, jnp.float64)).sum(), (out, mut)

        (_, (out, mut)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(f64["params"])
        return (np.asarray(out), _flatten({"params": grads}),
                _flatten({"batch_stats": mut["batch_stats"]}))


def test_resnext50_train_form_matches_jax():
    """ResNeXt-50 in train form (bn1 and the downsample in flax's train
    BatchNorm, bn2 folded from its batch statistics into the link's scale
    and offset, bn3 from the link's (Σy, Σy²), momentum 0.9 and the biased
    variance) against the JAX module: the output, every parameter's
    gradient of a seeded scalar loss, and the updated batch_stats; 4 frames
    of 64², one bottleneck a stage (``layers`` (1, 1, 1, 1), each of the
    four link shapes; weights 0.05 off their init).  The reference is the
    JAX module in f64: a network of train-mode BatchNorms amplifies rounding
    at every block, how much depends on its weights, and here the JAX
    module's own f32 gradients sit far off its f64 ones
    (``tools/train_bn_conditioning.py`` prints both packages' f32 errors).
    The port in f32: the output to 1e-4 relative, each gradient and
    statistic to 3e-5 of the leaf's largest |value| (1e-5 measured)."""
    layers = (1, 1, 1, 1)
    rng = np.random.RandomState(50)
    x = rng.rand(4, 64, 64, 3).astype(np.float32)
    cot = rng.standard_normal((4, 16)).astype(np.float32)
    jnet = jbackbones.ResNeXt50(num_classes=16, layers=layers)
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(51), jnp.asarray(x))
    jitter = np.random.RandomState(52)
    variables = {"params": jax.tree_util.tree_map(
        lambda v: np.asarray(v) + jitter.uniform(-0.05, 0.05, v.shape)
        .astype(np.float32), variables["params"]),
        "batch_stats": variables["batch_stats"]}
    want_out, want_grads, want_stats = _train_form_grads(jnet, variables, x,
                                                         cot)
    tnet = tbackbones.ResNeXt50(num_classes=16, layers=layers)
    convert.load_into(tnet, _flatten(variables), "")
    out = tnet(_nchw(x), train=True)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-4,
                               atol=1e-4 * np.abs(want_out).max())
    params = dict(tnet.named_parameters())
    rules = [r for r in convert._rules(tnet) if r[1] == "params"]
    assert len(rules) == len(want_grads) == len(params)
    for tkey, _, leaf, (_, to_jax) in rules:
        got = params[tkey].grad.numpy()
        got = got.transpose(to_jax) if to_jax is not None else got
        want = want_grads[f"params::{leaf}"]
        assert np.abs(got - want).max() <= 3e-5 * np.abs(want).max(), leaf
    got_stats = convert.export(tnet, "", params=())
    assert set(got_stats) == set(want_stats)
    for key, want in want_stats.items():
        assert np.abs(got_stats[key] - want).max() \
            <= 3e-5 * np.abs(want).max(), key


def test_resnext50_train_form_runs_its_links_through_the_kernel_wrapper():
    """At full depth the train form calls the fused link 16 times a forward
    and takes bn3's batch statistics from its (Σy, Σy²): the running mean
    moves to 0.9 old + 0.1 Σy/M; the eval form stays as it was."""
    from latentpose_tpu_torch.ops import conv_bn
    tnet = tbackbones.ResNeXt50(num_classes=16,
                                generator=torch.Generator().manual_seed(53))
    x = torch.from_numpy(np.random.RandomState(54).rand(2, 3, 32, 32)
                         .astype(np.float32))
    calls = []
    real = conv_bn.bn_relu_conv1x1_stats
    before = tnet.layer1_0.bn3.running_mean.clone()

    def spy(*a, **k):
        y, stats = real(*a, **k)
        calls.append(stats.detach().clone())
        return y, stats

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("latentpose_tpu_torch.nn.backbones.bn_relu_conv1x1_stats",
                   spy)
        eval_out = tnet(x).detach()
        assert len(calls) == 16
        tnet(x, train=True).sum().backward()
    assert len(calls) == 32
    rows = 2 * 8 * 8                       # layer1: 8x8 maps at 32²
    np.testing.assert_allclose(tnet.layer1_0.bn3.running_mean.numpy(),
                               (0.9 * before + 0.1 * calls[16][0] / rows)
                               .numpy(), rtol=1e-6, atol=1e-7)
    assert tnet.conv1.weight.grad is not None
    assert tnet.layer4_2.conv3.weight.grad.abs().sum() > 0
    with torch.no_grad():
        for mod in tnet.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.zeros_like(mod.running_mean))
                mod.running_var.copy_(torch.ones_like(mod.running_var))
        assert torch.isfinite(tnet(x)).all() and eval_out.shape == (2, 16)
