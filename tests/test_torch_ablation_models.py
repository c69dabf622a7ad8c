"""PyTorch port, the second half of the ablation families' modules held
against the JAX package on the CPU: X2Face's warp (``grid_sample_bilinear``
on grids inside and outside [-1, 1]), the UNet, the X2Face embedder and
generator, the FAb-Net encoder, the two pretrained-pose embedders,
``simple_conv``, ``no_pose_encoder``, the ``none`` discriminator, the
relativistic adversarial losses (rgan, ragan) and ``overlay_pretrained``
on a fabricated weights file.

Each JAX module's variables are filled from their shapes and a seed
(``jax.eval_shape``, not compiled; BatchNorm variances positive), then
reach the port's module through ``convert.load_into`` (the checkpoint
bridge).  Forwards agree within 1e-4
of the output's max; the losses within 1e-6.  The ResNeXt-50 identity
towers are cut to one bottleneck a stage in both packages (their full
depth is held in ``tests/test_torch_models.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from latentpose_tpu.checkpoint import _flatten
from latentpose_tpu.losses import adversarial as jadv
from latentpose_tpu.models.discriminators import none as jnone
from latentpose_tpu.models.embedders import FAbNet_pretrained_embResNeXt \
    as jfab
from latentpose_tpu.models.embedders import X2Face as jx2e
from latentpose_tpu.models.embedders import X2Face_pretrained_embResNeXt \
    as jx2p
from latentpose_tpu.models.embedders import no_pose_encoder as jnopose
from latentpose_tpu.models.embedders import simple_conv as jsimple
from latentpose_tpu.models.generators import X2Face as jx2g
from latentpose_tpu.nn import backbones as jbackbones
from latentpose_tpu.nn import unet as junet
from latentpose_tpu.ops import image as jimage
from latentpose_tpu.runners import build as jbuild
from latentpose_tpu_torch import convert
from latentpose_tpu_torch.losses import adversarial as tadv
from latentpose_tpu_torch.models.discriminators import none as tnone
from latentpose_tpu_torch.models.embedders import \
    FAbNet_pretrained_embResNeXt as tfab
from latentpose_tpu_torch.models.embedders import \
    unsupervised_pose_separate_embResNeXt_segmentation as tflagship
from latentpose_tpu_torch.models.embedders import X2Face as tx2e
from latentpose_tpu_torch.models.embedders import \
    X2Face_pretrained_embResNeXt as tx2p
from latentpose_tpu_torch.models.embedders import no_pose_encoder as tnopose
from latentpose_tpu_torch.models.embedders import simple_conv as tsimple
from latentpose_tpu_torch.models.generators import X2Face as tx2g
from latentpose_tpu_torch.nn import backbones as tbackbones
from latentpose_tpu_torch.nn import unet as tunet
from latentpose_tpu_torch.ops import image as timage
from latentpose_tpu_torch.runners import build as tbuild

torch.set_num_threads(1)

RTOL = 1e-4             # of the output's max
LOSS_RTOL = 1e-6
B, K, IMG = 2, 2, 32
LAYERS = (1, 1, 1, 1)   # ResNeXt-50 cut to one bottleneck a stage


@pytest.fixture(scope="module", autouse=True)
def _shallow_resnext():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jfab, jx2p):
            mp.setattr(mod, "ResNeXt50", functools.partial(
                jbackbones.ResNeXt50, layers=LAYERS))
        mp.setattr(tflagship, "ResNeXt50", functools.partial(
            tbackbones.ResNeXt50, layers=LAYERS))
        yield


def _init(module, *args, seed=0):
    """``module``'s variables from their shapes and a seeded fill: kernels
    U(±1/sqrt(fan_in)), BatchNorm scales 1 ± 0.1, variances U(0.5, 1.5),
    the rest 0.1 x normal."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            value = rng.uniform(-bound, bound, shape)
        elif name == "scale":
            value = 1.0 + rng.uniform(-0.1, 0.1, shape)
        elif name == "var":
            value = rng.uniform(0.5, 1.5, shape)
        else:
            value = 0.1 * rng.standard_normal(shape)
        return value.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(module.init, jax.random.PRNGKey(0), *args))
    return _flatten(serialization.to_state_dict(variables))


def _tree(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("::")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


def _port(module, flat, part="model"):
    """``module`` loaded with the JAX flat arrays ``flat``."""
    convert.load_into(module, {
        f"{k.split('::')[0]}::{part}::{k.split('::', 1)[1]}": v
        for k, v in flat.items()}, part)
    return module.eval()


def _apply(module, flat, *args, method=None, **kwargs):
    def run(variables, *a):
        return module.apply(variables, *a, method=method, **kwargs)
    return jax.jit(run)(_tree(flat), *args)


def _close(got, want, what="", rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= rtol, (what, err)


def _frames(seed, shape):
    return np.random.RandomState(seed).uniform(0, 1, shape).astype(np.float32)


# --- grid_sample -----------------------------------------------------------

_GRID_SHAPES = ((1, 5, 7, 3, 4), (2, 8, 8, 6, 5), (1, 3, 1, 2, 9))


@functools.lru_cache(maxsize=None)
def _jax_grid_sample(shape):
    return jax.jit(jimage.grid_sample_bilinear)


@settings(max_examples=40, deadline=None)
@given(shape=st.sampled_from(_GRID_SHAPES), seed=st.integers(0, 2 ** 31 - 1),
       reach=st.sampled_from([1.0, 1.5, 4.0, 9.0]))
def test_grid_sample_matches_jax(shape, seed, reach):
    """Bilinear, reflection, align_corners=False on grids reaching ``reach``
    times the image's span: the JAX function folds with ``jnp.mod`` and
    clips, the port calls ``F.grid_sample``."""
    b, h, w, ho, wo = shape
    rng = np.random.RandomState(seed)
    images = rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    gx = rng.uniform(-reach, reach, (b, ho, wo)).astype(np.float32)
    gy = rng.uniform(-reach, reach, (b, ho, wo)).astype(np.float32)
    gx.flat[:3] = (-1.0, 1.0, 3.0)[:gx.size]     # the border and a fold
    want = _jax_grid_sample(shape)(images, gx, gy)
    got = timage.grid_sample_bilinear(
        torch.from_numpy(images).permute(0, 3, 1, 2), torch.from_numpy(gx),
        torch.from_numpy(gy)).permute(0, 2, 3, 1)
    _close(got, want, "grid_sample")


def test_grid_sample_gradient_matches_jax():
    """The warp's gradient w.r.t. the image and the grid (X2Face's driving
    UNet learns through the grid), inside and outside [-1, 1]."""
    rng = np.random.RandomState(3)
    images = rng.uniform(-1, 1, (2, 6, 5, 3)).astype(np.float32)
    gx = rng.uniform(-2.5, 2.5, (2, 4, 4)).astype(np.float32)
    gy = rng.uniform(-2.5, 2.5, (2, 4, 4)).astype(np.float32)
    weights = rng.normal(0, 1, (2, 4, 4, 3)).astype(np.float32)

    def loss(img, x, y):
        return (jimage.grid_sample_bilinear(img, x, y) * weights).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(images, gx, gy)
    img_t, gx_t, gy_t = (torch.from_numpy(a).requires_grad_()
                         for a in (images, gx, gy))
    out = timage.grid_sample_bilinear(img_t.permute(0, 3, 1, 2), gx_t, gy_t)
    (out.permute(0, 2, 3, 1) * torch.from_numpy(weights)).sum().backward()
    for got, w, name in zip((img_t.grad, gx_t.grad, gy_t.grad), want,
                            ("image", "grid_x", "grid_y")):
        _close(got, w, name)


# --- UNet and the X2Face modules --------------------------------------------

def test_unet_matches_jax():
    x = _frames(0, (B, IMG, IMG, 3))
    jm = junet.UNet(out_features=2)
    flat = _init(jm, x, seed=1)
    tm = _port(tunet.UNet(2), flat)
    want, want_bottleneck = _apply(jm, flat, x, return_bottleneck=True)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    got, got_bottleneck = tm(nchw, return_bottleneck=True)
    _close(got.permute(0, 2, 3, 1), want, "out")
    _close(got_bottleneck.permute(0, 2, 3, 1), want_bottleneck, "bottleneck")
    _close(tm.bottleneck(nchw).permute(0, 2, 3, 1), want_bottleneck,
           "bottleneck alone")
    assert sorted(n for n, _ in tm.named_children()) == sorted(
        k.split("::")[1] for k in flat if k.endswith("::kernel"))


@pytest.fixture(scope="module")
def x2face():
    enc = _frames(1, (B, K, IMG, IMG, 3))
    driver = _frames(2, (B, 1, IMG, IMG, 3))
    jm = jx2g.Generator()
    inputs = {"enc_rgbs": enc, "pose_input_rgbs": driver}
    flat = _init(jm, inputs, seed=2)
    return jm, flat, _port(tx2g.Generator(), flat), inputs


def test_x2face_generator_matches_jax(x2face):
    jm, flat, tm, inputs = x2face
    want, want_segm = _apply(jm, flat, inputs)
    got, got_segm = tm(torch.from_numpy(inputs["enc_rgbs"]),
                       torch.from_numpy(inputs["pose_input_rgbs"]))
    assert want_segm is None and got_segm is None
    _close(got, want, "warped")
    assert tm.FINETUNE_PARAM == jm.FINETUNE_PARAM == "none"
    assert tm.PRETRAINED == jm.PRETRAINED


def test_x2face_generator_pose_vector_matches_jax(x2face):
    jm, flat, tm, inputs = x2face
    want = _apply(jm, flat, inputs["pose_input_rgbs"],
                  method="get_pose_vector")
    _close(tm.get_pose_vector(torch.from_numpy(inputs["pose_input_rgbs"])),
           want, "pose vector")


def test_x2face_embedder_has_no_parameters_and_no_output():
    enc = _frames(3, (B, K, IMG, IMG, 3))
    variables = jx2e.Embedder().init(jax.random.PRNGKey(0), enc, enc[:, :1])
    assert not jax.tree_util.tree_leaves(variables)
    tm = tx2e.Wrapper.get_net(None)
    assert not list(tm.parameters()) and not convert.export(tm, "embedder")
    assert tm(torch.from_numpy(enc), torch.from_numpy(enc[:, :1])) \
        == (None, None, None)


def test_none_discriminator_matches_jax():
    x = _frames(4, (B, IMG, IMG, 3))
    labels = np.array([0, 1], np.int32)
    jm = jnone.Wrapper.get_net(None)
    variables = jm.init(jax.random.PRNGKey(0), x, labels)
    assert not jax.tree_util.tree_leaves(variables)
    want, want_feats = jm.apply(variables, x, labels)
    tm = tnone.Wrapper.get_net(None)
    got, got_feats = tm.pass_inputs(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32 and got_feats == want_feats == []
    assert tm.embed_labels(torch.from_numpy(labels)) is None
    assert not list(tm.parameters()) and not tm.state_dict()
    np.testing.assert_array_equal(
        tm.make_input({}, torch.from_numpy(x[:, None])).numpy(),
        np.asarray(jm.make_input({}, x[:, None])))


# --- embedders ----------------------------------------------------------------

@pytest.mark.parametrize("average", ["sum", "max"])
def test_simple_conv_embedder_matches_jax(average):
    enc = _frames(5, (B, K, IMG, IMG, 3))
    pose = _frames(6, (B, 1, IMG, IMG, 3))
    jm = jsimple.Embedder(identity_embedding_size=16, pose_embedding_size=8,
                          average_function=average, width=8)
    flat = _init(jm, enc, pose, seed=3)
    tm = _port(tsimple.Embedder(16, 8, average, width=8), flat)
    want = _apply(jm, flat, enc, pose)
    got = tm(torch.from_numpy(enc), torch.from_numpy(pose))
    for g, w, name in zip(got, want, ("embeds", "elemwise", "pose")):
        _close(g, w, name)


def test_no_pose_encoder_matches_jax():
    enc = _frames(7, (B, K, IMG, IMG, 3))
    kwargs = dict(num_channels=4, max_num_channels=16, embed_channels=16,
                  num_blocks=3)
    jm = jnopose.Embedder(**kwargs)
    flat = _init(jm, enc, seed=4)
    for key in [k for k in flat if k.startswith("spectral")]:
        flat[key] /= np.linalg.norm(flat[key])
    tm = _port(tnopose.Embedder(**kwargs), flat)
    assert tm.INPUT_KEYS == jm.INPUT_KEYS
    (want, want_el, _), _ = _apply(jm, flat, enc, mutable=["spectral"])
    got, got_el, pose = tm(torch.from_numpy(enc))
    assert pose is None
    _close(got, want, "embeds")
    _close(got_el, want_el, "embeds_elemwise")


PRETRAINED = {"FAbNet": (jfab, tfab), "X2Face": (jx2p, tx2p)}


@pytest.fixture(scope="module")
def pretrained_embedders():
    """``get(name)``: the JAX embedder, its variables and the port's, at
    64² (FAb-Net's six stride-2 convolutions need it), made once."""
    made = {}

    def get(name):
        if name not in made:
            jmod, tmod = PRETRAINED[name]
            enc = _frames(8, (B, K, 64, 64, 3))
            pose = _frames(9, (B, 1, 64, 64, 3))
            jm = jmod.Embedder(identity_embedding_size=16,
                               pose_embedding_size=8)
            flat = _init(jm, enc, pose, seed=5)
            tm = _port(tmod.Embedder(16, 8), flat)
            made[name] = (jm, flat, tm, enc, pose)
        return made[name]

    return get


@pytest.mark.parametrize("name", sorted(PRETRAINED))
def test_pretrained_pose_embedder_matches_jax(pretrained_embedders, name):
    """Identity (ResNeXt-50, eval form) and the frozen pose path."""
    jm, flat, tm, enc, pose = pretrained_embedders(name)
    want = _apply(jm, flat, enc, pose)
    got = tm(torch.from_numpy(enc), torch.from_numpy(pose))
    for g, w, what in zip(got, want, ("embeds", "elemwise", "pose")):
        _close(g, w, what)
    assert tm.PRETRAINED == jm.PRETRAINED


@pytest.mark.parametrize("name", sorted(PRETRAINED))
def test_pretrained_pose_path_is_frozen(pretrained_embedders, name):
    """In train form the pose is the eval form's (FAb-Net's BatchNorm
    reads its running statistics and leaves them), cut from the graph;
    the identity tower trains."""
    jm, flat, tm, enc, pose = pretrained_embedders(name)
    want = _apply(jm, flat, pose, method="get_pose_embedding")
    before = {k: v.clone() for k, v in tm.state_dict().items()
              if "pose" in k}
    tm.train()
    embeds, _, got = tm(torch.from_numpy(enc), torch.from_numpy(pose),
                        train=True)
    _close(got, want, "pose in train form")
    assert not got.requires_grad and embeds.requires_grad
    for key, value in tm.state_dict().items():
        if key in before:
            torch.testing.assert_close(value, before[key], rtol=0, atol=0)


def test_fabnet_encoder_matches_jax():
    x = _frames(10, (B, 64, 64, 3))
    jm = jfab.FAbNetEncoder(8)
    flat = _init(jm, x, seed=6)
    tm = _port(tfab.FAbNetEncoder(8), flat)
    _close(tm(torch.from_numpy(x).permute(0, 3, 1, 2)),
           _apply(jm, flat, x), "pose")


# --- the adversarial criteria -----------------------------------------------

@pytest.mark.parametrize("gan_type", ["gan", "rgan", "ragan"])
def test_adversarial_losses_match_jax(gan_type):
    """Both losses, and loss_G's gradient w.r.t. the G-side score (the
    D-side scores it reads are detached in the G branch)."""
    rng = np.random.RandomState(11)
    scores = {k: rng.normal(0, 1.5, (4,)).astype(np.float32)
              for k in ("fake_score_G", "fake_score_D", "real_score")}
    jcrit, tcrit = jadv.Criterion(gan_type), tadv.Criterion(gan_type)
    want_g, want_d = jcrit({**scores,
                            "fake_score_D_for_G": scores["fake_score_D"],
                            "real_score_for_G": scores["real_score"]})
    tensors = {k: torch.from_numpy(v).requires_grad_()
               for k, v in scores.items()}
    got_g, got_d = tcrit(tensors)
    np.testing.assert_allclose(float(got_g["adversarial_G"].detach()),
                               float(want_g["adversarial_G"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got_d["adversarial_D"]),
                               float(want_d["adversarial_D"]),
                               rtol=LOSS_RTOL)

    def loss_g(fake_g):
        return jcrit({**scores, "fake_score_G": fake_g,
                      "fake_score_D_for_G": scores["fake_score_D"],
                      "real_score_for_G": scores["real_score"]}
                     )[0]["adversarial_G"]

    grads = torch.autograd.grad(got_g["adversarial_G"],
                                list(tensors.values()), allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(grads[0].numpy(),
                               np.asarray(jax.grad(loss_g)(
                                   scores["fake_score_G"])), atol=1e-7)
    assert not grads[1].any() and not grads[2].any()


def test_unknown_gan_type_is_refused_as_in_jax():
    with pytest.raises(ValueError):
        jadv.Criterion("wgan")
    with pytest.raises(ValueError, match="gan_type"):
        tadv.Criterion("wgan")


# --- overlay_pretrained -------------------------------------------------------

def _npz(path, flat_tree):
    """A converted-weights file: ``params/...`` and ``batch_stats/...``
    keys."""
    np.savez(path, **{k.replace("::", "/"): v for k, v in flat_tree.items()})


def _overlaid_jax(models, flat_by_part):
    params = {part: _tree({k.split("::", 1)[1]: v for k, v in flat.items()
                           if k.startswith("params::")})
              for part, flat in flat_by_part.items()}
    batch_stats = {"embedder": _tree({
        k.split("::", 1)[1]: v for k, v in flat_by_part["embedder"].items()
        if k.startswith("batch_stats::")})}
    jbuild.overlay_pretrained(models, params, batch_stats)
    out = {}
    for coll, store in (("params", params), ("batch_stats", batch_stats)):
        for part, tree in store.items():
            out.update({f"{coll}::{part}::{k}": np.asarray(v) for k, v in
                        _flatten(jax.device_get(tree)).items()})
    return out


@pytest.mark.parametrize("name", sorted(PRETRAINED))
def test_overlay_pretrained_matches_jax(pretrained_embedders, x2face,
                                        tmp_path, monkeypatch, name):
    """A weights file fabricated from another seeded init of the frozen
    dependency lands where the JAX package puts it (the X2Face file on the
    X2Face generator whole, its driving UNet on the embedder's
    ``pose_unet``; the FAb-Net file, statistics too, on
    ``pose_encoder``), and nowhere else."""
    monkeypatch.setenv("LATENTPOSE_WEIGHTS_DIR", str(tmp_path))
    jm, flat, tm, enc, pose = pretrained_embedders(name)
    jgen_m, gflat, _, inputs = x2face
    if name == "FAbNet":
        dep = _init(jfab.FAbNetEncoder(8), pose[:, 0], seed=20)
        _npz(tmp_path / "fabnet.npz", dep)
    else:
        dep = _init(jgen_m, inputs, seed=21)
        _npz(tmp_path / "x2face.npz", dep)
    models = {"embedder": jm, "generator": jgen_m}
    want = _overlaid_jax(models, {"embedder": flat, "generator": gflat})
    tmodels = {"embedder": _port(PRETRAINED[name][1].Embedder(16, 8), flat),
               "generator": _port(tx2g.Generator(), gflat)}
    tbuild.overlay_pretrained(tmodels)
    got = {}
    for part, module in tmodels.items():
        got.update(convert.export(module, part, params=("params",)))
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    moved = [k for k in want if not np.array_equal(
        want[k], {**{f"{k2.split('::')[0]}::embedder::"
                     f"{k2.split('::', 1)[1]}": v for k2, v in flat.items()},
                  **{f"{k2.split('::')[0]}::generator::"
                     f"{k2.split('::', 1)[1]}": v
                     for k2, v in gflat.items()}}[k])]
    prefix = "pose_encoder" if name == "FAbNet" else "pose_unet"
    assert moved and all(f"::embedder::{prefix}::" in k
                         or (name == "X2Face" and "::generator::" in k)
                         for k in moved)


@pytest.mark.parametrize("fault", ["unknown key", "wrong shape"])
def test_overlay_pretrained_refuses_what_jax_refuses(pretrained_embedders,
                                                    tmp_path, monkeypatch,
                                                    fault):
    monkeypatch.setenv("LATENTPOSE_WEIGHTS_DIR", str(tmp_path))
    jm, flat, _, _, pose = pretrained_embedders("FAbNet")
    dep = _init(jfab.FAbNetEncoder(8), pose[:, 0], seed=22)
    if fault == "unknown key":
        dep["params::conv9::kernel"] = dep["params::conv0::kernel"]
    else:
        dep["params::fc::kernel"] = dep["params::fc::kernel"][:, :4]
    _npz(tmp_path / "fabnet.npz", dep)
    with pytest.raises(ValueError, match="pretrained overlay") as jax_error:
        _overlaid_jax({"embedder": jm}, {"embedder": flat})
    with pytest.raises(ValueError, match="pretrained overlay") as port_error:
        tbuild.overlay_pretrained({"embedder": _port(tfab.Embedder(16, 8),
                                                     flat)})
    assert str(port_error.value) == str(jax_error.value)
