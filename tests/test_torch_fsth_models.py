"""PyTorch port, the FSTH family's modules held against the JAX package on
the CPU: ``SumPoolEncoder``, the FSTH embedder (mean and max over the
frames), the FSTH generator (from ê and from ``finetune_affine``),
FSTH_plus, the FSTH discriminator (its interleaved input), ``l1_rgb`` and
``idt_embed``'s keypoint boxes.

Each JAX module's variables are filled at a small size from their shapes
and a seed, moved on with seeded noise (the instance norms' weights; the
generator's constant drawn from a normal: ones leave its first instance
norm flat), and reach the port's module through ``convert.load_into``
(the checkpoint bridge).  Forwards agree within 1e-4 of the output's max,
each after one power iteration of every spectral norm (the new (u, v)
compared too); the fine-tune projection takes the stored (u, v)."""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from latentpose_tpu.checkpoint import _flatten
from latentpose_tpu.losses import idt_embed as jidt
from latentpose_tpu.losses import l1_rgb as jl1
from latentpose_tpu.models.discriminators import FSTH as jdis
from latentpose_tpu.models.embedders import FSTH as jemb
from latentpose_tpu.models.generators import FSTH as jgen
from latentpose_tpu.models.generators import FSTH_plus as jgen_plus
from latentpose_tpu.nn import encoders as jencoders
from latentpose_tpu_torch import convert
from latentpose_tpu_torch.losses import idt_embed as tidt
from latentpose_tpu_torch.losses import l1_rgb as tl1
from latentpose_tpu_torch.models.discriminators import FSTH as tdis
from latentpose_tpu_torch.models.embedders import FSTH as temb
from latentpose_tpu_torch.models.generators import FSTH as tgen
from latentpose_tpu_torch.models.generators import FSTH_plus as tgen_plus
from latentpose_tpu_torch.nn import encoders as tencoders
from latentpose_tpu_torch.ops.spectral_norm import _SpectralNorm

torch.set_num_threads(1)

RTOL = 1e-4             # of the output's max
B, K, IMG = 2, 2, 32


def _noisy(variables, seed, scale=0.1):
    """``variables`` with every parameter moved off its init by seeded
    noise; the spectral state as it is."""
    rng = np.random.RandomState(seed)
    flat = _flatten(serialization.to_state_dict(jax.device_get(variables)))
    out = {}
    for key, value in flat.items():
        value = np.asarray(value, np.float32)
        if key.startswith("params"):
            value = value + rng.normal(0, scale, value.shape).astype(
                np.float32) * max(np.abs(value).max(), 0.5)
        out[key] = value
    return out


def _power_iterated(flat, module):
    """``flat`` with each spectral (u, v) set by one power iteration on its
    weight from the drawn u, as the JAX init leaves them (arbitrary unit
    vectors can put σ near 0); ``module``: a port module of the same
    layout, loaded and read here."""
    _port(module, flat)
    out = dict(flat)
    for name, sub in module.named_modules():
        if isinstance(sub, _SpectralNorm):
            w2d = sub.weight.detach().double().reshape(sub.weight.shape[0],
                                                       -1)
            v = w2d.T @ sub.u.double()
            v = v / v.norm()
            u = w2d @ v
            key = name.replace(".", "::")
            out[f"spectral::{key}::u"] = (u / u.norm()).float().numpy()
            out[f"spectral::{key}::v"] = v.float().numpy()
    return out


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


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= RTOL, (what, err)


def _init(module, *args):
    """``module``'s variables from their shapes (``jax.eval_shape``: traced,
    not compiled) and a seeded fill: kernels U(±1/sqrt(fan_in)), the rest
    normal, spectral (u, v) random unit vectors; :func:`_noisy` moves them
    on as it moves an init."""
    rng = np.random.RandomState(len(jax.tree_util.tree_leaves(
        jax.eval_shape(module.init, jax.random.PRNGKey(0), *args))))

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        if name == "weight":            # the instance norms' scale
            return np.ones(shape, np.float32)
        if name in ("u", "v"):
            value = rng.standard_normal(shape)
            return (value / np.linalg.norm(value)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(module.init, jax.random.PRNGKey(0), *args))


def _apply(module, flat, *args, method=None, **kwargs):
    """``module.apply`` jitted (eager flax takes tens of seconds here)."""
    def run(variables, *a):
        return module.apply(variables, *a, method=method, **kwargs)
    return jax.jit(run)(_tree(flat), *args)


def _nchw_to_nhwc(t):
    return t.permute(0, 2, 3, 1)


def _spectral(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if k.endswith((".u", ".v"))}


def _jax_spectral(mutated):
    return {k.replace("spectral::", "").replace("::", "."): np.asarray(v)
            for k, v in _flatten(jax.device_get(
                {"spectral": mutated["spectral"]})).items()}


def test_sum_pool_encoder_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (B, IMG, IMG, 6)).astype(np.float32)
    jm = jencoders.SumPoolEncoder(num_channels=4, max_num_channels=16,
                                  out_features=16, num_blocks=4)
    flat = _power_iterated(_noisy(_init(jm, x), 1),
                           tencoders.SumPoolEncoder(6, 4, 16, 16, 4))
    tm = _port(tencoders.SumPoolEncoder(6, 4, 16, 16, 4), flat)
    (want, jfeats), mutated = _apply(jm, flat, x, update_stats=True,
                                     mutable=["spectral"])
    got, tfeats = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                     update_stats=True)
    _close(got, want, "pooled")
    assert len(tfeats) == len(jfeats) == 4
    for i, (g, w) in enumerate(zip(tfeats, jfeats)):
        _close(_nchw_to_nhwc(g), w, f"feature {i}")
    new = _jax_spectral(mutated)
    for key, value in _spectral(tm).items():
        np.testing.assert_allclose(value.numpy(), new[key], atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("average", ["sum", "max"])
def test_fsth_embedder_matches_jax(average):
    rng = np.random.RandomState(1)
    enc = rng.uniform(0, 1, (B, K, IMG, IMG, 3)).astype(np.float32)
    stick = (rng.uniform(0, 1, enc.shape) > 0.8).astype(np.float32)
    jm = jemb.Embedder(num_channels=4, max_num_channels=16, embed_channels=16,
                       num_blocks=3, average_function=average)
    flat = _power_iterated(_noisy(_init(jm, enc, None, stick), 2),
                           temb.Embedder(4, 16, 16, 3))
    tm = _port(temb.Embedder(4, 16, 16, 3, average_function=average), flat)
    (want, want_el, pose), _ = _apply(jm, flat, enc, None, stick,
                                      mutable=["spectral"])
    got, got_el, tpose = tm(torch.from_numpy(enc), None,
                            torch.from_numpy(stick))
    assert pose is None and tpose is None
    _close(got, want, "embeds")
    _close(got_el, want_el, "embeds_elemwise")


@pytest.fixture(scope="module")
def fsth_generator():
    rng = np.random.RandomState(2)
    inputs = {
        "embeds": rng.normal(0, 1, (B, 16)).astype(np.float32),
        "dec_stickmen": (rng.uniform(0, 1, (B, 1, IMG, IMG, 3)) > 0.7)
        .astype(np.float32)}
    jm = jgen.Generator(num_channels=4, max_num_channels=16,
                        embed_channels=16, num_downsample_blocks=2,
                        num_residual_blocks=1)
    def fresh():
        return tgen.Generator(num_channels=4, max_num_channels=16,
                              embed_channels=16, num_downsample_blocks=2,
                              num_residual_blocks=1)

    flat = _power_iterated(_noisy(_init(jm, inputs), 3), fresh())

    def port():     # a fresh copy: a forward may advance its (u, v)
        return _port(fresh(), flat)
    return jm, flat, port, inputs


def test_fsth_generator_from_embeds_matches_jax(fsth_generator):
    jm, flat, port, inputs = fsth_generator
    tm = port()
    assert tm.num_affine_params() == jm.num_affine_params()
    (want, segm), mutated = _apply(jm, flat, inputs, update_stats=True,
                                   mutable=["spectral"])
    got, tsegm = tm(torch.from_numpy(inputs["embeds"]),
                    torch.from_numpy(inputs["dec_stickmen"]),
                    update_stats=True)
    assert segm is None and tsegm is None
    _close(got, want, "fake_rgbs")
    new = _jax_spectral(mutated)
    for key, value in _spectral(tm).items():
        np.testing.assert_allclose(value.numpy(), new[key], atol=1e-6,
                                   err_msg=key)


def test_fsth_generator_from_finetune_affine_matches_jax(fsth_generator):
    jm, flat, port, inputs = fsth_generator
    tm = port()
    e_hat = inputs["embeds"][:1]
    want_affine = _apply(jm, flat, jnp.asarray(e_hat),
                         method="project_embeds")
    leaves = tgen.Wrapper.make_finetune_state(tm, torch.from_numpy(e_hat))
    _close(leaves["finetune_affine"], want_affine, "finetune_affine")
    affine = np.asarray(want_affine) * 1.5 + 0.1    # a trained vector
    want, _ = _apply(jm, flat, {
        "dec_stickmen": inputs["dec_stickmen"],
        "finetune_affine": np.broadcast_to(affine, (B, affine.shape[1]))})
    got, _ = tm(None, torch.from_numpy(inputs["dec_stickmen"]),
                finetune_affine=torch.from_numpy(affine))
    _close(got, want, "fake_rgbs from finetune_affine")


def test_fsth_plus_generator_matches_jax():
    rng = np.random.RandomState(3)
    inputs = {"embeds": rng.normal(0, 1, (B, 16)).astype(np.float32),
              "dec_keypoints": rng.uniform(0, 1, (B, 1, 136))
              .astype(np.float32)}
    jm = jgen_plus.Generator(num_channels=4, max_num_channels=16,
                             identity_embedding_size=16,
                             pose_embedding_size=136, output_image_size=IMG,
                             num_residual_blocks=1, out_channels=4)
    flat = _noisy(_init(jm, inputs), 4)
    flat["params::constant"] = rng.standard_normal(
        flat["params::constant"].shape).astype(np.float32)

    def fresh():
        return tgen_plus.Generator(num_channels=4, max_num_channels=16,
                                   identity_embedding_size=16,
                                   num_residual_blocks=1,
                                   output_image_size=IMG)

    flat = _power_iterated(flat, fresh())
    tm = _port(fresh(), flat)
    (want, want_segm), _ = _apply(jm, flat, inputs, update_stats=True,
                                  mutable=["spectral"])
    got, got_segm = tm(torch.from_numpy(inputs["embeds"]),
                       torch.from_numpy(inputs["dec_keypoints"]),
                       update_stats=True)
    _close(got, want, "fake_rgbs")
    _close(got_segm, want_segm, "fake_segm")


def test_fsth_discriminator_matches_jax():
    rng = np.random.RandomState(4)
    stick = rng.uniform(0, 1, (B, 1, IMG, IMG, 3)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (B, 1, IMG, IMG, 3)).astype(np.float32)
    labels = np.array([0, 2], np.int32)
    want_in = jdis.Discriminator.make_input({"dec_stickmen": stick}, rgbs)
    got_in = tdis.Discriminator.make_input(
        {"dec_stickmen": torch.from_numpy(stick)}, torch.from_numpy(rgbs))
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    # the interleave: channel 2c is the stickman's c, 2c + 1 the image's
    np.testing.assert_array_equal(got_in[..., 0::2].numpy(), stick[:, 0])
    np.testing.assert_array_equal(got_in[..., 1::2].numpy(), rgbs[:, 0])

    jm = jdis.Discriminator(in_channels=6, num_channels=4,
                            max_num_channels=16, embed_channels=16,
                            num_blocks=3, image_size=IMG, num_labels=3)
    def fresh():
        return tdis.Discriminator(in_channels=6, num_channels=4,
                                  max_num_channels=16, embed_channels=16,
                                  num_blocks=3, image_size=IMG, num_labels=3)

    flat = _power_iterated(_noisy(_init(jm, want_in, labels), 5), fresh())
    tm = _port(fresh(), flat)
    (want, want_feats), _ = _apply(jm, flat, want_in, labels,
                                   update_stats=True, mutable=["spectral"])
    got, got_feats = tm(got_in, torch.from_numpy(labels).long(),
                        update_stats=True)
    _close(got, want, "score")
    for i, (g, w) in enumerate(zip(got_feats, want_feats)):
        _close(_nchw_to_nhwc(g), w, f"feature {i}")


def test_l1_rgb_matches_jax():
    rng = np.random.RandomState(5)
    fake = rng.uniform(0, 1, (B, IMG, IMG, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (B, 1, IMG, IMG, 3)).astype(np.float32)
    want = jl1.Criterion(30.0)({"fake_rgbs": fake, "target_rgbs": target})
    got = tl1.Criterion(30.0)({"fake_rgbs": torch.from_numpy(fake),
                               "target_rgbs": torch.from_numpy(target)})
    np.testing.assert_allclose(float(got["l1_rgb"]), float(want["l1_rgb"]),
                               rtol=1e-6)


def test_keypoint_boxes_match_jax():
    """The box of each sample, its horizontal midpoint over the whole batch
    (the reference's quirk): moving one sample's keypoints moves every
    box."""
    rng = np.random.RandomState(6)
    kp = rng.uniform(0.1, 0.9, (4, 1, 136)).astype(np.float32)
    want = np.asarray(jidt.compute_bboxes_from_keypoints(kp))
    got = tidt.compute_bboxes_from_keypoints(torch.from_numpy(kp)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    moved = kp.copy()
    moved[0, 0, 0::2] += 0.3
    other = tidt.compute_bboxes_from_keypoints(torch.from_numpy(moved))
    assert not np.allclose(other.numpy()[1:, 2:], got[1:, 2:])


RANK_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    from latentpose_tpu_torch.losses import idt_embed
    from latentpose_tpu_torch.parallel import mesh
    mesh.init_process_group(torch.device("cpu"))
    kp = torch.from_numpy(np.load(sys.argv[1]))
    rows = kp.chunk(mesh.world())[mesh.rank()]
    with mesh.global_batch():
        inside = idt_embed.compute_bboxes_from_keypoints(rows)
    alone = idt_embed.compute_bboxes_from_keypoints(rows)
    print(json.dumps({"global": inside.tolist(), "local": alone.tolist()}))
    mesh.destroy_process_group()
""")


def test_keypoint_boxes_take_the_global_batch_over_ranks(tmp_path):
    """Two gloo ranks, each with half the batch: inside
    ``parallel.global_batch`` (the default regime) each rank's boxes are
    its rows of the one-process boxes of the whole batch, as the JAX step
    takes them over its global batch; outside it (the explicit regimes)
    the midpoint is the rank's own rows', as JAX's ``shard_map``."""
    rng = np.random.RandomState(7)
    kp = rng.uniform(0.1, 0.9, (4, 1, 136)).astype(np.float32)
    kp[:2, :, 0::2] -= 0.1          # the ranks' extents differ
    np.save(tmp_path / "kp.npy", kp)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    repo = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(tmp_path / "kp.npy")],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "RANK": str(r), "WORLD_SIZE": "2",
             "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
             "PYTHONPATH": str(repo)}) for r in range(2)]
    outs = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=120)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    whole = tidt.compute_bboxes_from_keypoints(torch.from_numpy(kp)).numpy()
    got = np.concatenate([np.asarray(o["global"]) for o in outs])
    np.testing.assert_allclose(got, whole, rtol=1e-6, atol=1e-7)
    for r, o in enumerate(outs):
        own = tidt.compute_bboxes_from_keypoints(
            torch.from_numpy(kp[2 * r:2 * r + 2])).numpy()
        np.testing.assert_allclose(np.asarray(o["local"]), own, rtol=1e-6)
    assert not np.allclose(np.concatenate([o["local"] for o in outs]),
                           whole)
