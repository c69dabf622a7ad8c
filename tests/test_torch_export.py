"""PyTorch port, serving export (``latentpose_tpu_torch/cli/export.py``): the
drive step of a fine-tuned checkpoint written by the JAX package (tiny
generator widths, full-width pose tower: ``tests/test_torch_drive.py``'s)
exported with ``torch.export`` to a ``.pt2`` that keeps the AdaIN operator,
held against eager drive in every mode and wire, against the JAX CLI's
StableHLO artifact, and against the JAX CLI's ``.json``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentpose_tpu import checkpoint as jckpt
from latentpose_tpu.cli import export as jexport
from latentpose_tpu_torch.cli import drive as tcli
from latentpose_tpu_torch.cli import export as texport
from latentpose_tpu_torch.models.generators import (
    vector_pose_unsupervised_segmentation_noBottleneck as tgen_mod)
from latentpose_tpu_torch.ops.spectral_norm import quantized_convs
from latentpose_tpu_torch.runners import drive as tdrive

from test_torch_drive import IMG, _port, jax_finetuned_state

BATCH = 2
ADAIN_OP = torch.ops.latentpose.adain_fused.default


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """(args, models, state, checkpoint path) of the JAX fine-tuned state."""
    args, models, state = jax_finetuned_state()
    path = jckpt.save_checkpoint(tmp_path_factory.mktemp("jax_ft"), state,
                                 args)
    return args, models, state, path


def _frames(wire, seed=0):
    rng = np.random.RandomState(seed)
    if wire == "uint8":
        return torch.from_numpy(
            rng.randint(0, 256, (BATCH, IMG, IMG, 3)).astype(np.uint8))
    return torch.from_numpy(rng.rand(BATCH, IMG, IMG, 3).astype(np.float32))


def _export_cli(path, dest, *flags):
    """``cli.export.main`` on the CPU at batch BATCH; the loaded artifact, its
    ``.json`` and its path."""
    out = texport.main([str(path), "--device", "cpu", "--export_batch_size",
                        str(BATCH), "--destination", str(dest), *flags])
    meta = json.loads(open(out + ".json").read())
    return texport.load_serving_artifact(out), meta, out


@pytest.fixture(scope="module")
def artifact(jax_ckpt, tmp_path_factory):
    """``artifact(compute, wire)``: the CLI's export of the JAX checkpoint in
    that compute dtype and wire, made once for the module."""
    out, made = tmp_path_factory.mktemp("artifacts"), {}

    def get(compute, wire):
        if (compute, wire) not in made:
            made[compute, wire] = _export_cli(
                jax_ckpt[3], out / f"{compute}_{wire}.pt2",
                "--compute_dtype", compute, "--transfer_dtype", wire)
        return made[compute, wire]

    return get


@pytest.mark.parametrize("wire", ["uint8", "float32"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_artifact_equals_eager_drive(jax_ckpt, artifact, compute, wire):
    """The reloaded ``.pt2`` gives what eager ``make_drive_fn`` gives on the
    same frames, bit for bit (the same operators on the CPU)."""
    serve, meta, _ = artifact(compute, wire)
    assert (meta["transfer_dtype"], meta["platforms"]) == (wire, ["cpu"])
    args, models, state = _port(jax_ckpt[3], "--compute_dtype", compute)
    frames = _frames(wire)
    want = tdrive.make_drive_fn(models, args)(state, frames)
    got = serve(frames)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        assert not g.requires_grad
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("quantize", ["int8", "int8_static"])
def test_int8_artifact_bakes_its_scales(jax_ckpt, tmp_path, quantize):
    """int8 and int8_static: the artifact equals eager drive with the same
    (calibrated) scales, and keeps them: changing the live module's
    ``act_absmax`` after the export leaves the reloaded artifact's output
    unchanged (for int8_static the change does move eager drive)."""
    path = jax_ckpt[3]
    args, models, state = _port(path, "--quantize", quantize)
    calib = None
    if quantize == "int8_static":
        calib_frames = tcli.load_driver_frames("synthetic://2", IMG)[:8]
        calib = tdrive.calibrate_quant_scales(models, args, state,
                                              calib_frames, BATCH)
    frames = _frames("uint8", seed=3)
    want = tdrive.make_drive_fn(models, args, quant_calib=calib)(
        state, frames)
    exported = texport.export_serving_artifact(models, state, args, BATCH,
                                               torch.uint8, calib)
    torch.export.save(exported, str(tmp_path / "q.pt2"))
    with torch.no_grad():
        for conv in quantized_convs(models["generator"]).values():
            conv.act_absmax.mul_(3.0)
    moved = tdrive.make_drive_fn(models, args)(state, frames)
    got = texport.load_serving_artifact(tmp_path / "q.pt2")(frames)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if quantize == "int8_static":
        assert not torch.equal(moved[0], want[0])


def test_artifact_refuses_a_wrong_shape(artifact):
    serve, _, _ = artifact("float32", "uint8")
    serve(torch.zeros((BATCH, IMG, IMG, 3), dtype=torch.uint8))
    with pytest.raises((AssertionError, RuntimeError), match="size|shape"):
        serve(torch.zeros((BATCH + 1, IMG, IMG, 3), dtype=torch.uint8))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_graph_keeps_one_adain_operator_per_norm(jax_ckpt, artifact,
                                                 compute):
    """The saved graph calls ``latentpose::adain_fused`` once for each AdaIN
    of the generator, as its channel plan counts them (2 a block and the
    head's), and traces through nothing of it."""
    path = artifact(compute, "uint8")[2]
    graph = torch.export.load(path).graph
    calls = [n for n in graph.nodes
             if n.op == "call_function" and n.target == ADAIN_OP]
    args = tcli.resolve_args([str(jax_ckpt[3]), "--device", "cpu"])
    _, adain_features, _ = tgen_mod.schedule(
        args.num_channels, args.max_num_channels,
        args.gen_constant_input_size, args.gen_num_residual_blocks,
        args.image_size)
    assert len(calls) == len(adain_features) == \
        2 * (args.gen_num_residual_blocks + 2) + 1


@pytest.fixture(scope="module")
def both_clis(jax_ckpt, artifact, tmp_path_factory, monkeypatch_module):
    """The float32 artifact and ``.json`` of both CLIs from one checkpoint.
    The JAX CLI restores the checkpoint into the fixture's (jitted-init)
    models: an eager init of its full-width towers takes a minute on the
    CPU."""
    args, models, state, path = jax_ckpt
    out = tmp_path_factory.mktemp("export")
    from latentpose_tpu.cli import drive as jdrive_cli
    monkeypatch_module.setattr(jdrive_cli, "load_finetuned",
                               lambda a, m: (models, state))
    flags = ["--export_batch_size", str(BATCH), "--transfer_dtype",
             "float32", "--compute_dtype", "float32"]
    jdest = jexport.main([str(path), "--destination",
                          str(out / "a.stablehlo"), *flags])
    jserve = jax.export.deserialize(bytearray(open(jdest, "rb").read()))
    jmeta = json.loads(open(jdest + ".json").read())
    tserve, tmeta, _ = artifact("float32", "float32")
    return jserve, jmeta, tserve, tmeta


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_float32_artifact_matches_the_jax_artifact(both_clis):
    """The port's f32 artifact within 1e-4 of the JAX CLI's StableHLO
    artifact on the same frames (f32 on the CPU, sums in another order
    than XLA's)."""
    jserve, _, tserve, _ = both_clis
    frames = _frames("float32", seed=5)
    assert list(jserve.platforms) == ["cpu"]
    want = jserve.call(jnp.asarray(frames.numpy()))
    got = tserve(frames)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_json_matches_the_jax_cli(both_clis):
    _, jmeta, _, tmeta = both_clis
    assert set(tmeta) == set(jmeta)
    for key in set(jmeta) - {"platforms", "bytes"}:
        assert tmeta[key] == jmeta[key], key
    assert tmeta["platforms"] == ["cpu"] and tmeta["bytes"] > 0


def test_int8_static_needs_a_calibration_source(jax_ckpt):
    """A deliberate divergence from the JAX CLI (ROADMAP C.5): its default
    ``synthetic://0`` would bake scales calibrated on synthetic renders
    into the artifact."""
    path = str(jax_ckpt[3])
    with pytest.raises(ValueError, match="calibration_source"):
        texport.resolve_args([path, "--quantize", "int8_static"])
    args = texport.resolve_args([path, "--quantize", "int8_static",
                                 "--calibration_source", "synthetic://2"])
    assert args.calibration_source == "synthetic://2"


@pytest.mark.parametrize("platforms", ["tpu", "cpu,cuda"])
def test_platforms_other_than_the_device_are_refused(jax_ckpt, platforms):
    path = str(jax_ckpt[3])
    with pytest.raises(ValueError, match="cpu"):
        texport.resolve_args([path, "--device", "cpu", "--platforms",
                              platforms])
    args = texport.resolve_args([path, "--device", "cpu", "--platforms",
                                 "cpu"])
    assert args.platforms == ["cpu"]
    assert texport.resolve_args([path]).platforms == ["cuda"]
    assert texport.resolve_args([path]).compute_dtype == "bfloat16"
