"""PyTorch port, FSDP state sharding (``--param_sharding fsdp``, ROADMAP
A.17.2) over ``torch.distributed`` (gloo on the CPU), held against the
port's replicated step and the JAX package's FSDP step on a 2-device mesh.

``tests/test_torch_parallel.py``'s harness: the metatrain cut of
``tests/test_torch_metatrain.py`` and its JAX-written meta state, each rank
a process of its own (``tests/torch_parallel_rank.py``), killed at a
timeout, so that a gather one rank never joins fails the test in seconds.
One pair of ranks takes every job, each from the checkpoint, on that
module's first batch (one row a rank), augmentation and dropout off, but
where the batch of 4 is named:

- the default regime and FSDP, in f64: FSDP's state after the step equals
  the replicated one's, and both meet the JAX package's FSDP step on a
  2-device mesh (``shard_state(..., "fsdp")`` with its ``state_shardings``
  pinned) under the first-step bounds;
- ``--grad_dtype bfloat16`` replicated and with FSDP (f32): equal, the
  bf16 bucket a group on the wire; the FSDP job saves (every rank joins
  the gather), resumes its checkpoint under FSDP and reads it back; each
  rank's bytes after the step, the save and the resume are its slices and
  the replicated buffers, 1/N of the replicated state's;
- the default and explicit regimes with ``--grad_accum_steps 2``,
  replicated and with FSDP, on the batch of 4 with augmentation and
  dropout (f32): equal;
- a planted fault: FSDP with each rank updating its slice from its own
  unreduced gradient;
- the layout: buckets padded and aligned, slices gathered back, the
  reduce-scatter equal to the all-reduce's slice.

Then ``cli.train --num_devices 2`` meta-trains and fine-tunes with and
without ``--param_sharding fsdp`` (rank 0's visuals, probes and
validation on); the checkpoints are equal array for array, and one process
resumes the FSDP one.
"""

import json
import subprocess
import sys
import types

import numpy as np
import pytest
import jax
import torch

from latentpose_tpu.parallel.mesh import (create_mesh, shard_batch,
                                          shard_state, state_shardings)
from latentpose_tpu.runners import build
from latentpose_tpu.runners import holycow as jholycow
from latentpose_tpu_torch.cli import train as tcli
from latentpose_tpu_torch.parallel import mesh as parallel
from latentpose_tpu_torch.runners import holycow as tholycow
from latentpose_tpu_torch.runners.state import shard_groups

import test_torch_metatrain as mt
import test_torch_parallel as tp
from test_torch_metatrain import _shallow_towers, meta  # noqa: F401

CPU = torch.device("cpu")
WORLD = 2
FSDP = ["--param_sharding", "fsdp"]
BF16 = ["--grad_dtype", "bfloat16"]
ACCUM2 = ["--grad_accum_steps", "2"]
EXPLICIT = ["--explicit_grad_reduce"]
# name: (flags, in f64, the planted fault, save and resume, the batch of
# 4 with augmentation and dropout on)
STEP_JOBS = {
    "default": ([], True, None, False, False),
    "fsdp": (FSDP, True, None, False, False),
    "fsdp_unreduced": (FSDP, True, "shard", False, False),
    "bf16": (BF16, False, None, False, False),
    "fsdp_bf16": (BF16 + FSDP, False, None, True, False),
    "default_accum2": (ACCUM2, False, None, False, True),
    "fsdp_default_accum2": (ACCUM2 + FSDP, False, None, False, True),
    "explicit_accum2": (EXPLICIT + ACCUM2, False, None, False, True),
    "fsdp_explicit_accum2": (EXPLICIT + ACCUM2 + FSDP, False, None, False,
                             True),
}
# FSDP against the replicated step, both in f64: the same sums of two
# gradients and the same elementwise updates
SAME_RTOL = 1e-12


@pytest.fixture(scope="module")
def runs(meta, tmp_path_factory):
    """Every job on two gloo ranks, and meanwhile the JAX package's FSDP
    step in f64 on a 2-device mesh."""
    jmeta, path = meta
    workdir = tmp_path_factory.mktemp("fsdp")
    batch = {**mt._batch(0)[0], **mt._batch(0)[1]}
    np.savez(workdir / "batch.npz", **batch)
    np.savez(workdir / "batch4.npz", **tp._global_batch())
    targs = tp._port_args(path, workdir, tp.NO_AUGMENT, 2)
    jargs = types.SimpleNamespace(**vars(targs))
    jargs.num_labels = 4
    jcriteria = mt._jax_criteria(jargs)
    towers = {}
    for jcrit in jcriteria:
        for attr in ("perceptual_crit", "idt_embed_crit"):
            if hasattr(jcrit, attr):
                towers.update({f"{attr}/{k}": v for k, v in
                               mt._tower_arrays(jcrit).items()})
    np.savez(workdir / "towers.npz", **towers)
    jobs = [{"name": name, "flags": flags + ([] if big else tp.NO_AUGMENT),
             "dropout": big, "float64": f64, "fault": fault, "save": save,
             "batch": str(workdir / ("batch4.npz" if big else "batch.npz"))}
            for name, (flags, f64, fault, save, big) in STEP_JOBS.items()]
    procs = tp._start_ranks({"ckpt": str(path), "workdir": str(workdir),
                             "towers": str(workdir / "towers.npz"),
                             "out": str(workdir), "layers": list(mt.LAYERS),
                             "jobs": jobs + [{"name": "layout"}]}, workdir)
    try:
        with mt._no_dropout():
            jax64 = _jax_fsdp_step_float64(jargs, jmeta, batch, jcriteria)
    finally:        # the ranks run meanwhile; a failure here ends them too
        tp._wait_ranks(procs, workdir)
    return dict(
        ranks={name: dict(np.load(workdir / f"{name}.npz"))
               for name in STEP_JOBS},
        wire={name: json.loads((workdir / f"{name}.wire.json").read_text())
              for name in STEP_JOBS},
        resident={name: [json.loads((workdir / f"{name}.resident{r}.json")
                                    .read_text()) for r in range(WORLD)]
                  for name in STEP_JOBS},
        layout=[dict(np.load(workdir / f"layout{r}.npz"))
                for r in range(WORLD)],
        jax64=jax64, start=mt._jax_flat(jmeta), targs=targs)


def _jax_fsdp_step_float64(args, jstate, batch, jcriteria):
    """The JAX CLI's FSDP step in f64 on a 2-device mesh (the JAX test's
    placement: ``shard_state`` and the step's output pinned to
    ``state_shardings``): (flat state, scalars, how many params leaves the
    output keeps sharded)."""
    mesh = create_mesh(WORLD)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jholycow, "jnp", mt._Float64Numpy())
        opt_g, opt_d = build.build_optimizers(args, mt.MODULES)
        state = shard_state(mt._float64(jstate), mesh, "fsdp")
        jstep = jholycow.make_train_step(
            mt._jax_models(args), jcriteria, args, opt_g, opt_d,
            state_shardings=state_shardings(state, mesh, "fsdp"), mesh=mesh)
        state, scalars = jstep(state, shard_batch(mt._float64(batch), mesh),
                               key)
        sharded = sum(not x.sharding.is_fully_replicated
                      for x in jax.tree_util.tree_leaves(state.params))
        return (mt._jax_flat(state),
                {k: float(v) for k, v in scalars.items()}, sharded)


def _leaf_gaps(got, want):
    """{leaf: ‖got − want‖ / ‖want‖} (0 where both are 0)."""
    out = {}
    for key in want:
        if key in ("step",) or key.endswith("::count"):
            continue
        diff = mt._l2(np.asarray(got[key], np.float64) - want[key])
        out[key] = diff / mt._l2(want[key]) if mt._l2(want[key]) else (
            0.0 if diff == 0 else np.inf)
    return out


# --- the step -------------------------------------------------------------------

def test_fsdp_step_equals_the_replicated_step(runs):
    """FSDP (the parameters gathered, the gradients reduce-scattered, the
    updates and the EMA on the slices) against the default regime, in f64:
    the same losses and every leaf of the state, the moments and the EMA
    included, within 1e-12 of its L2; the step and counts equal."""
    got, want = runs["ranks"]["fsdp"], runs["ranks"]["default"]
    assert set(got) == set(want)
    for key in want:
        if key == "step" or key.endswith("::count") \
                or key.startswith("scalar::"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    gaps = _leaf_gaps(tp._flat_state(got), tp._flat_state(want))
    worst = max(gaps, key=gaps.get)
    print(f"FSDP vs replicated, f64: worst {worst} {gaps[worst]:.3g}")
    assert gaps[worst] <= SAME_RTOL


@pytest.mark.parametrize("regime", ["default_accum2", "explicit_accum2"])
def test_fsdp_equals_the_replicated_step_in_each_regime(runs, regime):
    """FSDP against the replicated step in f32 on the batch of 4 with
    augmentation, dropout and ``--grad_accum_steps 2`` (the microbatches'
    gradients added whole, one reduce-scatter after the last), in the
    default regime and with ``--explicit_grad_reduce``: every leaf and loss
    equal."""
    got, want = runs["ranks"]["fsdp_" + regime], runs["ranks"][regime]
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_fsdp_step_matches_the_jax_fsdp_step_on_a_mesh(runs):
    """FSDP's two ranks against the JAX package's FSDP step on a 2-device
    mesh in f64, with ``tests/test_torch_metatrain.py``'s first-step
    bounds; the JAX step kept its parameters sharded."""
    jstate, jscalars, sharded = runs["jax64"]
    assert sharded >= 4
    got = runs["ranks"]["fsdp"]
    mt.test_first_meta_step_matches_jax_in_float64({
        "tfirst": tp._flat_state(got), "jfirst64": jstate,
        "tscalars": [tp._flat_scalars(got)], "jscalars64": jscalars,
        "start": runs["start"], "accum": 1, "targs": runs["targs"]})


def test_fsdp_bf16_wire_equals_the_replicated_bf16_wire(runs):
    """``--grad_dtype bfloat16`` with FSDP against it replicated (f32): the
    same state (a bf16 sum of two gradients rounds once either way); one
    bf16 bucket a group on the wire, the group's padded layout at 2 bytes
    an entry, of which each rank keeps 1/N."""
    got, want = runs["ranks"]["fsdp_bf16"], runs["ranks"]["bf16"]
    gaps = _leaf_gaps(tp._flat_state(got), tp._flat_state(want))
    assert max(gaps.values()) <= 1e-6, max(gaps, key=gaps.get)
    state = tcli.load_checkpoint(runs["targs"], CPU)
    groups = shard_groups(state)
    sizes = [sum(t.numel() for t in groups[g]) for g in ("g", "d")]
    buckets = [parallel.Bucket(groups[g], WORLD, 0) for g in ("g", "d")]
    assert runs["wire"]["bf16"] == [["torch.bfloat16", 2 * n] for n in sizes]
    assert runs["wire"]["fsdp_bf16"] == [["torch.bfloat16", 2 * b.numel]
                                         for b in buckets]
    for b, n in zip(buckets, sizes):
        assert n <= b.numel <= n + (len(b.shapes) + WORLD) * parallel.ALIGN
        assert b.shard_numel * WORLD == b.numel


def test_resident_state_is_a_slice_plus_the_buffers(runs):
    """Each rank's state between steps (after the step, after a save,
    after a resume under FSDP) holds its slices and the replicated buffers
    and nothing else, and its slices are 1/N of the replicated state's
    parameters, EMA and moments (within the padding, 1 % at this cut's
    many small tensors)."""
    for rank, record in enumerate(runs["resident"]["fsdp_bf16"]):
        replicated = record["replicated"]
        tensors = replicated["resident"] - replicated["buffers"]
        for when in ("step", "save", "resume"):
            now = record[when]
            assert now["resident"] == now["slices"] + now["buffers"], when
            assert now["buffers"] == replicated["buffers"]
            share = now["slices"] * WORLD / tensors
            print(f"rank {rank} after the {when}: {now['resident']} bytes "
                  f"(slices {now['slices']}, buffers {now['buffers']}); "
                  f"replicated {replicated['resident']}; slices x N / "
                  f"replicated tensors {share:.5f}")
            assert 1.0 <= share <= 1.01, (when, share)
    for record in runs["resident"]["bf16"]:     # replicated: nothing cut
        assert record["step"]["resident"] == record["replicated"]["resident"]


def test_a_slice_updated_from_its_own_gradient_is_caught(runs):
    """The planted fault (each rank updates its slice from its own
    unreduced gradient, no reduce-scatter): the same forward (losses
    within 1e-12), the optimizers' moments far above the FSDP gate on
    every group."""
    got, want = runs["ranks"]["fsdp_unreduced"], runs["ranks"]["default"]
    for name, value in tp._flat_scalars(want).items():
        np.testing.assert_allclose(tp._flat_scalars(got)[name], value,
                                   rtol=SAME_RTOL, err_msg=name)
    gaps = _leaf_gaps(tp._flat_state(got), tp._flat_state(want))
    for prefix in ("opt_state_g::0::mu::generator",
                   "opt_state_g::0::mu::embedder",
                   "opt_state_d::0::mu::discriminator"):
        group = [g for k, g in gaps.items() if k.startswith(prefix)]
        print(f"{prefix}: worst {max(group):.3g} of its L2")
        assert max(group) > 1e6 * SAME_RTOL, prefix


# --- the layout -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_buckets_are_padded_aligned_and_sliced(runs, dtype):
    """Each tensor's offset and each rank's slice start on an ALIGN-byte
    boundary; the padding is zeros; the ranks' slices are disjoint, cover
    the bucket, and gather back to it; the views read the tensors."""
    layout = runs["layout"]
    flat = layout[0][f"{dtype}::flat"]
    for rank in range(WORLD):
        got = layout[rank]
        assert (got[f"{dtype}::offsets_bytes"] % parallel.ALIGN == 0).all()
        np.testing.assert_array_equal(got[f"{dtype}::flat"], flat)
        np.testing.assert_array_equal(got[f"{dtype}::gathered"], flat)
    np.testing.assert_array_equal(
        np.concatenate([layout[r][f"{dtype}::shard"] for r in range(WORLD)]),
        flat)
    views = layout[0][f"{dtype}::views"]
    assert (flat != 0).sum() == (views != 0).sum() == views.size
    assert flat.size % (WORLD * parallel.ALIGN // flat.itemsize) == 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reduce_scatter_equals_the_all_reduces_slice(runs, dtype):
    """``reduce_scatter_grads`` gives each rank its slice of what
    ``reduce_grads`` gives every rank, bit for bit."""
    for rank in range(WORLD):
        got = runs["layout"][rank]
        np.testing.assert_array_equal(got[f"{dtype}::scattered"],
                                      got[f"{dtype}::reduced_slice"])


def test_bucket_layout_is_a_function_of_shapes_and_world():
    """Without a process group: offsets rounded up to ALIGN = 256 bytes (a
    multiple of the 16 the kernels need), each tensor padded, the bucket
    padded to world x ALIGN bytes, rank r's slice at r x S."""
    assert parallel.ALIGN == 256
    tensors = [torch.zeros(3), torch.zeros(2, 2), torch.zeros(70)]
    b = parallel.Bucket(tensors, world_=3, rank_=2)
    assert b.offsets == [0, 64, 128]            # f32: 64 entries a step
    assert (b.numel, b.shard_numel, b.start) == (384, 128, 256)
    doubles = parallel.Bucket([t.double() for t in tensors], 3, 1)
    assert doubles.offsets == [0, 32, 64]
    assert (doubles.numel, doubles.shard_numel, doubles.start) == (192, 64,
                                                                   64)
    with pytest.raises(TypeError, match="one dtype"):
        parallel.Bucket([torch.zeros(2), torch.zeros(2).double()], 2, 0)


def test_one_rank_takes_the_flag_and_shards_nothing(meta, tmp_path):
    """With one rank ``--param_sharding fsdp`` leaves the state replicated,
    as the JAX CLI without a mesh does; a gather of it is a no-op."""
    args = tp._port_args(meta[1], tmp_path, FSDP, 2)
    state = tcli.place_state(args, tcli.load_checkpoint(args, CPU))
    assert state.layout is None
    before = parallel.resident_bytes(state)
    with parallel.gathered(state, whole=True):
        assert parallel.resident_bytes(state) == before


def test_cli_refuses_an_unknown_sharding_in_the_jax_clis_words(meta,
                                                               capsys):
    """A value other than 'replicated' and 'fsdp' exits as the JAX CLI's
    parser exits, with its error line."""
    from latentpose_tpu.config.core_args import build_core_parser
    lines = []
    for parse in (lambda argv: build_core_parser().parse_args(argv),
                  lambda argv: tcli.resolve_args(
                      ["--checkpoint_path", str(meta[1]), "--device", "cpu",
                       *argv])):
        with pytest.raises(SystemExit) as exit_:
            parse(["--param_sharding", "zero3"])
        assert exit_.value.code == 2
        lines.append(capsys.readouterr().err.strip().splitlines()[-1])
    want = "error: argument --param_sharding: invalid choice: 'zero3'"
    assert want in lines[0]
    assert lines[1].split("error: ", 1)[1] == lines[0].split("error: ", 1)[1]


# --- the CLI ----------------------------------------------------------------------

def _start_cli(argv, workdir, name):
    site = workdir / "site"
    if not site.exists():
        site.mkdir()
        (site / "sitecustomize.py").write_text(tp.CUT_SITE)
    env = tp._env()
    env["PYTHONPATH"] = f"{site}:{env['PYTHONPATH']}"
    log = open(workdir / f"{name}.log", "w")
    return subprocess.Popen(
        [sys.executable, "-m", "latentpose_tpu_torch.cli.train", *argv],
        cwd=tp.REPO, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True, env=env)


def _run_both(runs_argv, workdir, what):
    """Each {name: argv} as its own ``cli.train`` at once, waited for."""
    procs = {name: _start_cli(argv, workdir, name)
             for name, argv in runs_argv.items()}
    codes = tp._wait_all(list(procs.values()), 2 * tp.CLI_TIMEOUT, what)
    for name, code in zip(procs, codes):
        if code:
            pytest.fail(f"{name} exited {code}:\n"
                        + (workdir / f"{name}.log").read_text()[-4000:])


def _checkpoint(root):
    ckpt, = root.glob("*/checkpoints/*.ckpt")
    return ckpt


def test_cli_trains_and_finetunes_with_fsdp_as_replicated(tmp_path):
    """``cli.train --num_devices 2`` with and without ``--param_sharding
    fsdp``: two meta steps (rank 0's visuals and probes each step,
    validation after the epoch, every rank joining their gathers), then a
    fine-tune from each run's checkpoint (ê on the whole state before it is
    sharded); each FSDP checkpoint equals the replicated run's array for
    array and saves the flag; one process resumes the FSDP meta
    checkpoint and takes the next step."""
    meta_argv = ["--config_name", "default", "--dataloader", "synthetic",
                 "--device", "cpu", "--num_devices", str(WORLD),
                 "--allow_random_vgg", *tp.TINY, "--batch_size",
                 str(tp.BATCH), "--synthetic_num_labels", "8",
                 "--num_epochs", "1", "--log_frequency_images", "1",
                 "--log_frequency_fixed_images", "1", "--fixed_val_ids", "1",
                 "--no-skip_eval"]
    modes = {"replicated": [], "fsdp": FSDP}
    _run_both({f"meta_{m}": meta_argv + flags + [
        "--experiments_dir", str(tmp_path / f"meta_{m}")]
        for m, flags in modes.items()}, tmp_path, "meta-train")
    _run_both({f"ft_{m}": [
        "--finetune", "--checkpoint_path",
        str(_checkpoint(tmp_path / f"meta_{m}")), "--config_name",
        "finetuning-base", "--dataloader", "synthetic", "--device", "cpu",
        "--num_devices", str(WORLD), "--allow_random_vgg", "--batch_size",
        str(tp.BATCH), "--num_epochs", "1", "--experiments_dir",
        str(tmp_path / f"ft_{m}"), *flags] for m, flags in modes.items()},
        tmp_path, "fine-tune")
    for stage in ("meta", "ft"):
        paths = {m: _checkpoint(tmp_path / f"{stage}_{m}") for m in modes}
        flat = {m: tcli.ckpt_lib.load_arrays(p) for m, p in paths.items()}
        assert set(flat["fsdp"]) == set(flat["replicated"])
        for key, value in flat["replicated"].items():
            np.testing.assert_array_equal(flat["fsdp"][key], value,
                                          err_msg=f"{stage} {key}")
        saved = tcli.ckpt_lib.peek_args(paths["fsdp"])
        assert saved["param_sharding"] == "fsdp"
        assert saved["num_devices"] == WORLD
    assert tcli.checkpoint_is_finetuned(paths["fsdp"])
    meta_ckpt = _checkpoint(tmp_path / "meta_fsdp")
    args = tcli.resolve_args(["--checkpoint_path", str(meta_ckpt),
                              "--num_devices", "1", "--device", "cpu",
                              "--experiments_dir", str(tmp_path / "one")])
    state = tcli.place_state(args, tcli.load_checkpoint(args, CPU))
    assert state.layout is None and state.step == 2
    loader = tcli.build_dataloader(args)
    step = tcli.make_step(args, tcli.build_criteria(args, CPU))
    scalars = step(state, tholycow.to_device(loader.get_batch(0), CPU,
                                             tholycow.META_STEP_KEYS))
    assert state.step == 3 and state.opt_g.count == 3
    assert all(np.isfinite(float(v)) for v in scalars.values())
