"""PyTorch port, data-parallel training and drive over ``torch.distributed``
(gloo on the CPU), held against the port's one-process step and the JAX
package's steps on a 2-device mesh.

The flagship cut as ``tests/test_torch_metatrain.py`` cuts it (64², K=2,
the embedder's towers at one block a stage, a tiny generator and
discriminator) and its JAX-written meta state.  Each rank is a process of
its own (``tests/torch_parallel_rank.py``), waited for with a timeout and
killed at it, so that a collective that one rank never reaches fails the
test in seconds rather than hanging the run.  One pair of ranks takes every
regime's step, each from the checkpoint, while this process computes the
references:

(a) the default regime on a batch of 4 (2 ranks x 2 rows), augmentation
    and dropout on, against the port's one process on the whole batch:
    global BatchNorm (the conv_bn link's (Σy, Σy²) summed over ranks before
    bn3), global dice, each rank's rows of the global draws;
(b) the default regime against the JAX default step on a 2-device mesh,
    with ``tests/test_torch_metatrain.py``'s first-step bounds, on that
    module's first batch (2 rows: 2 ranks x 1), augmentation and dropout
    off;
(c) ``--explicit_grad_reduce`` against the JAX explicit step, the same way,
    and with ``--grad_accum_steps 2`` on the batch of 4 (JAX's shard_map
    layout: each rank splits its own rows into the microbatches); the
    identity tower's running variances then read far from (b)'s;
(d) ``--grad_dtype bfloat16`` against the JAX step's (JAX's own bounds from
    ``tests/test_parallel.py``), its bucket bf16 on the wire, and with
    ``--grad_accum_steps 2`` against the JAX step with the same
    accumulation and against the port's explicit f32 step (batch 4);
(e) the global moments' gradient against autograd through one process's
    concatenation, and (a) with that gradient left unreduced (a planted
    fault) far above (a)'s gate.

(a)-(c) take the step in f64 in both packages (the JAX one as
``tests/test_torch_metatrain.py`` takes it): in f32 two routes' rounding
moves a ReLU input across 0 now and then (one element of ResNeXt-50's
layer4 bn1 moved that channel's bias gradient by 36 %, and every gradient
below it by 0.2-0.5 %), which no bound on rounding covers; the batch of 4
does so in either package's f32, the first batch of 2 does not.  (d) and
the CLIs run in f32.

Then the CLIs: (f) ``cli.train --num_devices 2`` (it starts its ranks) takes
two meta steps with rank 0's visuals and validation on, writes one
checkpoint, which one process resumes; fine-tunes on two ranks (ê on rank
0); saves once at the step its ranks agree on after a SIGTERM; (g) ``cli.drive --num_devices 2``
equals one-process drive bit for bit in bf16 and int8; the launcher brings
back a result larger than a pipe; ``--num_devices 0`` takes every visible
card; (h) the refusals.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import jax
import torch

from latentpose_tpu.data.synthetic import SyntheticDataLoader as JaxLoader
from latentpose_tpu.parallel.mesh import create_mesh, replicate, shard_batch
from latentpose_tpu.runners import build
from latentpose_tpu.runners import holycow as jholycow
from latentpose_tpu_torch import convert
from latentpose_tpu_torch.cli import drive as tdrive_cli
from latentpose_tpu_torch.cli import train as tcli
from latentpose_tpu_torch.losses.common.perceptual_loss import \
    load_tower_arrays
from latentpose_tpu_torch.parallel import mesh as parallel
from latentpose_tpu_torch.runners import finetune as tft
from latentpose_tpu_torch.runners import holycow as tholycow
from latentpose_tpu_torch.runners import loop as tloop

import test_torch_metatrain as mt
import torch_parallel_rank as rank_worker
from test_torch_metatrain import _shallow_towers, meta  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_parallel_rank.py"
CPU = torch.device("cpu")
WORLD = 2
BATCH = 4
RANK_TIMEOUT = 240          # s, a pair of ranks (every job)
CLI_TIMEOUT = 240           # s, one CLI run with its ranks
# (a): the port's two ranks against its one process, both f32
SELF_RTOL = 1e-5
# (d): tests/test_parallel.py's bounds for the bf16 gradient mean
BF16_LOSS_RTOL = 2e-2
BF16_PARAM_RTOL, BF16_PARAM_ATOL = 2e-2, 2e-3
# name: (flags, augmentation and dropout on, global batch, in f64)
AUGMENT = ["--use_pixelwise_augs", "--use_affine_scale", "--use_affine_shift"]
STEP_JOBS = {
    "default_aug": (AUGMENT, True, 4, True),
    "default_aug_accum2": (AUGMENT + ["--grad_accum_steps", "2"], True, 4,
                           True),
    "default": ([], False, 2, True),
    "explicit": (["--explicit_grad_reduce"], False, 2, True),
    "bf16": (["--grad_dtype", "bfloat16"], False, 2, False),
    "explicit_accum2": (["--explicit_grad_reduce", "--grad_accum_steps",
                         "2"], False, 4, False),
    "bf16_accum2": (["--grad_dtype", "bfloat16", "--grad_accum_steps", "2"],
                    False, 4, False),
    "explicit_accum2_f64": (["--explicit_grad_reduce", "--grad_accum_steps",
                             "2"], False, 4, True),
}
# a planted fault: the job it repeats with the global moments' gradients
# left unreduced (``torch_parallel_rank.unreduced_moment_gradients``)
FAULTS = {"default_aug_unreduced": "default_aug"}
NO_AUGMENT = ["--no-use_pixelwise_augs", "--no-use_affine_scale",
              "--no-use_affine_shift"]


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _wait_all(procs, timeout, what):
    """Wait for every process, each with its own ``communicate`` and the
    time left; on a timeout kill them all (their process groups) and
    fail."""
    deadline = time.monotonic() + timeout
    try:
        for proc in procs:
            proc.communicate(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        for proc in procs:
            _kill_group(proc)
        pytest.fail(f"{what}: no end within {timeout} s (a rank waits in a "
                    "collective the other never reached)")
    return [proc.returncode for proc in procs]


def _kill_group(proc):
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.communicate()


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    for key in parallel.ENV:
        env.pop(key, None)
    env.update(extra)
    return env


def _start_ranks(spec, workdir):
    """The worker on WORLD ranks, started; :func:`_wait_ranks` ends them."""
    spec_path = workdir / "spec.json"
    spec_path.write_text(json.dumps(spec))
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        with open(workdir / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), str(spec_path)], cwd=REPO,
                stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True,
                env=_env(RANK=str(rank), WORLD_SIZE=str(WORLD),
                         MASTER_ADDR="localhost", MASTER_PORT=str(port))))
    return procs


def _wait_ranks(procs, workdir):
    """Wait for the ranks (killed at RANK_TIMEOUT); their logs on
    failure."""
    codes = _wait_all(procs, RANK_TIMEOUT, "gloo ranks")
    if any(codes):
        tails = [(workdir / f"rank{r}.log").read_text()[-3000:]
                 for r in range(WORLD)]
        pytest.fail(f"ranks exited {codes}:\n" + "\n----\n".join(tails))


def _global_batch():
    """The meta loader's batch of 4 (K=2), its frames with seeded noise as
    ``tests/test_torch_metatrain.py`` adds it."""
    data, target = JaxLoader(image_size=mt.IMG, batch_size=BATCH,
                             num_labels=4, num_enc_frames=mt.K,
                             finetune=False, seed=0).get_batch(0)
    rng = np.random.RandomState(100)
    for d, key in ((data, "enc_rgbs"), (data, "pose_input_rgbs"),
                   (target, "target_rgbs")):
        d[key] = (d[key] + rng.uniform(0, 0.2, d[key].shape)
                  ).astype(np.float32)
    return {**data, **target}


def _port_args(path, workdir, flags, batch=BATCH):
    return tcli.resolve_args([
        "--checkpoint_path", str(path), "--dataloader", "synthetic",
        "--device", "cpu", "--allow_random_vgg", "--num_epochs", "1",
        "--experiments_dir", str(workdir), "--batch_size", str(batch),
        *flags])


def _flat_scalars(flat):
    return {k.split("::", 1)[1]: float(v) for k, v in flat.items()
            if k.startswith("scalar::")}


def _flat_state(flat):
    return {k: np.asarray(v) for k, v in flat.items()
            if not k.startswith("scalar::")}


@pytest.fixture(scope="module")
def runs(meta, tmp_path_factory):
    """Every regime's step on two gloo ranks, the port's one-process step
    (augmentation and dropout on) and the JAX steps on a 2-device mesh,
    all from the JAX meta state."""
    jmeta, path = meta
    workdir = tmp_path_factory.mktemp("parallel")
    batches = {4: _global_batch(), 2: {**mt._batch(0)[0], **mt._batch(0)[1]}}
    for size, batch in batches.items():
        np.savez(workdir / f"batch{size}.npz", **batch)
    targs = _port_args(path, workdir, NO_AUGMENT, 2)
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
    jobs = {name: {"name": name,
                   "flags": flags + ([] if augment else NO_AUGMENT),
                   "dropout": augment,
                   "batch": str(workdir / f"batch{size}.npz"),
                   "float64": f64}
            for name, (flags, augment, size, f64) in STEP_JOBS.items()}
    jobs = list(jobs.values()) + [{**jobs[base], "name": name, "fault": True}
                                  for name, base in FAULTS.items()]
    procs = _start_ranks({"ckpt": str(path), "workdir": str(workdir),
                          "towers": str(workdir / "towers.npz"),
                          "out": str(workdir), "layers": list(mt.LAYERS),
                          "jobs": jobs + [{"name": "moments"}]}, workdir)
    try:
        one, oscalars, jax64, jbf16 = _references(
            path, workdir, jmeta, jargs, jcriteria, batches)
    finally:        # the ranks run meanwhile; a failure here ends them too
        _wait_ranks(procs, workdir)
    ranks = {name: dict(np.load(workdir / f"{name}.npz"))
             for name in [*STEP_JOBS, *FAULTS]}
    wire = {name: json.loads((workdir / f"{name}.wire.json").read_text())
            for name in STEP_JOBS}
    return dict(ranks=ranks, wire=wire, one=one, targs=targs,
                one_scalars=oscalars, jax64=jax64, jbf16=jbf16,
                start=mt._jax_flat(jmeta), workdir=workdir,
                batch=batches[4])


def _references(path, workdir, jmeta, jargs, jcriteria, batches):
    """What the ranks are held against: the port's one-process steps in
    f64 on the batch of 4, augmentation and dropout on, with and without
    accumulation ({job: state}, {job: scalars}), and the JAX steps on a
    2-device mesh: the default and explicit regimes in f64 on the batch of
    2 and the explicit one with ``--grad_accum_steps 2`` on the batch of 4
    ({job: (state, scalars)}); the bf16 wire in f32, on the batch of 2 and
    with ``--grad_accum_steps 2`` on the batch of 4 ({accum: (state,
    scalars)})."""
    batch64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v
               for k, v in batches[4].items()}
    one, oscalars = {}, {}
    for name in ("default_aug", "default_aug_accum2"):
        oargs = _port_args(path, workdir, STEP_JOBS[name][0])
        ostate = tcli.load_checkpoint(oargs, CPU)
        criteria = tcli.build_criteria(oargs, CPU)
        for crit, jcrit in zip(criteria, jcriteria):
            for attr in rank_worker.TOWERS:
                if hasattr(crit, attr):
                    load_tower_arrays(getattr(crit, attr).module,
                                      mt._tower_arrays(jcrit))
        with rank_worker.float64_step(oargs, ostate, criteria):
            scalars = tholycow.make_train_step(criteria, oargs)(
                ostate, tholycow.to_device((batch64, {}), CPU,
                                           tholycow.META_STEP_KEYS))
        oscalars[name] = {k: float(v) for k, v in scalars.items()}
        one[name] = {k: np.array(v) for k, v in
                     convert.export_train_state(ostate).items()}

    mesh = create_mesh(WORLD)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    with mt._no_dropout():
        jax64 = {}
        for name, explicit, accum in (("default", False, 1),
                                      ("explicit", True, 1),
                                      ("explicit_accum2_f64", True, 2)):
            args = types.SimpleNamespace(**vars(jargs))
            args.explicit_grad_reduce = explicit
            args.grad_accum_steps = accum
            jax64[name] = _jax_step_float64(args, jmeta, batches[2 * accum],
                                            mesh, jcriteria, key)
        jbf16 = {}
        for accum in (1, 2):
            bargs = types.SimpleNamespace(**vars(jargs))
            bargs.grad_dtype = "bfloat16"
            bargs.grad_accum_steps = accum
            opt_g, opt_d = build.build_optimizers(bargs, mt.MODULES)
            jstep = jholycow.make_train_step(mt._jax_models(bargs),
                                             jcriteria, bargs, opt_g, opt_d,
                                             mesh=mesh)
            bstate, bscalars = jstep(replicate(jmeta, mesh),
                                     shard_batch(batches[2 * accum], mesh),
                                     key)
            jbf16[accum] = (mt._jax_flat(bstate),
                            {k: float(v) for k, v in bscalars.items()})
    return one, oscalars, jax64, jbf16


def _jax_step_float64(args, jstate, batch, mesh, jcriteria, key):
    """The JAX step in f64 on the mesh (the first-step reference of
    ``tests/test_torch_metatrain.py``): (flat state, scalars)."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jholycow, "jnp", mt._Float64Numpy())
        opt_g, opt_d = build.build_optimizers(args, mt.MODULES)
        jstep = jholycow.make_train_step(mt._jax_models(args), jcriteria,
                                         args, opt_g, opt_d, mesh=mesh)
        state, scalars = jstep(replicate(mt._float64(jstate), mesh),
                               shard_batch(mt._float64(batch), mesh), key)
        return mt._jax_flat(state), {k: float(v) for k, v in scalars.items()}


def _rel_l2(got, want):
    return mt._l2(np.asarray(got, np.float64) - np.asarray(want, np.float64)) \
        / max(mt._l2(want), 1e-30)


# --- (a) two ranks against one process ------------------------------------------

@pytest.mark.parametrize("job", ["default_aug", "default_aug_accum2"],
                         ids=["accum1", "accum2"])
def test_two_ranks_equal_one_process_with_augmentation_and_dropout(runs,
                                                                   job):
    """The default regime's two ranks, augmentation and dropout on, against
    the port's one process on the whole batch, with and without
    ``--grad_accum_steps 2`` (each rank's microbatch i its part of the
    global microbatch i): every loss within 1e-5 relative; every leaf of the state (parameters, EMA, BatchNorm running
    statistics, (u, v), both optimizers' moments) within 1e-5 of its L2,
    the moments with ``tests/test_torch_metatrain.py``'s floor of 1e-6 of
    their module's L2 (a bias before a norm has a gradient of 0: its f32
    value is rounding)."""
    got = runs["ranks"][job]
    scalars = _flat_scalars(got)
    assert set(scalars) == set(runs["one_scalars"][job])
    for name, want in runs["one_scalars"][job].items():
        np.testing.assert_allclose(scalars[name], want, rtol=SELF_RTOL,
                                   err_msg=name)
    state, want = _flat_state(got), runs["one"][job]
    assert set(state) == set(want)
    norms = {}
    for k in want:
        if k.startswith("opt_state") and not k.endswith("::count"):
            norms[mt._part(k)] = np.hypot(norms.get(mt._part(k), 0.0),
                                          mt._l2(want[k]))
    ratios = {}
    for k in state:
        if k == "step" or k.endswith("::count"):
            np.testing.assert_array_equal(state[k], want[k], err_msg=k)
            continue
        floor = mt.GRAD_FLOOR * norms[mt._part(k)] \
            if k.startswith("opt_state") else 0.0
        ratios[k] = mt._l2(np.asarray(state[k], np.float64) - want[k]) / (
            SELF_RTOL * mt._l2(want[k]) + floor + 1e-30)
    assert mt._worst(ratios) <= 1.0
    # the conv_bn link's statistics were the global batch's: bn3's running
    # statistics moved as one process's did
    bn3 = [k for k in state if k.startswith("batch_stats::embedder")
           and "bn3" in k]
    assert len(bn3) == 2 * len(mt.LAYERS)
    for k in bn3:
        assert not np.array_equal(state[k], runs["start"][k])


# --- (b), (c) against the JAX package's steps on a 2-device mesh ------------------

@pytest.mark.parametrize("regime,accum", [
    ("default", 1), ("explicit", 1), ("explicit_accum2_f64", 2)],
    ids=["default", "explicit", "explicit_accum2"])
def test_two_ranks_match_the_jax_step_on_a_mesh(runs, regime, accum):
    """The default and explicit regimes' two ranks against the JAX step on
    a 2-device mesh in f64, with ``tests/test_torch_metatrain.py``'s bounds
    for the first step (losses 1e-4; each gradient leaf 1e-4 of its L2,
    2e-3 with ``--grad_accum_steps 2``; BatchNorm statistics and (u, v)
    5e-5 of their largest value; the EMA 1e-5; each weight's update 5e-2
    of its move).  With ``--grad_accum_steps 2`` (the batch of 4) the
    explicit regime's layout is JAX's shard_map's: each rank splits its own
    contiguous rows into the microbatches, whose BatchNorm statistics and
    gradients add up in order before the one reduction."""
    jstate, jscalars = runs["jax64"][regime]
    got = runs["ranks"][regime]
    mt.test_first_meta_step_matches_jax_in_float64({
        "tfirst": _flat_state(got), "jfirst64": jstate,
        "tscalars": [_flat_scalars(got)], "jscalars64": jscalars,
        "start": runs["start"], "accum": accum, "targs": runs["targs"]})


def test_explicit_regime_reads_its_own_statistics(runs):
    """The witness of (b) and (c): the identity tower's running variances of
    the explicit regime (each rank's rows, averaged after the step) sit,
    for most of its BatchNorms, far above (b)'s bound for BatchNorm
    statistics away from the default regime's (the global batch's), in
    both packages; the stem's running mean, whose input both regimes share,
    agrees (a mean of equal shards' means is the global mean)."""
    default = _flat_state(runs["ranks"]["default"])
    explicit = _flat_state(runs["ranks"]["explicit"])
    variances = [k for k in default if k.startswith(
        "batch_stats::embedder::identity_encoder") and k.endswith("::var")]
    assert variances
    jdefault, jexplicit = (runs["jax64"][r][0] for r in ("default",
                                                         "explicit"))
    for low, high in ((default, explicit), (jdefault, jexplicit)):
        gaps = [np.abs(high[k] - low[k]).max()
                / (mt.STATS_RTOL * np.abs(low[k]).max()) for k in variances]
        assert np.median(gaps) > 10.0, gaps
    stem = "batch_stats::embedder::identity_encoder::bn1::mean"
    np.testing.assert_allclose(explicit[stem], default[stem], rtol=1e-9,
                               atol=1e-12)


# --- (d) the bf16 wire --------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2], ids=["accum1", "accum2"])
def test_bf16_gradients_match_the_jax_step(runs, accum):
    """``--grad_dtype bfloat16`` against the JAX step's, with and without
    ``--grad_accum_steps 2`` (the batch of 4: f32 sums of the microbatches,
    one bf16 reduction), with JAX's own bounds (``tests/test_parallel.py``):
    losses 2e-2 relative, parameters 2e-2 relative / 2e-3 absolute."""
    jstate, jscalars = runs["jbf16"][accum]
    got = runs["ranks"]["bf16" if accum == 1 else "bf16_accum2"]
    scalars = _flat_scalars(got)
    for name, want in jscalars.items():
        np.testing.assert_allclose(scalars[name], want, rtol=BF16_LOSS_RTOL,
                                   err_msg=name)
    state = _flat_state(got)
    params = [k for k in jstate if k.startswith("params::")]
    assert params
    for k in params:
        np.testing.assert_allclose(state[k], jstate[k], rtol=BF16_PARAM_RTOL,
                                   atol=BF16_PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("accum", [1, 2])
def test_bf16_bucket_goes_on_the_wire_once_a_group(runs, accum):
    """The hook on the wire sees one bf16 bucket for each optimizer's group
    a step, of 2 bytes a gradient entry, with or without accumulation
    (the microbatches add up in f32 before the one reduction); without
    ``--grad_dtype`` the bucket is the gradients' own dtype (f32, or f64
    for the step this module takes in f64)."""
    targs = runs["targs"]
    state = tcli.load_checkpoint(targs, CPU)
    sizes = [sum(p.numel() for p in group)
             for group in (tholycow.g_trainable(state),
                           tholycow.d_trainable(state))]
    name = "bf16" if accum == 1 else "bf16_accum2"
    assert runs["wire"][name] == [["torch.bfloat16", 2 * n] for n in sizes]
    plain = "explicit" if accum == 1 else "explicit_accum2"
    dtype = torch.float64 if STEP_JOBS[plain][3] else torch.float32
    assert runs["wire"][plain] == [[str(dtype), dtype.itemsize * n]
                                   for n in sizes]


def test_bf16_with_accumulation_matches_the_f32_wire(runs):
    """``--grad_dtype bfloat16 --grad_accum_steps 2`` against
    ``--explicit_grad_reduce --grad_accum_steps 2`` (the same shard-then-
    microbatch split, ``tests/test_parallel.py``'s baseline): the same
    forward (losses within 1e-5) and parameters within JAX's bf16
    bounds."""
    got = runs["ranks"]["bf16_accum2"]
    want = runs["ranks"]["explicit_accum2"]
    for name, value in _flat_scalars(want).items():
        np.testing.assert_allclose(_flat_scalars(got)[name], value,
                                   rtol=SELF_RTOL, err_msg=name)
    differ = 0
    for k in want:
        if k.startswith("params::"):
            np.testing.assert_allclose(got[k], want[k], rtol=BF16_PARAM_RTOL,
                                       atol=BF16_PARAM_ATOL, err_msg=k)
            differ += not np.array_equal(got[k], want[k])
    assert differ       # the bf16 wire rounded something


def test_a_missing_gradient_all_reduce_is_caught(runs):
    """The planted fault (the global moments' backward without its
    all-reduce, so each rank keeps only its own loss's gradient of the
    statistics): the forward is unchanged (losses and BatchNorm statistics
    as (a)'s), and both towers' gradients read far above (a)'s gate."""
    got = runs["ranks"]["default_aug_unreduced"]
    want = runs["one"]["default_aug"]
    for name, value in runs["one_scalars"]["default_aug"].items():
        np.testing.assert_allclose(_flat_scalars(got)[name], value,
                                   rtol=SELF_RTOL, err_msg=name)
    for tower in ("identity_encoder", "pose_encoder"):
        keys = [k for k in want if k.startswith(
            f"opt_state_g::0::mu::embedder::{tower}::")]
        assert keys
        gap = np.sqrt(sum(mt._l2(got[k] - want[k]) ** 2 for k in keys)) \
            / np.sqrt(sum(mt._l2(want[k]) ** 2 for k in keys))
        print(f"{tower} gradient, unreduced moments' backward: {gap:.3g} "
              "of its L2")
        assert gap > 1e3 * SELF_RTOL, (tower, gap)


# --- (e) the global moments' gradient ---------------------------------------------

def test_global_moments_gradient_matches_one_process(runs):
    """Each rank's gradient of a loss of the global batch's moments (each
    rank with weights of its own) against autograd through one process's
    concatenation, to 1e-6."""
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(4, 6, 3, 5, generator=gen) * 2.0 + 0.5
    weights = torch.randn(WORLD, 2, 6, generator=gen)
    x = x.clone().requires_grad_()
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp(x.square().mean(dim=(0, 2, 3)) - mean.square(), min=0)
    loss = sum((mean * weights[r, 0]).sum() + (var * weights[r, 1]).sum()
               for r in range(WORLD))
    loss.backward()
    for rank in range(WORLD):
        got = np.load(runs["workdir"] / f"moments{rank}.npy")
        want = x.grad[parallel.local_rows(4, 1, rank, WORLD)].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_local_rows_lay_out_the_global_microbatches():
    """Rank r's k-way split of its rows is its part of each global
    microbatch (the JAX step's microbatch i: rows [i·B/k, (i+1)·B/k))."""
    rows = [parallel.local_rows(8, 2, r, 2).tolist() for r in range(2)]
    assert rows == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert parallel.local_rows(8, 1, 1, 2).tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="does not split"):
        parallel.local_rows(6, 2, 0, 2)


def test_rank_zero_alone_reaches_no_collective(runs, monkeypatch):
    """What rank 0 runs alone (the visuals' and probes' eval forward, with
    train-form BatchNorm too, and ê) reaches no collective: with a group of
    two up and every collective made to raise, both run."""
    def refuse(*args, **kwargs):
        raise AssertionError("a collective on rank 0 alone")

    dist = torch.distributed
    for name in ("all_reduce", "broadcast", "all_gather", "barrier", "send",
                 "recv", "broadcast_object_list", "all_gather_object"):
        monkeypatch.setattr(dist, name, refuse)
    monkeypatch.setattr(parallel, "initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: WORLD)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 0)
    targs = runs["targs"]
    state = tcli.load_checkpoint(targs, CPU)
    for train_form in (False, True):
        targs.set_eval_mode_in_test = not train_form
        out = tloop.make_eval_forward(targs)(state, runs["batch"])
        assert np.isfinite(out["fake_rgbs"].numpy()).all()
    loader = [({"enc_rgbs": runs["batch"]["enc_rgbs"]}, {})]
    e_hat = tft.compute_averaged_identity_embedding(state, loader, CPU)
    assert e_hat.shape == (1, targs.embed_channels)


# --- (f), (g) the CLIs ------------------------------------------------------------

TINY = ["--image_size", "32", "--num_channels", "4", "--max_num_channels",
        "16", "--embed_channels", "16", "--pose_embedding_size", "8",
        "--dis_num_blocks", "3", "--gen_num_residual_blocks", "1",
        "--num_enc_frames", "2"]


# the module's tower cut in a CLI's process and the ranks it spawns
CUT_SITE = f'''
import functools, sys
sys.modules["jax"] = None
from latentpose_tpu_torch.nn import backbones
from latentpose_tpu_torch.models.embedders import (
    unsupervised_pose_separate_embResNeXt_segmentation as embedder)
backbones.MobileNetV2.SETTINGS = tuple(
    (t, c, 1, s) for t, c, _, s in backbones.MobileNetV2.SETTINGS)
embedder.ResNeXt50 = functools.partial(backbones.ResNeXt50,
                                       layers={tuple(mt.LAYERS)})
'''


def _run_cli(module, argv, workdir, name, site="", **env):
    """``python -m module argv`` (which starts its own ranks) with the tower
    cut (and ``site``) in a ``sitecustomize``, killed with its ranks at
    CLI_TIMEOUT; its output on failure."""
    site_dir = workdir / f"{name}.site"
    site_dir.mkdir()
    (site_dir / "sitecustomize.py").write_text(CUT_SITE + site)
    env = _env(**env)
    env["PYTHONPATH"] = os.pathsep.join([str(site_dir), env["PYTHONPATH"]])
    log_path = workdir / f"{name}.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", module, *argv], cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True, env=env)
        code, = _wait_all([proc], CLI_TIMEOUT, f"{module} {name}")
    if code:
        pytest.fail(f"{module} exited {code}:\n"
                    + log_path.read_text()[-4000:])
    return log_path.read_text()


@pytest.fixture(scope="module")
def cli_meta(tmp_path_factory):
    """``cli.train --num_devices 2`` on the CPU: 2 meta steps from a seeded
    init (global batch 4), rank 0's visuals and probes every step and
    validation after the epoch."""
    workdir = tmp_path_factory.mktemp("parallel_cli")
    argv = ["--config_name", "default", "--dataloader", "synthetic",
            "--device", "cpu", "--num_devices", str(WORLD),
            "--allow_random_vgg", *TINY, "--batch_size", str(BATCH),
            "--synthetic_num_labels", "8", "--num_epochs", "1",
            "--log_frequency_images", "1", "--log_frequency_fixed_images",
            "1", "--fixed_val_ids", "1", "--no-skip_eval",
            "--experiments_dir", str(workdir / "exp")]
    log = _run_cli("latentpose_tpu_torch.cli.train", argv, workdir, "train")
    return workdir, argv, log


def test_cli_trains_on_two_ranks_and_one_process_resumes(cli_meta):
    """Two meta steps on two ranks write exactly one checkpoint (rank 0's)
    and rank 0's visuals; one process loads it and takes the next step."""
    workdir, argv, log = cli_meta
    ckpts = sorted((workdir / "exp").glob("*/checkpoints/*.ckpt"))
    assert [c.name for c in ckpts] == ["model_00000002.ckpt"], log[-2000:]
    images = list((workdir / "exp").glob("*/**/*.png"))
    assert images, "rank 0 rendered no visuals"
    saved = tcli.ckpt_lib.peek_args(ckpts[0])
    assert saved["num_devices"] == WORLD and saved["batch_size"] == BATCH
    args = tcli.resolve_args(["--checkpoint_path", str(ckpts[0]),
                              "--num_devices", "1", "--device", "cpu",
                              "--experiments_dir", str(workdir / "one")])
    state = tcli.load_checkpoint(args, CPU)
    assert state.step == 2 and state.opt_g.count == 2
    loader = tcli.build_dataloader(args)
    step = tcli.make_step(args, tcli.build_criteria(args, CPU))
    scalars = step(state, tholycow.to_device(loader.get_batch(0), CPU,
                                             tholycow.META_STEP_KEYS))
    assert state.step == 3
    assert all(np.isfinite(float(v)) for v in scalars.values())


def test_cli_saves_once_when_its_ranks_are_signalled(tmp_path):
    """SIGTERM to ``cli.train --num_devices 2`` (passed on to both ranks)
    while it trains: the ranks agree at the next step boundary, rank 0
    saves one checkpoint at that step, and the run exits 0."""
    site_dir = tmp_path / "site"
    site_dir.mkdir()
    (site_dir / "sitecustomize.py").write_text(CUT_SITE)
    env = _env()
    env["PYTHONPATH"] = os.pathsep.join([str(site_dir), env["PYTHONPATH"]])
    log_path = tmp_path / "train.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "latentpose_tpu_torch.cli.train",
             "--config_name", "default", "--dataloader", "synthetic",
             "--device", "cpu", "--num_devices", str(WORLD),
             "--allow_random_vgg", *TINY, "--batch_size", str(BATCH),
             "--synthetic_num_labels", "8", "--num_epochs", "1000",
             "--save_frequency", "0", "--experiments_dir",
             str(tmp_path / "exp")], cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True, env=env)
        deadline = time.monotonic() + CLI_TIMEOUT
        while "iteration 1:" not in log_path.read_text():
            if proc.poll() is not None or time.monotonic() > deadline:
                _kill_group(proc)
                pytest.fail("no second step:\n"
                            + log_path.read_text()[-3000:])
            time.sleep(0.5)
        proc.send_signal(signal.SIGTERM)
        code, = _wait_all([proc], CLI_TIMEOUT, "signalled cli.train")
    text = log_path.read_text()
    assert code == 0, text[-3000:]
    ckpts = list((tmp_path / "exp").glob("*/checkpoints/*.ckpt"))
    assert len(ckpts) == 1, text[-3000:]
    saved = int(ckpts[0].name[len("model_"):-len(".ckpt")])
    assert saved >= 2 and f"iteration {saved}:" not in text


def test_cli_finetunes_on_two_ranks(cli_meta):
    """``cli.train --finetune --num_devices 2`` from the two ranks' meta
    checkpoint: rank 0 computes ê over the whole avatar and hands it to
    rank 1, both take the fine-tune steps, rank 0 saves one fine-tuned
    checkpoint."""
    workdir, _, _ = cli_meta
    meta_ckpt, = (workdir / "exp").glob("*/checkpoints/*.ckpt")
    _run_cli("latentpose_tpu_torch.cli.train", [
        "--finetune", "--checkpoint_path", str(meta_ckpt), "--config_name",
        "finetuning-base", "--dataloader", "synthetic", "--device", "cpu",
        "--num_devices", str(WORLD), "--allow_random_vgg", "--batch_size",
        str(BATCH), "--num_epochs", "1", "--experiments_dir",
        str(workdir / "ft2")], workdir, "finetune")
    ckpt, = (workdir / "ft2").glob("*/checkpoints/*.ckpt")
    assert tcli.checkpoint_is_finetuned(ckpt)
    flat = tcli.ckpt_lib.load_arrays(ckpt)
    assert np.isfinite(flat["params::finetune_embedding"]).all()


DRIVE_SITE = '''
import os
for name in ("cv2", "imageio"):
    sys.modules[name] = None     # PNG frames: the video's bytes, lossless
from latentpose_tpu_torch.runners import drive as _drive
_sequence = _drive.drive_sequence


def drive_sequence(*args, **kwargs):
    out = _sequence(*args, **kwargs)
    if out is not None:
        import numpy as np
        np.save(os.environ["LP_DRIVE_OUT"], out)
    return out


_drive.drive_sequence = drive_sequence
'''


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_cli_drives_on_two_ranks_as_one_process(cli_meta, tmp_path,
                                                quantize):
    """``cli.drive --num_devices 2`` in bf16 (and int8) writes the frames
    one process writes, bit for bit, from the same float outputs."""
    workdir, _, _ = cli_meta
    ckpt = _finetuned(workdir)
    flags = ["--images_paths", "synthetic://3", "--device", "cpu",
             "--drive_batch_size", "8", "--compute_dtype", "bfloat16"]
    if quantize:
        flags += ["--quantize", quantize]
    outs = {}
    for n in (1, WORLD):
        dest = tmp_path / f"world{n}"
        _run_cli("latentpose_tpu_torch.cli.drive",
                 [str(ckpt), *flags, "--destination", str(dest),
                  "--num_devices", str(n)], tmp_path, f"drive{n}",
                 DRIVE_SITE, LP_DRIVE_OUT=str(tmp_path / f"world{n}.npy"))
        frames = sorted((dest / "synthetic_3.mp4.frames").glob("*.png"))
        assert len(frames) == 32
        outs[n] = (np.load(tmp_path / f"world{n}.npy"),
                   [f.read_bytes() for f in frames])
    np.testing.assert_array_equal(outs[WORLD][0], outs[1][0])
    assert outs[WORLD][1] == outs[1][1]


def _finetuned(workdir):
    """A fine-tuned checkpoint from the CLI's meta checkpoint (ê drawn),
    written once."""
    path = workdir / "ft" / "checkpoints" / "model_00000002.ckpt"
    if not path.exists():
        meta_ckpt, = (workdir / "exp").glob("*/checkpoints/*.ckpt")
        args = tcli.resolve_args(["--checkpoint_path", str(meta_ckpt),
                                  "--finetune", "--num_devices", "1",
                                  "--device", "cpu"])
        state = tcli.load_checkpoint(args, CPU)
        e_hat = torch.randn(1, args.embed_channels,
                            generator=torch.Generator().manual_seed(3))
        state = tft.enable_finetuning(state, args, e_hat)
        args.experiment_dir = str(workdir / "ft")
        tcli.save(args, state)
    return path


# --- the launcher and the world size -------------------------------------------------

def test_launch_returns_a_result_larger_than_a_pipe():
    """``launch.run`` reads rank 0's result while the ranks run: a result
    whose pickle is larger than the pipe's 64 KiB (rank 0's ``put`` blocks
    until it is read) comes back whole, and the run ends."""
    code = ("from latentpose_tpu_torch.parallel import launch\n"
            "names = launch.run('torch_launch_payload', ['20000'], 2)\n"
            "assert names[-1] == 'frame_00019999.png', names[-1:]\n"
            "print('received', len(names))\n")
    env = _env()
    env["PYTHONPATH"] = os.pathsep.join([str(WORKER.parent),
                                         env["PYTHONPATH"]])
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True, env=env)
    try:
        out, _ = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        _kill_group(proc)
        pytest.fail("launch.run did not end: rank 0 waits on its result")
    assert proc.returncode == 0 and "received 20000" in out, out[-3000:]


def test_cli_takes_every_visible_card_by_default(meta, monkeypatch):
    """``--num_devices 0`` (the default) with ``--device cuda`` starts a
    rank for every visible card, as the JAX CLI's mesh takes every device;
    on the CPU it is one process, and a count given is the count."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    started = []
    monkeypatch.setattr(tcli.launch, "run", lambda module, argv, world:
                        started.append((module, world)) or "launched")
    assert tcli.main(["--checkpoint_path", str(meta[1]), "--device", "cuda",
                      "--num_devices", "0", "--batch_size", "4"]) \
        == "launched"
    assert started == [("latentpose_tpu_torch.cli.train", 2)]
    assert parallel.requested_world(0, "cuda") == 2
    assert parallel.requested_world(None, "cpu") == 1
    assert parallel.requested_world(0) == 1         # drive: one device
    assert parallel.requested_world(1, "cuda") == 1


# --- (h) refusals -------------------------------------------------------------------

@pytest.mark.parametrize("flags,match", [
    (["--num_devices", "3", "--batch_size", "4"], "does not split over 3"),
    (["--num_devices", "2", "--batch_size", "4", "--grad_accum_steps", "4"],
     "must divide --batch_size 4 / 2 ranks"),
    (["--explicit_grad_reduce"], "need a device mesh"),
    (["--grad_dtype", "bfloat16"], "need a device mesh"),
])
def test_cli_refuses_what_does_not_split(meta, flags, match):
    with pytest.raises(ValueError, match=match):
        tcli.resolve_args(["--checkpoint_path", str(meta[1]), "--device",
                           "cpu", *flags])


def test_cli_refuses_more_ranks_than_cards(meta, monkeypatch):
    """Two ranks on one card are refused, as the JAX package's
    ``create_mesh`` refuses them (NCCL runs one rank a card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="Requested 2 devices, only 1 "
                                         "visible"):
        tcli.resolve_args(["--checkpoint_path", str(meta[1]),
                           "--num_devices", "2", "--batch_size", "4"])
    with pytest.raises(ValueError, match="Requested 2 devices, only 1 "
                                         "visible"):
        tdrive_cli.resolve_args([str(meta[1]), "--num_devices", "2"])
