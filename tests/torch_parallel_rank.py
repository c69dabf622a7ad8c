"""One rank of ``tests/test_torch_parallel.py``'s gloo runs, as a process
of its own (not a test module: pytest does not collect it).

    python tests/torch_parallel_rank.py SPEC.json

with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set.
SPEC names the meta checkpoint, the VGG towers' arrays, the output
directory and the jobs: each job resumes the checkpoint with its flags,
takes this rank's rows of its global batch (``.npz``) and one train step,
and rank 0 writes the state and the scalars (``<name>.npz``) and the
gradient buckets seen on the wire (``<name>.wire.json``); every rank writes
the bytes its state holds after the step (``<name>.resident<rank>.json``,
:func:`parallel.resident_bytes`, beside those of its slices and buffers).
The job ``moments`` writes each rank's gradient of a loss of
:func:`parallel.global_moments` (``moments<rank>.npy``), the job ``layout``
each rank's FSDP bucket checks (``layout<rank>.npz``).  The embedder's
towers are cut to ``SPEC["layers"]`` bottlenecks a stage (and MobileNetV2
to one block a row), as the test module cuts them.  A job with ``float64``
takes its step in f64 (:func:`float64_step`), one with ``fault`` with the
global moments' gradients left unreduced
(:func:`unreduced_moment_gradients`), or with ``fault`` "shard" each rank
updating its slice from its own unreduced gradient
(:func:`unreduced_shard_gradients`); one with ``save`` then saves the state
(every rank joins the gather) and resumes the checkpoint under its flags,
and records the bytes after each.
"""

import contextlib
import functools
import json
import sys
from pathlib import Path

import numpy as np
import torch

from latentpose_tpu_torch import convert
from latentpose_tpu_torch.cli import train as tcli
from latentpose_tpu_torch.losses.common.perceptual_loss import \
    load_tower_arrays
from latentpose_tpu_torch.models.embedders import (
    unsupervised_pose_separate_embResNeXt_segmentation as temb_mod)
from latentpose_tpu_torch.nn import backbones, blocks
from latentpose_tpu_torch.ops import adain as adain_op
from latentpose_tpu_torch.ops import conv_bn
from latentpose_tpu_torch.parallel import mesh as parallel
from latentpose_tpu_torch.runners import finetune as ft
from latentpose_tpu_torch.runners import holycow

CPU = torch.device("cpu")
TOWERS = ("perceptual_crit", "idt_embed_crit")


def cut_towers(layers):
    backbones.MobileNetV2.SETTINGS = tuple(
        (t, c, 1, s) for t, c, _, s in backbones.MobileNetV2.SETTINGS)
    temb_mod.ResNeXt50 = functools.partial(backbones.ResNeXt50,
                                           layers=tuple(layers))


@contextlib.contextmanager
def no_dropout():
    saved = backbones._dropout
    backbones._dropout = lambda x, rate, generator=None: x
    try:
        yield
    finally:
        backbones._dropout = saved


@contextlib.contextmanager
def float64_step(args, state, criteria):
    """The step in f64 wherever it computes in f32 (the state, the VGG
    towers, every ``.float()``, both kernels' plain versions), with fresh
    optimizers in f64: f32 rounding moves a ReLU input across 0 now and
    then, which moves that channel's gradients (and every one below it)
    far more than rounding does elsewhere."""
    saved = (torch.Tensor.float, blocks.adain,
             backbones.bn_relu_conv1x1_stats, args.compute_dtype)
    for module in state.models.values():
        module.double()
    state.ema_params = {part: {k: v.double() for k, v in tree.items()}
                        for part, tree in state.ema_params.items()}
    state.opt_g, state.opt_d = ft.optimizers(state, args)
    for crit in criteria:
        for attr in TOWERS:
            if hasattr(crit, attr):
                getattr(crit, attr).module.double()
    torch.Tensor.float = lambda self, *a, **k: self.double(*a, **k)
    holycow.DTYPES["float64"] = torch.float64
    args.compute_dtype = "float64"
    blocks.adain = adain_op.adain_reference
    backbones.bn_relu_conv1x1_stats = conv_bn.bn_relu_conv1x1_stats_reference
    try:
        yield
    finally:
        (torch.Tensor.float, blocks.adain, backbones.bn_relu_conv1x1_stats,
         args.compute_dtype) = saved
        del holycow.DTYPES["float64"]


def _unreduced_backward(ctx, g_mean, g_var):
    """``parallel._GlobalMeanVar``'s backward without its all-reduce: each
    rank keeps only its own loss's gradient of the global statistics."""
    mean, var = ctx.saved_tensors
    g_var = torch.where(var > 0, g_var, torch.zeros_like(g_var))
    g_mean, g_var = g_mean / ctx.count, g_var / ctx.count
    return torch.stack([g_mean - 2.0 * mean * g_var, g_var]), None


@contextlib.contextmanager
def unreduced_moment_gradients():
    """The planted fault of a job with ``fault``: the global moments'
    gradients are not summed over the ranks."""
    saved = parallel._GlobalMeanVar.backward
    parallel._GlobalMeanVar.backward = staticmethod(_unreduced_backward)
    try:
        yield
    finally:
        parallel._GlobalMeanVar.backward = saved


def _own_slice(grads, dtype=None, on_wire=None):
    """``parallel.reduce_scatter_grads`` without its reduce-scatter: this
    rank's slice of its own gradients."""
    bucket = parallel.Bucket(grads)
    return [bucket.shard(bucket.flatten(grads))]


@contextlib.contextmanager
def unreduced_shard_gradients():
    """The planted fault of a job with ``fault`` "shard": each rank updates
    its slice from its own unreduced gradient."""
    saved = parallel.reduce_scatter_grads
    parallel.reduce_scatter_grads = _own_slice
    try:
        yield
    finally:
        parallel.reduce_scatter_grads = saved


def _resident(state):
    """{resident: bytes the state holds, slices: bytes of its FSDP slices
    (parameters, EMA, moments), buffers: bytes of its modules' buffers}."""
    buffers = sum(b.numel() * b.element_size()
                  for m in state.models.values() for b in m.buffers())
    slices = 0
    if state.layout is not None:
        for name, group in state.layout.groups.items():
            count = 1 + (group.ema is not None) \
                + 2 * (name in state.layout.optimizers)
            slices += count * group.shard.numel() * group.shard.element_size()
    return {"resident": parallel.resident_bytes(state), "slices": slices,
            "buffers": buffers}


def _export(state):
    """The state as flat arrays (copies), gathered whole on every rank."""
    with parallel.gathered(state, whole=True):
        return {k: np.array(v) for k, v in
                convert.export_train_state(state).items()}


def step_job(spec, job, out):
    batch = dict(np.load(job["batch"]))
    argv = ["--checkpoint_path", spec["ckpt"], "--dataloader", "synthetic",
            "--device", "cpu", "--allow_random_vgg", "--num_epochs", "1",
            "--experiments_dir", spec["workdir"],
            "--batch_size", str(len(batch["label"])), *job["flags"]]
    args = tcli.resolve_args(argv)
    state = tcli.load_checkpoint(args, CPU)
    criteria = tcli.build_criteria(args, CPU)
    arrays = np.load(spec["towers"])
    for crit in criteria:
        for attr in TOWERS:
            if hasattr(crit, attr):
                load_tower_arrays(getattr(crit, attr).module, {
                    k.split("/", 1)[1]: arrays[k] for k in arrays.files
                    if k.startswith(attr + "/")})
    wire = []
    f64 = float64_step(args, state, criteria) if job["float64"] \
        else contextlib.nullcontext()
    dropout = contextlib.nullcontext() if job["dropout"] else no_dropout()
    fault = {None: contextlib.nullcontext, True: unreduced_moment_gradients,
             "shard": unreduced_shard_gradients}[job.get("fault")]()
    with f64, dropout, fault:
        replicated = _resident(state)
        tcli.place_state(args, state)
        step = holycow.make_train_step(
            criteria, args, on_wire=lambda bucket: wire.append(
                [str(bucket.dtype), bucket.numel() * bucket.element_size()]))
        if args.compute_dtype == "float64":
            batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                     for k, v in batch.items()}
        local = parallel.shard_batch(batch, parallel.batch_layout(args))
        scalars = step(state, holycow.to_device((local, {}), CPU,
                                                holycow.META_STEP_KEYS))
    parallel.assert_replicated(state, "after the step")
    resident = {"replicated": replicated, "step": _resident(state)}
    flat = _export(state)
    if job.get("save"):
        args.experiment_dir = str(out / f"{job['name']}.exp")
        path = tcli.save(args, state)
        resident["save"] = _resident(state)
        args = tcli.resolve_args(argv[:1] + [str(path)] + argv[2:])
        resumed = tcli.place_state(args, tcli.load_checkpoint(args, CPU))
        resident["resume"] = _resident(resumed)
        again = _export(resumed)
        assert set(again) == set(flat) and all(
            np.array_equal(again[k], flat[k]) for k in flat)
    (out / f"{job['name']}.resident{parallel.rank()}.json").write_text(
        json.dumps(resident))
    if parallel.rank() == 0:
        flat.update({f"scalar::{k}": np.array(float(v))
                     for k, v in scalars.items()})
        np.savez(out / f"{job['name']}.npz", **flat)
        (out / f"{job['name']}.wire.json").write_text(json.dumps(wire))


def moments_job(out):
    """A loss of the global batch's moments whose weights differ by rank;
    this rank's gradient w.r.t. its rows."""
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(4, 6, 3, 5, generator=gen) * 2.0 + 0.5
    weights = torch.randn(parallel.world(), 2, 6, generator=gen)
    local = x[parallel.local_rows(4)].clone().requires_grad_()
    with parallel.global_batch():
        mean, var = backbones.batch_moments(local)
    loss = (mean * weights[parallel.rank(), 0]).sum() \
        + (var * weights[parallel.rank(), 1]).sum()
    loss.backward()
    np.save(out / f"moments{parallel.rank()}.npy", local.grad.numpy())


def layout_job(out):
    """FSDP's buckets on this rank: a group of odd-sized tensors in f32 and
    f64 laid out, sliced, gathered back; one group's gradients
    reduce-scattered and all-reduced."""
    gen = torch.Generator().manual_seed(5)
    shapes = [(3, 5), (7,), (2, 2, 3), (1,), (4, 4)]
    got = {}
    for dtype in (torch.float32, torch.float64):
        tensors = [torch.randn(s, generator=gen, dtype=dtype)
                   for s in shapes]
        bucket = parallel.Bucket(tensors)
        flat = bucket.flatten(tensors)
        shard = bucket.shard(flat)
        full = bucket.gather(shard)
        name = str(dtype).split(".")[1]
        got[f"{name}::flat"] = flat.numpy()
        got[f"{name}::gathered"] = full.numpy()
        got[f"{name}::views"] = np.concatenate(
            [v.reshape(-1).numpy() for v in bucket.views(full)])
        got[f"{name}::offsets_bytes"] = np.array(
            [o * flat.element_size() for o in bucket.offsets]
            + [bucket.start * flat.element_size()])
        got[f"{name}::shard"] = shard.numpy()
        grads = [t * (parallel.rank() + 1) + 0.25 for t in tensors]
        got[f"{name}::scattered"] = parallel.reduce_scatter_grads(
            grads)[0].numpy()
        reduced = parallel.reduce_grads([g.clone() for g in grads])
        got[f"{name}::reduced_slice"] = bucket.shard(
            bucket.flatten(reduced)).numpy()
    np.savez(out / f"layout{parallel.rank()}.npz", **got)


def main():
    spec = json.loads(Path(sys.argv[1]).read_text())
    torch.set_num_threads(1)
    cut_towers(spec["layers"])
    parallel.init_process_group("cpu")
    out = Path(spec["out"])
    try:
        for job in spec["jobs"]:
            if job["name"] == "moments":
                moments_job(out)
            elif job["name"] == "layout":
                layout_job(out)
            else:
                step_job(spec, job, out)
    finally:
        parallel.destroy_process_group()


if __name__ == "__main__":
    main()
