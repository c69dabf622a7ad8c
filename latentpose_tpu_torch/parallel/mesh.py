"""Data parallelism over ``torch.distributed``: one process a device (port
of the data-parallel half of ``latentpose_tpu/parallel/mesh.py``).

The JAX package runs one program over a 1-D mesh of devices; here each
rank is a process that drives one device, and the collectives the JAX
compiler inserts are written out:

- :func:`init_process_group` joins the group that torchrun's environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
  ``MASTER_PORT``) or the launcher (``parallel/launch.py``) describes, NCCL
  on ``cuda:LOCAL_RANK``, gloo on the CPU, and refuses a rank without a
  card of its own (``create_mesh``'s "Requested n devices, only k
  visible");
- :func:`shard_batch` / :func:`local_rows`: the rank's rows of a global
  batch (``shard_batch``); :func:`replicate`: rank 0's state on every rank
  (``replicate``), with :func:`assert_replicated`'s checksums;
- :func:`reduce_grads`: the gradient mean, one flattened bucket a group,
  cast for the wire only (the JAX step's ``pmean``, or XLA's all-reduce in
  the default regime);
- :func:`global_batch`: while it is active, train-form BatchNorm
  (``nn/backbones.py``), the conv_bn link's statistics and dice take their
  sums over the global batch (:func:`all_reduce_sum`, with its gradient),
  and the dropout masks are the global batch's rows (:func:`sync`).

A rank reads :func:`rank` and :func:`world`, which are 0 and 1 without a
process group and inside :func:`local_view`, where rank 0 alone builds
loaders over the whole data (validation, ê).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from datetime import timedelta

import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
TIMEOUT = timedelta(minutes=10)    # a collective that waits longer raises


# the world size of the active global batch (:func:`global_batch`), or None
_SYNC = contextvars.ContextVar("latentpose_global_batch", default=None)
_LOCAL = contextvars.ContextVar("latentpose_local_view", default=False)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """The number of ranks (1 without a process group, or in
    :func:`local_view`)."""
    return dist.get_world_size() if initialized() and not _LOCAL.get() \
        else 1


def rank() -> int:
    """This process's rank (0 without a process group, or in
    :func:`local_view`)."""
    return dist.get_rank() if initialized() and not _LOCAL.get() else 0


def is_main() -> bool:
    return not initialized() or dist.get_rank() == 0


@contextlib.contextmanager
def local_view():
    """Inside, :func:`rank` and :func:`world` read 0 and 1: what rank 0
    builds there (a loader) covers the whole data, as one process's."""
    token = _LOCAL.set(True)
    try:
        yield
    finally:
        _LOCAL.reset(token)


def launched() -> bool:
    """Whether this process is a rank of a launched group (torchrun's
    environment, or the launcher's)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def requested_world(num_devices, device_type=None) -> int:
    """The world size of a run: the launcher's or torchrun's
    ``WORLD_SIZE`` inside a launched group (whatever ``--num_devices`` a
    resumed checkpoint saved), else ``--num_devices``.  0 or None reads as
    every visible card where ``device_type`` is ``cuda`` (the JAX train
    CLI's ``len(jax.devices())``), else as 1 (the CPU, and drive, whose
    JAX CLI reads it so)."""
    if launched():
        return int(os.environ["WORLD_SIZE"])
    if num_devices:
        return int(num_devices)
    if device_type == "cuda" and torch.cuda.is_available():
        return max(torch.cuda.device_count(), 1)
    return 1


def check_devices(device_type: str, n: int):
    """``create_mesh``'s check: ``n`` ranks on this host need ``n`` cards
    (one card a rank: NCCL refuses two ranks on one card).  The CPU takes
    any number: each rank is a process on the host's cores."""
    if device_type != "cuda":
        return
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > visible:
        raise ValueError(f"Requested {n} devices, only {visible} visible")


def init_process_group(device) -> torch.device:
    """Join the launched group on ``device``'s type: NCCL on
    ``cuda:LOCAL_RANK``, gloo on the CPU.  Returns the rank's device.  A
    failed init raises (no rank carries on alone)."""
    device = torch.device(device)
    missing = [k for k in ENV if k != "LOCAL_RANK" and k not in os.environ]
    if missing:
        raise RuntimeError(f"no process group to join: {missing} unset "
                           "(run under torchrun or --num_devices N)")
    rank_, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank_))
    if device.type == "cuda":
        check_devices("cuda", local + 1)
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {device}")
    url = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=url, world_size=size,
                            rank=rank_, timeout=TIMEOUT, **kwargs)
    return device


def destroy_process_group():
    if initialized():
        dist.destroy_process_group()


def barrier():
    if initialized():
        dist.barrier()


# --- rows --------------------------------------------------------------------

def local_rows(size: int, microbatches: int = 1, rank_=None, world_=None):
    """The rank's rows of a global batch of ``size`` rows laid out in
    ``microbatches`` microbatches: microbatch i is global rows [i·size/k,
    (i+1)·size/k) (the JAX step's split), and rank r holds its r-th
    ``size / (k·world)`` of each, so that the rank's own k-way split of its
    rows gives its part of every global microbatch.  A LongTensor."""
    r = rank() if rank_ is None else rank_
    n = world() if world_ is None else world_
    k = microbatches
    if size % (k * n):
        raise ValueError(f"a global batch of {size} rows does not split "
                         f"into {k} microbatches over {n} ranks")
    m = size // (k * n)
    return torch.cat([torch.arange(i * size // k + r * m,
                                   i * size // k + (r + 1) * m)
                      for i in range(k)])


def shard_batch(batch, microbatches: int = 1, rank_=None, world_=None):
    """The rank's rows (:func:`local_rows`) of every array or tensor of a
    global batch dict."""
    size = len(next(iter(batch.values())))
    rows = local_rows(size, microbatches, rank_, world_)
    out = {}
    for key, value in batch.items():
        out[key] = value[rows.to(value.device)] \
            if isinstance(value, torch.Tensor) else value[rows.numpy()]
    return out


def take_rows(tree, rows):
    """``tree`` (dicts, tuples, tensors, None) with each tensor cut to
    ``rows`` of its first dimension."""
    if isinstance(tree, dict):
        return {k: take_rows(v, rows) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(take_rows(v, rows) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree[rows.to(tree.device)]
    return tree


# --- the global batch --------------------------------------------------------

@contextlib.contextmanager
def global_batch(active: bool = True):
    """While active (and a process group is up), BatchNorm, the link's
    statistics, dice and dropout see the global batch (module
    docstring)."""
    token = _SYNC.set(world() if active and initialized() else None)
    try:
        yield
    finally:
        _SYNC.reset(token)


def sync():
    """The world size of the active :func:`global_batch`, or None."""
    return _SYNC.get()


class _AllReduceSum(torch.autograd.Function):
    """Σ over ranks; its backward sums the upstream gradients over ranks,
    since every rank's loss reads the sum."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x):
    """Σ of ``x`` over the ranks, differentiable."""
    return _AllReduceSum.apply(x)


class _GlobalMeanVar(torch.autograd.Function):
    """(mean, biased variance) of the global batch from this rank's
    (Σx, Σx²) (2, C) and the global row count.  Forward: one all-reduce of
    the sums in f32, then flax's one-pass variance clamped at 0, taken in
    f64 from the summed f32 sums and rounded once to f32.  Backward: one
    all-reduce of the two upstream gradients (g_mean, g_var), then the
    sums' gradient from those totals.

    The f64 step: the cross-rank sum and the division round once more than
    one process's ``mean`` does, and a network of train-form BatchNorms
    amplifies its statistics' rounding (one f32 ulp of a statistic moves
    the cut ResNeXt-50's gradients by about 1e-4 of their norm): in f32 the
    two ranks' identity-tower gradients sat 7e-4 from one process's, in f64
    as close as one process's own f32 rounding (2e-6)."""

    @staticmethod
    def forward(ctx, sums, count):
        sums = sums.clone()
        dist.all_reduce(sums)
        s64 = sums.double()
        mean = s64[0] / count
        var = torch.clamp(s64[1] / count - mean.square(), min=0.0)
        mean, var = mean.float(), var.float()
        ctx.save_for_backward(mean, var)
        ctx.count = count
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        mean, var = ctx.saved_tensors
        grads = torch.stack([g_mean, torch.where(var > 0, g_var,
                                                 torch.zeros_like(g_var))])
        dist.all_reduce(grads)
        g_mean, g_var = grads / ctx.count
        return torch.stack([g_mean - 2.0 * mean * g_var, g_var]), None


def global_mean_var(sums, rows: int):
    """(mean, biased variance) over the global batch, differentiable, from
    this rank's per-channel (Σx, Σx²) ``sums`` (2, C) f32 over ``rows``
    rows (the same count on every rank)."""
    return _GlobalMeanVar.apply(sums, rows * sync())


def global_moments(x, dims):
    """Per-channel mean and biased variance over ``dims`` of the global
    batch: this rank's (Σx, Σx²) in f32, summed over ranks, then flax's
    one-pass variance clamped at 0 (:func:`global_mean_var`)."""
    x32 = x.float()
    sums = torch.stack([x32.sum(dim=dims), x32.square().sum(dim=dims)])
    return global_mean_var(sums, x32.numel() // sums.shape[1])


# --- the step's reductions ---------------------------------------------------

def reduce_grads(grads, dtype=None, on_wire=None):
    """The mean over ranks of one group's gradients: one flattened bucket,
    cast to ``dtype`` (if given) for the all-reduce only, returned in the
    gradients' own dtype and shapes.  ``on_wire(bucket)`` (if given) sees
    the bucket as it goes on the wire."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    bucket = flat if dtype is None else flat.to(dtype)
    if on_wire is not None:
        on_wire(bucket)
    dist.all_reduce(bucket)
    flat = bucket.to(flat.dtype) / dist.get_world_size()
    out, start = [], 0
    for g in grads:
        out.append(flat[start:start + g.numel()].view(g.shape))
        start += g.numel()
    return out


def mean_scalars(scalars):
    """{name: scalar tensor} averaged over ranks (one all-reduce)."""
    names = list(scalars)
    stacked = torch.stack([scalars[k].float() for k in names])
    dist.all_reduce(stacked)
    stacked /= dist.get_world_size()
    return dict(zip(names, stacked.unbind()))


def average_running_stats(models):
    """The explicit regime's ``pmean`` of the new BatchNorm statistics:
    each running statistic of ``models`` ({name: module}) averaged over
    ranks, in place."""
    stats = [buf for _, m in sorted(models.items())
             for name, buf in m.named_buffers() if "running" in name]
    if not stats:
        return
    flat = torch.cat([s.reshape(-1) for s in stats])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    start = 0
    with torch.no_grad():
        for s in stats:
            s.copy_(flat[start:start + s.numel()].view(s.shape))
            start += s.numel()


# --- the state ---------------------------------------------------------------

def state_tensors(state):
    """Every tensor of a train state, in one order on every rank: the
    modules' parameters and buffers, the EMA, the identity embedding and
    both optimizers' moments."""
    out = []
    for part in sorted(state.models):
        module = state.models[part]
        out += [p.data for _, p in sorted(module.named_parameters())]
        out += [b for _, b in sorted(module.named_buffers())]
    for part in sorted(state.ema_params):
        entry = state.ema_params[part]
        out += [entry[k] for k in sorted(entry)] if isinstance(entry, dict) \
            else [entry]
    if state.finetune_embedding is not None:
        out.append(state.finetune_embedding.data)
    for opt in (state.opt_g, state.opt_d):
        out += list(opt.mu) + list(opt.nu)
    return [t for t in out if t is not None]


def _buckets(tensors):
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return by_dtype.values()


def replicate(state):
    """Rank 0's train state on every rank, in place (one broadcast a dtype),
    with the step and optimizer counts; then :func:`assert_replicated`."""
    if not initialized():
        return state
    with torch.no_grad():
        for group in _buckets(state_tensors(state)):
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, 0)
            start = 0
            for t in group:
                t.copy_(flat[start:start + t.numel()].view(t.shape))
                start += t.numel()
    counts = [state.step, state.opt_g.count, state.opt_d.count]
    dist.broadcast_object_list(counts, 0)
    state.step, state.opt_g.count, state.opt_d.count = counts
    assert_replicated(state, "after replicate")
    return state


def checksum(state):
    """(Σx, Σx²) of each state tensor in f64, and the step and counts: a
    (2·n + 3,) f64 tensor on the state's device."""
    tensors = state_tensors(state)
    sums = [torch.stack([t.double().sum(), t.double().square().sum()])
            for t in tensors]
    device = tensors[0].device
    ints = torch.tensor([state.step, state.opt_g.count, state.opt_d.count],
                        dtype=torch.float64, device=device)
    return torch.cat(sums + [ints])


def assert_replicated(state, what: str):
    """Raise unless every rank holds the same state (:func:`checksum`)."""
    if not initialized():
        return
    ours = checksum(state)
    high, low = ours.clone(), ours.clone()
    dist.all_reduce(high, op=dist.ReduceOp.MAX)
    dist.all_reduce(low, op=dist.ReduceOp.MIN)
    differ = int((high != low).sum())
    if differ:
        raise RuntimeError(f"ranks hold different train states {what}: "
                           f"{differ} of {ours.numel()} checksums differ")


def broadcast_tensor(tensor, src: int = 0):
    """``tensor`` of rank ``src`` on every rank, in place; returns it."""
    if initialized():
        dist.broadcast(tensor, src)
    return tensor


def broadcast_object(obj, src: int = 0):
    """A picklable object of rank ``src``, on every rank."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def any_rank(flag: bool, device) -> bool:
    """True on every rank when ``flag`` is true on any (one all-reduce)."""
    if not initialized():
        return flag
    value = torch.tensor([int(flag)], device=device)
    dist.all_reduce(value, op=dist.ReduceOp.MAX)
    return bool(value.item())


def batch_layout(args) -> int:
    """How many microbatches a rank's rows are laid out in
    (:func:`local_rows`): ``--grad_accum_steps`` in the default regime,
    where microbatch i is the global batch's; 1 in the explicit regime,
    where each rank splits its own contiguous rows (as JAX's shard_map)."""
    return 1 if explicit_regime(args) else max(int(args.grad_accum_steps
                                                   or 1), 1)


def explicit_regime(args) -> bool:
    """``--explicit_grad_reduce``, or ``--grad_dtype bfloat16``, which
    implies it (as in the JAX step)."""
    return getattr(args, "grad_dtype", "float32") == "bfloat16" \
        or bool(getattr(args, "explicit_grad_reduce", False))
