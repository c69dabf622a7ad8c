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
  and the dropout masks are the global batch's rows (:func:`sync`);
- ``--param_sharding fsdp`` (the JAX package's ``_fsdp_spec`` /
  ``state_shardings`` / ``shard_state``): :func:`shard_state` lays each
  group of the state (the G-side trainables, the discriminator's, the
  frozen embedder of a fine-tune) out as one flat :class:`Bucket` and keeps
  this rank's 1/N slice of the parameters, the EMA and both optimizers'
  moments (:class:`ShardedState`); buffers stay replicated.
  :func:`gathered` all-gathers the buckets and points the modules'
  tensors at views of them, and frees them on exit;
  :func:`reduce_scatter_grads` is :func:`reduce_grads`' sharded form.

A rank reads :func:`rank` and :func:`world`, which are 0 and 1 without a
process group and inside :func:`local_view`, where rank 0 alone builds
loaders over the whole data (validation, ê).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
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


def all_reduce_max(x):
    """The elementwise maximum of ``x`` over the ranks (no gradient)."""
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return x


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
    the bucket as it goes on the wire.  An empty group (the ``none``
    discriminator's) has nothing to reduce."""
    if not grads:
        return []
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


# --- FSDP: the state sharded over the ranks ----------------------------------

# bytes: each tensor's offset in a bucket and each rank's slice.  The
# kernels' wrappers need 16; 256 puts each gathered weight on the
# boundary PyTorch's allocators give a tensor, so that cuDNN and cuBLAS
# see the alignment a replicated run's weights have
ALIGN = 256


class Bucket:
    """One group's tensors laid out flat: each tensor at an offset that is
    a multiple of :data:`ALIGN` bytes, the whole padded with zeros to a
    multiple of world x ALIGN bytes, so that rank r's slice [r·S, (r+1)·S)
    and every view into a gathered bucket start on an ALIGN-byte boundary.
    A function of the tensors' shapes and dtype and of the world alone: a
    group's gradients lay out as its tensors do."""

    def __init__(self, tensors, world_=None, rank_=None):
        self.dtype = tensors[0].dtype
        self.shapes = [t.shape for t in tensors]
        step = ALIGN // tensors[0].element_size()
        self.offsets, n = [], 0
        for t in tensors:
            if t.dtype != self.dtype:
                raise TypeError(f"one bucket holds one dtype: {t.dtype} "
                                f"beside {self.dtype}")
            self.offsets.append(n)
            n += -(-t.numel() // step) * step
        self.world = world() if world_ is None else world_
        rank_ = rank() if rank_ is None else rank_
        unit = step * self.world
        self.numel = -(-n // unit) * unit
        self.shard_numel = self.numel // self.world
        self.start = rank_ * self.shard_numel

    def flatten(self, tensors):
        """The padded bucket of ``tensors`` (this layout's shapes): one
        concatenation, the padding zeros."""
        ends = self.offsets[1:] + [self.numel]
        zeros = tensors[0].new_zeros(max(end - start - t.numel() for
                                         t, start, end in
                                         zip(tensors, self.offsets, ends)))
        pieces = []
        for t, start, end in zip(tensors, self.offsets, ends):
            pieces += [t.reshape(-1), zeros[:end - start - t.numel()]]
        return torch.cat(pieces)

    def views(self, flat):
        """Each tensor of the layout as a view into the padded ``flat``."""
        return [flat[start:start + math.prod(shape)].view(shape)
                for start, shape in zip(self.offsets, self.shapes)]

    def shard(self, flat):
        """This rank's slice of the padded ``flat``, a tensor of its own."""
        return flat[self.start:self.start + self.shard_numel].clone()

    def gather(self, shard):
        """The padded bucket from every rank's slice (one all-gather)."""
        full = torch.empty(self.numel, dtype=shard.dtype,
                           device=shard.device)
        dist.all_gather_into_tensor(full, shard)
        return full


def reduce_scatter_grads(grads, dtype=None, on_wire=None):
    """:func:`reduce_grads`' sharded form: the mean over ranks of this
    rank's slice of one group's gradients, laid out as the group
    (:class:`Bucket`), one reduce-scatter of the padded bucket cast to
    ``dtype`` (if given) for the wire only.  Returns ``[slice]`` in the
    gradients' dtype, what the group's optimizer over its shard takes.
    ``on_wire(bucket)`` (if given) sees the bucket as it goes on the
    wire.  An empty group (no bucket) has nothing to reduce."""
    if not grads:
        return []
    bucket = Bucket(grads)
    flat = bucket.flatten(grads)
    wire = flat if dtype is None else flat.to(dtype)
    if on_wire is not None:
        on_wire(wire)
    out = torch.empty(bucket.shard_numel, dtype=wire.dtype,
                      device=wire.device)
    dist.reduce_scatter_tensor(out, wire)
    return [out.to(flat.dtype) / dist.get_world_size()]


def _release(tensors):
    for t in tensors:
        t.data = torch.empty(0, dtype=t.dtype, device=t.device)


class _Group:
    """One bucket of the sharded state: the live tensors (the modules'
    parameters, or the identity embedding), their EMA tensors (or None),
    the layout and this rank's slices."""

    def __init__(self, live, ema):
        self.live, self.ema = live, ema
        self.bucket = Bucket(live)
        self.shard = self.bucket.shard(self.bucket.flatten(live))
        self.ema_shard = None if ema is None \
            else self.bucket.shard(self.bucket.flatten(ema))

    def point(self, tensors, flat):
        for t, view in zip(tensors, self.bucket.views(flat)):
            t.data = view


class ShardedState:
    """``TrainState.layout`` under ``--param_sharding fsdp``: the groups
    'g' (the G-side trainables, ``g_trainable``), 'd' (``d_trainable``)
    and, in a fine-tune, 'frozen' (the embedder), each one :class:`Bucket`
    of which this rank keeps its slice of the parameters, of their EMA
    ('g', 'frozen') and of the group's optimizer moments ('g', 'd'): the
    optimizers run over ``[slice]`` (``opt.params``, ``opt.mu``,
    ``opt.nu``).  Between :func:`gathered` contexts the modules'
    parameters, the EMA entries and the per-tensor moments hold no data;
    the modules' buffers stay whole and replicated."""

    def __init__(self, groups, optimizers):
        self.groups = groups            # {name: _Group}
        # {name: (optimizer, its per-tensor (params, mu, nu), its slices')}
        self.optimizers = optimizers
        self.active, self.whole = False, False

    def ema_pairs(self):
        """(EMA slices, live slices) of the groups with an EMA."""
        groups = [g for g in self.groups.values() if g.ema is not None]
        return [g.ema_shard for g in groups], [g.shard for g in groups]

    def gather(self, whole: bool):
        """Point the modules' parameters (and, if ``whole``, the EMA
        entries and the optimizers' per-tensor moments) at views of the
        gathered buckets: one all-gather a bucket."""
        with torch.no_grad():
            for group in self.groups.values():
                group.point(group.live, group.bucket.gather(group.shard))
                if whole and group.ema is not None:
                    group.point(group.ema,
                                group.bucket.gather(group.ema_shard))
            if whole:
                for name, (opt, tensors, _) in self.optimizers.items():
                    group = self.groups[name]
                    group.point(tensors[1], group.bucket.gather(opt.mu[0]))
                    group.point(tensors[2], group.bucket.gather(opt.nu[0]))
                    opt.params, opt.mu, opt.nu = tensors
        self.active, self.whole = True, whole

    def release(self):
        """Free the gathered buckets: the state is this rank's slices
        again."""
        for group in self.groups.values():
            _release(group.live)
            if group.ema is not None:
                _release(group.ema)
        for opt, tensors, slices in self.optimizers.values():
            _release(tensors[1] + tensors[2])
            opt.params, opt.mu, opt.nu = slices
        self.active, self.whole = False, False

    def assert_tiled(self, what: str):
        """Raise unless, in every bucket, the ranks' slices are disjoint,
        cover it, and hold the parameters, EMA and moments at the slice's
        size (one all-gather of every rank's (start, end, size))."""
        mine = []
        for name, group in self.groups.items():
            b = group.bucket
            sizes = {group.shard.numel()}
            if group.ema_shard is not None:
                sizes.add(group.ema_shard.numel())
            if name in self.optimizers:
                opt = self.optimizers[name][0]
                sizes |= {t.numel() for t in opt.params + opt.mu + opt.nu}
            if sizes != {b.shard_numel}:
                raise RuntimeError(f"bucket {name} {what}: slices of sizes "
                                   f"{sorted(sizes)}, not {b.shard_numel}")
            mine.append([b.start, b.start + b.shard_numel, b.numel])
        ours = torch.tensor(mine, dtype=torch.int64)
        every = [torch.empty_like(ours) for _ in range(dist.get_world_size())]
        dist.all_gather(every, ours)
        for i, name in enumerate(self.groups):
            spans = sorted(tuple(e[i].tolist()) for e in every)
            ends = [0] + [end for _, end, _ in spans]
            if [s for s, _, _ in spans] != ends[:-1] \
                    or ends[-1] != spans[0][2] \
                    or len({n for _, _, n in spans}) != 1:
                raise RuntimeError(f"bucket {name} {what}: the ranks' "
                                   f"slices {spans} do not tile it")


def shard_state(state, groups):
    """Shard a replicated train state in place over the ranks
    (``--param_sharding fsdp``): ``groups`` ({name: live tensors}, in the
    order of the optimizer over them, if any) each become a
    :class:`Bucket` of which this rank keeps its slice of the parameters,
    their EMA (``state.ema_params``, where each live tensor has one) and
    the moments of ``state.opt_g`` ('g') and ``state.opt_d`` ('d'); every
    full tensor is freed.  An empty group is left out (its optimizer holds
    nothing).  A world of 1 leaves the state as it is, as the
    JAX CLI without a mesh does.  Returns the state."""
    if world() == 1 or state.layout is not None:
        return state
    ema_of = {}
    leaves = state.finetune_leaves()
    for part, entry in state.ema_params.items():
        if part in leaves:
            ema_of[id(leaves[part])] = entry
        else:
            params = dict(state.models[part].named_parameters())
            ema_of.update({id(params[k]): v for k, v in entry.items()})
    with torch.no_grad():
        built = {}
        for name, live in groups.items():
            has = [id(t) in ema_of for t in live]
            if any(has) and not all(has):
                raise ValueError(f"group {name}: an EMA for some of its "
                                 "tensors and not for others")
            built[name] = _Group(list(live), [ema_of[id(t)] for t in live]
                                 if all(has) else None)
        optimizers = {}
        for name, opt in (("g", state.opt_g), ("d", state.opt_d)):
            if name not in built:       # an empty group: no moments
                continue
            group = built[name]
            if [id(p) for p in opt.params] != [id(t) for t in group.live]:
                raise ValueError(f"optimizer {name} is not over group "
                                 f"{name}'s tensors, in order")
            mu, nu = (group.bucket.shard(group.bucket.flatten(m))
                      for m in (opt.mu, opt.nu))
            optimizers[name] = (opt, (list(group.live), opt.mu, opt.nu),
                                ([group.shard], [mu], [nu]))
    state.layout = ShardedState(built, optimizers)
    state.layout.release()
    return state


@contextlib.contextmanager
def gathered(state, whole: bool = False):
    """Every rank enters: inside, the modules of a sharded state hold their
    whole parameters (and, with ``whole``, the EMA and both optimizers'
    per-tensor moments, so that the state reads as a replicated one); on
    exit the gathered buckets are freed.  A replicated state is left as
    it is."""
    layout = state.layout
    if layout is None:
        yield state
        return
    if layout.active:       # the inner release would free the outer views
        raise RuntimeError("a gather inside a gather of the same state")
    layout.gather(whole)
    try:
        yield state
    finally:
        layout.release()


def resident_bytes(state) -> int:
    """Bytes of the distinct storages that ``state`` holds: the modules'
    parameters and buffers, the EMA, the identity embedding, both
    optimizers' tensors and, sharded, its slices."""
    tensors = []
    for module in state.models.values():
        tensors += [p.data for p in module.parameters()]
        tensors += list(module.buffers())
    for entry in state.ema_params.values():
        tensors += list(entry.values()) if isinstance(entry, dict) \
            else [entry]
    tensors += [t.data for t in state.finetune_leaves().values()]
    for opt in (state.opt_g, state.opt_d):
        tensors += list(opt.params) + list(opt.mu) + list(opt.nu)
    if state.layout is not None:
        for group in state.layout.groups.values():
            tensors += [t for t in (group.shard, group.ema_shard)
                        if t is not None]
    storages = {}
    for t in tensors:
        if t.numel():
            storage = t.untyped_storage()
            storages[storage.data_ptr()] = storage.nbytes()
    return sum(storages.values())


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
    """Every tensor of a train state that each rank holds whole, in one
    order on every rank: the modules' parameters and buffers, the EMA, the
    identity embedding and both optimizers' moments; of a sharded state
    (:func:`shard_state`), the modules' buffers alone."""
    sharded = state.layout is not None
    out = []
    for part in sorted(state.models):
        module = state.models[part]
        if not sharded:
            out += [p.data for _, p in sorted(module.named_parameters())]
        out += [b for _, b in sorted(module.named_buffers())]
    if sharded:
        return out
    for part in sorted(state.ema_params):
        entry = state.ema_params[part]
        out += [entry[k] for k in sorted(entry)] if isinstance(entry, dict) \
            else [entry]
    out += [t.data for t in state.finetune_leaves().values()]
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
    with the step and optimizer counts; then :func:`assert_replicated`.
    A state is replicated before it is sharded."""
    if state.layout is not None:
        raise ValueError("replicate a train state before shard_state")
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
    """Raise unless every rank holds the same state (:func:`checksum`); of
    a sharded state, the same buffers, and slices of each bucket that are
    disjoint and cover it (:meth:`ShardedState.assert_tiled`)."""
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
    if state.layout is not None:
        state.layout.assert_tiled(what)


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
