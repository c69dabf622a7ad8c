"""Driving (inference) engine (port of ``latentpose_tpu/runners/drive.py``).

A fine-tuned avatar is puppeteered by a driver sequence: per frame batch,
pose encoder -> generator, with identity from the fine-tuned embedding.
Frames travel as uint8 where the source decodes to bytes and are rescaled on
the device.  With ``--quantize int8_static`` the generator's activation
scales come from a calibration pass (:func:`calibrate_quant_scales`).

Under N ranks (``parallel/mesh.py``) :func:`drive_sequence` gives batch k
of a sequence whole to rank k mod N and gathers the results on rank 0 in
order after the sequence, so that every batch is the one a single process
drives (the JAX package shards each batch's frames over its mesh
instead).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from latentpose_tpu_torch.parallel import mesh as parallel

from latentpose_tpu_torch.ops.spectral_norm import calibrating, quantized_convs


def load_quant_calib(generator, quant_calib):
    """Copy calibrated maxima ``{conv name: (C,) tensor}`` (what
    :func:`calibrate_quant_scales` returns) into the generator's quantized
    convs; every quantized conv must have one."""
    convs = quantized_convs(generator)
    if set(quant_calib) != set(convs):
        raise KeyError(f"calibration covers {sorted(quant_calib)}, the "
                       f"generator's quantized convs are {sorted(convs)}")
    with torch.no_grad():
        for name, conv in convs.items():
            conv.act_absmax.copy_(torch.as_tensor(quant_calib[name]))


def empty_quant_calib(models):
    """Zeroed maxima in the layout of :func:`calibrate_quant_scales`'s
    result, for a rank that receives rank 0's."""
    return {name: torch.zeros_like(conv.act_absmax)
            for name, conv in quantized_convs(models["generator"]).items()}


def compute_dtype(args):
    """The drive's compute dtype from ``args.compute_dtype``."""
    return torch.bfloat16 if getattr(args, "compute_dtype", "float32") \
        == "bfloat16" else torch.float32


class DriveModule(nn.Module):
    """The drive step as a module: a wire batch of driver frames ->
    (rgbs, segm).  It holds the embedder's pose encoder (not its identity
    tower, which drive does not run: an exported program keeps every
    weight of its module), the generator and the avatar's (1, E) identity
    as a buffer (``None`` where each call passes its own), so that
    ``torch.export`` can export it whole (``cli/export.py``).

    pose_frames (B, H, W, 3) on the modules' device, float in [0, 1] or
    uint8 (the wire format, rescaled as ``/255`` then cast to ``dtype``).
    Returns f32 (B, H, W, 3) rgbs and (B, H, W, 1) segmentation."""

    def __init__(self, embedder, generator, identity=None,
                 dtype=torch.float32):
        super().__init__()
        self.pose_encoder = embedder.pose_encoder
        self.generator = generator
        self.register_buffer("identity", identity)
        self.dtype = dtype

    def forward(self, pose_frames, identity=None):
        identity = self.identity if identity is None else identity
        if pose_frames.dtype == torch.uint8:
            x = (pose_frames.float() / 255.0).to(self.dtype)
        else:
            x = pose_frames.to(self.dtype)
        # the embedder's get_pose_embedding of each frame
        pose = self.pose_encoder(x.permute(0, 3, 1, 2))
        idt = identity.expand(x.shape[0], -1).to(self.dtype)
        rgbs, segm = self.generator(idt, pose.to(self.dtype))
        return rgbs.float(), segm.float()


def make_drive_fn(models, args, quant_calib=None):
    """The frame-batch driver: ``(state, pose_frames) -> (rgbs, segm)``,
    :class:`DriveModule` under ``torch.inference_mode``.

    ``state["finetune_embedding"]`` is the (1, E) identity on the models'
    device; pose_frames as :class:`DriveModule` takes them.
    ``quant_calib``: the calibrated activation maxima of an
    ``int8_static`` generator, loaded into it here.
    """
    if quant_calib is not None:
        load_quant_calib(models["generator"], quant_calib)
    module = DriveModule(models["embedder"], models["generator"],
                         dtype=compute_dtype(args))

    @torch.inference_mode()
    def drive_step(state, pose_frames):
        return module(pose_frames, state["finetune_embedding"])

    return drive_step


def _padded_batches(frames, batch_size):
    """(batch, frames kept) over ``frames``, the tail batch padded to
    ``batch_size`` by repeating its last frame (one batch shape; the int8
    path's dynamic scale is taken over the whole padded batch, as in the
    JAX package)."""
    for start in range(0, len(frames), batch_size):
        chunk = frames[start:start + batch_size]
        keep = len(chunk)
        if keep < batch_size:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], batch_size - keep, axis=0)])
        yield np.ascontiguousarray(chunk), keep


def calibrate_quant_scales(models, args, state, frames, batch_size=32):
    """The static-int8 calibration pass (``--quantize int8_static``): run
    the generator's quantized convs with the dynamic scale over ``frames``
    (f32 in [0, 1]) in batches of ``batch_size``, each conv keeping the
    running per-input-channel maximum of |x| from zero.  Returns
    ``{conv name: (C,) tensor}`` for :func:`make_drive_fn`'s
    ``quant_calib``."""
    generator = models["generator"]
    convs = quantized_convs(generator)
    if not convs:
        raise ValueError("calibration needs a quantized generator "
                         "(--quantize int8 or int8_static)")
    with torch.no_grad():
        for conv in convs.values():
            conv.act_absmax.zero_()
    step = make_drive_fn(models, args)
    device = state["finetune_embedding"].device
    with calibrating(generator):
        for chunk, _ in _padded_batches(frames, batch_size):
            step(state, torch.from_numpy(chunk).to(device))
    return {name: conv.act_absmax.detach().clone()
            for name, conv in convs.items()}


def drive_sequence(drive_fn, state, frames, batch_size=32):
    """Drive a whole sequence; frames (N, H, W, 3) host array.

    Returns (N, H, W, 3) f32 results.  The tail batch is padded to one batch
    shape.  Two batches stay in flight: batch k is read back only after
    batches k+1 and k+2 were queued, so the device queue stays fed while the
    host copies results.  On the card both copies go through pinned host
    memory without blocking: a copy from pageable memory would wait for
    every batch already queued on the stream and leave one in flight.

    Under N ranks each rank drives its batches k = rank (mod N) so, and
    rank 0 gathers the sequence (:func:`_gather`); the others return None.
    """
    rank, world = parallel.rank(), parallel.world()
    device = state["finetune_embedding"].device
    cuda = device.type == "cuda"
    in_flight, outputs = [], []
    for k, (chunk, keep) in enumerate(_padded_batches(frames, batch_size)):
        if k % world != rank:
            continue
        host = torch.from_numpy(chunk)
        if cuda:
            host = host.pin_memory()
        rgbs, _ = drive_fn(state, host.to(device, non_blocking=cuda))
        done = None
        if cuda:
            out = torch.empty(rgbs.shape, dtype=rgbs.dtype, pin_memory=True)
            out.copy_(rgbs, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            rgbs = out
        in_flight.append((rgbs, done, keep))
        if len(in_flight) > 2:
            outputs.append(_collect(*in_flight.pop(0)))
    outputs += [_collect(*batch) for batch in in_flight]
    if world > 1:
        return _gather(outputs, len(frames), batch_size, device)
    return np.concatenate(outputs, axis=0)


def _collect(rgbs, done, keep):
    """Wait for one batch's copy to the host (if any); its frames as numpy."""
    if done is not None:
        done.synchronize()
    return rgbs[:keep].numpy().copy()   # the pinned buffer goes back to the pool


def _gather(outputs, n_frames, batch_size, device):
    """Rank 0's sequence from every rank's batches (``outputs``: this
    rank's, in order): each other rank sends its frames in one tensor on
    ``device`` (the group's), and rank 0 puts batch k of rank k mod N back
    in its place.  None on the other ranks."""
    rank, world = parallel.rank(), parallel.world()
    keeps = [min(batch_size, n_frames - start)
             for start in range(0, n_frames, batch_size)]
    if rank:
        if outputs:
            dist.send(torch.from_numpy(np.concatenate(outputs)).to(device),
                      0)
        return None
    shape = outputs[0].shape[1:]        # batch 0 is rank 0's
    theirs = {0: iter(outputs)}
    for src in range(1, world):
        sizes = keeps[src::world]
        if not sizes:
            continue
        frames = torch.empty((sum(sizes), *shape), dtype=torch.float32,
                             device=device)
        dist.recv(frames, src)
        theirs[src] = iter(np.split(frames.cpu().numpy(),
                                    np.cumsum(sizes)[:-1]))
    return np.concatenate([next(theirs[k % world])
                           for k in range(len(keeps))], axis=0)
