"""Driving (inference) engine (port of ``latentpose_tpu/runners/drive.py``).

A fine-tuned avatar is puppeteered by a driver sequence: per frame batch,
pose encoder -> generator, with identity from the fine-tuned embedding.
Frames travel as uint8 where the source decodes to bytes and are rescaled on
the device.  Not ported yet: int8 serving with its calibration pass, and the
multi-device mesh.
"""

from __future__ import annotations

import numpy as np
import torch


def make_drive_fn(models, args):
    """The frame-batch driver: ``(state, pose_frames) -> (rgbs, segm)``.

    ``state["finetune_embedding"]`` is the (1, E) identity on the models'
    device; pose_frames (B, H, W, 3) on that device, float in [0, 1] or
    uint8 (the wire format, rescaled as ``/255`` then cast to the compute
    dtype).  Returns f32 (B, H, W, 3) rgbs and (B, H, W, 1) segmentation.
    """
    embedder, generator = models["embedder"], models["generator"]
    dtype = torch.bfloat16 if getattr(args, "compute_dtype", "float32") \
        == "bfloat16" else torch.float32

    @torch.inference_mode()
    def drive_step(state, pose_frames):
        if pose_frames.dtype == torch.uint8:
            x = (pose_frames.float() / 255.0).to(dtype)
        else:
            x = pose_frames.to(dtype)
        pose = embedder.get_pose_embedding(x[:, None])
        identity = state["finetune_embedding"]
        idt = identity.expand(x.shape[0], -1).to(dtype)
        rgbs, segm = generator(idt, pose.to(dtype))
        return rgbs.float(), segm.float()

    return drive_step


def drive_sequence(drive_fn, state, frames, batch_size=32):
    """Drive a whole sequence; frames (N, H, W, 3) host array.

    Returns (N, H, W, 3) f32 results.  The tail batch is padded to one batch
    shape.  Two batches stay in flight: batch k is read back only after
    batches k+1 and k+2 were queued, so the device queue stays fed while the
    host copies results.  On the card both copies go through pinned host
    memory without blocking: a copy from pageable memory would wait for
    every batch already queued on the stream and leave one in flight.
    """
    device = state["finetune_embedding"].device
    cuda = device.type == "cuda"
    in_flight, outputs = [], []
    for start in range(0, len(frames), batch_size):
        chunk = frames[start:start + batch_size]
        keep = len(chunk)
        if keep < batch_size:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], batch_size - keep, axis=0)])
        host = torch.from_numpy(np.ascontiguousarray(chunk))
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
    return np.concatenate(outputs, axis=0)


def _collect(rgbs, done, keep):
    """Wait for one batch's copy to the host (if any); its frames as numpy."""
    if done is not None:
        done.synchronize()
    return rgbs[:keep].numpy().copy()   # the pinned buffer goes back to the pool
