"""The epoch loop: host-side orchestration around the train step (port of
``latentpose_tpu/runners/loop.py``).

Per step: the batch from :func:`device_prefetch`, the step, the meters
(``Data_time``, ``Batch_time``, and the losses with ``--detailed_metrics``),
scalars every ``log_frequency_loss`` steps, a visual grid with the EMA
weights every ``log_frequency_images`` (with the cross-driving columns in
meta-training), the fixed-id probes every ``log_frequency_fixed_images``,
the saver, and a ``torch.profiler`` trace of steps [2, 2 + profile_steps) of
epoch 0 with ``--profile_dir`` (rank 0's).  After an epoch,
:func:`run_validation`.
A stop flag (set by the train CLI's signal handler) ends the epoch at the
next step boundary, where the state is whole.

Under N ranks (``--num_devices``) every rank runs the step, and rank 0
alone logs, renders the visuals and the fixed-id probes, validates and
saves: the train CLI hands the other ranks no writer and no saver.  None of
those reaches a collective (the eval forward's BatchNorms take local or
running statistics), so rank 0 may run them while the others wait in the
next step.  The stop flag is agreed on by every rank at each step boundary
(one all-reduce), so all stop after the same step.
"""

from __future__ import annotations

import logging
import random
import time
from pathlib import Path

import numpy as np
import torch
from torch.func import functional_call

from latentpose_tpu_torch.data import augmentation
from latentpose_tpu_torch.data.pipeline import Handoff, default_collate
from latentpose_tpu_torch.parallel import mesh as parallel
from latentpose_tpu_torch.runners.holycow import (compute_dtype,
                                                  finetune_inputs,
                                                  model_inputs)
from latentpose_tpu_torch.utils.meter import Meter
from latentpose_tpu_torch.utils.visualize import make_visual

logger = logging.getLogger("latentpose_tpu_torch.loop")

# the draw of the fixed probes' augmentation, keyed on (666, chunk start)
PROBE_SEED = 666
# the batch keys the eval forward reads
EVAL_KEYS = ("enc_rgbs", "enc_stickmen", "pose_input_rgbs", "dec_stickmen",
             "dec_keypoints")
# the keys a cross-driving column takes from the other driver's sample
DRIVER_KEYS = ("pose_input_rgbs", "dec_stickmen", "dec_keypoints",
               "target_rgbs", "real_segm")
# image keys that cross to the device as bytes under --transfer_dtype uint8
TRANSFER_IMAGE_KEYS = ("enc_rgbs", "pose_input_rgbs", "target_rgbs",
                       "real_segm", "enc_stickmen", "dec_stickmen")


def quantize_batch_u8(batch):
    """The host side of ``--transfer_dtype uint8``: each f32 image array in
    [0, 1] of TRANSFER_IMAGE_KEYS as ``uint8(x * 255 + 0.5)``; the step
    divides by 255 on the device (``runners/holycow.py`` ``dequantize``).
    Other values pass as they are."""
    out = dict(batch)
    for key in TRANSFER_IMAGE_KEYS:
        value = out.get(key)
        if getattr(value, "dtype", None) == np.float32:
            out[key] = (value * 255.0 + 0.5).astype(np.uint8)
    return out


def dequantize_batch_host(batch):
    """The wire's inverse on the host, for the paths that read raw loader
    batches (visuals, probes, validation, ê): every uint8 array as f32 / 255
    (true division, as the step's device dequantize)."""
    return {k: (np.asarray(v, np.float32) / 255.0
                if getattr(v, "dtype", None) == np.uint8 else v)
            for k, v in batch.items()}


def device_prefetch(dataloader, device, keys, depth=2,
                    transfer_dtype="float32"):
    """Iterate (host batch, device batch) pairs: the host batch is the
    loader's (data_dict | target_dict) of numpy arrays, the device batch
    holds the ``keys`` it has on ``device`` (labels as int64).

    A producer thread takes each batch from the loader, quantizes it with
    ``transfer_dtype`` uint8 (:func:`quantize_batch_u8`: a loader on the
    wire already emits bytes) and pins it (on the card); the consumer copies
    it with ``non_blocking=True`` on its current stream, so the copy of batch
    k+1 queues behind step k.  Up to ``depth`` batches wait in between."""
    cuda = device.type == "cuda"
    handoff = Handoff(depth)
    wire = transfer_dtype == "uint8"

    def produce():
        batches = iter(dataloader)
        try:
            for data_dict, target_dict in batches:
                host = {**data_dict, **target_dict}
                sent = quantize_batch_u8(host) if wire else host
                staged = {k: torch.from_numpy(np.ascontiguousarray(sent[k]))
                          for k in keys if k in sent}
                if cuda:
                    staged = {k: v.pin_memory() for k, v in staged.items()}
                yield host, staged
        finally:
            if hasattr(batches, "close"):   # stops the loader's own thread
                batches.close()

    handoff.run(produce)
    for host, staged in handoff:
        batch = {k: v.to(device, non_blocking=cuda) for k, v in staged.items()}
        batch["label"] = batch["label"].long()
        yield host, batch


def _host(outputs):
    return {k: v.float().cpu().numpy() for k, v in outputs.items()
            if v is not None}


def make_eval_forward(args):
    """``eval_forward(state, batch) -> {fake_rgbs, fake_segm,
    pose_embedding}`` (device tensors): the model with the EMA weights
    (``--weights_running_average``), no losses, no gradient, no
    spectral-norm step.  The embedder runs in eval form unless
    ``--no-set_eval_mode_in_test``; then its BatchNorms take the batch's
    statistics and its running statistics are left as they were.
    ``batch``: host arrays or tensors; the keys it reads are moved to the
    models' device."""
    train = not args.set_eval_mode_in_test
    use_ema = bool(args.weights_running_average)
    seed = args.random_seed
    dtype = compute_dtype(args)

    @torch.no_grad()
    def eval_forward(state, batch):
        embedder = state.models["embedder"]
        generator = state.models["generator"]
        device = next(generator.parameters()).device
        ema = state.ema_params if use_ema else {}
        batch = dequantize_batch_host(batch)

        inputs = model_inputs({k: torch.as_tensor(v).to(device)
                               for k, v in batch.items()
                               if k in EVAL_KEYS}, dtype)

        saved = {k: v.clone() for k, v in embedder.named_buffers()} \
            if train else None
        dropout = torch.Generator().manual_seed(seed) if train else None
        extra = {}
        try:
            if state.finetune:
                # the pose path alone (no identity frames in a fine-tune)
                _, _, pose = functional_call(
                    embedder, ema.get("embedder", {}),
                    (None, inputs["pose_input_rgbs"]),
                    {"train": train, "dropout_generator": dropout,
                     "compute_identity": False})
                leaves = {k: ema.get(k, v)
                          for k, v in state.finetune_leaves().items()}
                embeds, extra = finetune_inputs(
                    leaves, inputs["pose_input_rgbs"].shape[0])
            else:
                embeds, _, pose = functional_call(
                    embedder, ema.get("embedder", {}),
                    tuple(inputs.get(k) for k in embedder.INPUT_KEYS),
                    {"train": train, "dropout_generator": dropout})
        finally:
            if saved is not None:
                for k, v in embedder.named_buffers():
                    v.copy_(saved[k])
        inputs.update(embeds=embeds, pose_embedding=pose)
        fake_rgbs, fake_segm = functional_call(
            generator, ema.get("generator", {}),
            tuple(inputs.get(k) for k in generator.INPUT_KEYS),
            {"update_stats": False, **extra})
        return {"fake_rgbs": fake_rgbs.float(),
                "fake_segm": None if fake_segm is None else fake_segm.float(),
                "pose_embedding": pose}

    return eval_forward


def try_other_driving_images(dataloader, eval_forward, state, batch, suffix,
                             same_identity, deterministic=False, rng=random):
    """Cross-driving columns: for each sample another driver, of the same
    person from another video ('_other_video') or of another person
    ('_other_person'), through the EMA model; the new drivers and outputs
    under suffixed keys.  ``batch``: the host batch."""
    dataset = getattr(dataloader, "dataset", None)
    if dataset is None or not hasattr(dataset, "get_other_sample_by_label"):
        return {}
    other = [dataset.get_other_sample_by_label(
        int(label), same_identity=same_identity, deterministic=deterministic,
        rng=rng) for label in np.asarray(batch["label"])]
    data, target = default_collate([dataset[i] for i in other])
    swapped = dict(batch)
    other_batch = dequantize_batch_host({**data, **target})
    for key in DRIVER_KEYS:
        if key in other_batch:
            swapped[key] = other_batch[key]
    outputs = eval_forward(state, swapped)
    return {"pose_input_rgbs" + suffix: swapped["pose_input_rgbs"],
            "fake_rgbs" + suffix: _host(outputs)["fake_rgbs"]}


def run_fixed_id_eval(dataloader, eval_forward, state, args, writer,
                      metrics=()):
    """The fixed probes: samples ``args.fixed_val_ids`` with deterministic
    frames, augmented as a train batch is (when the run augments) with the
    draw keyed on (666, chunk start), so a probe looks the same every round;
    a grid of the first chunk and the metrics' averages."""
    dataset = getattr(dataloader, "dataset", None)
    if dataset is None or not args.fixed_val_ids:
        return
    ids = [i for i in args.fixed_val_ids if i < len(dataset)]
    augments = dict(use_pixelwise=bool(args.use_pixelwise_augs),
                    use_scale=bool(args.use_affine_scale),
                    use_shift=bool(args.use_affine_shift))
    device = next(state.models["generator"].parameters()).device
    meter = Meter()
    for start in range(0, len(ids), args.batch_size_inference):
        chunk = ids[start:start + args.batch_size_inference]
        data, target = default_collate(
            [dataset.get(i, deterministic=True) for i in chunk])
        fixed = dequantize_batch_host({**data, **target})
        if any(augments.values()) and "real_segm" in fixed:
            keys = ("pose_input_rgbs", "target_rgbs", "real_segm")
            draw = augmentation.step_draw(PROBE_SEED, start, device)
            augmented = augmentation.augment_data_dict(
                {k: torch.from_numpy(fixed[k]).to(device) for k in keys},
                draw, **augments)
            fixed.update({k: augmented[k].cpu().numpy() for k in keys})
        fixed.update(_host(eval_forward(state, fixed)))
        if start == 0 and writer is not None:
            grid, captions = make_visual(fixed, n_samples=len(chunk))
            writer.add_image("Fixed_images/train/visual", grid, captions,
                             args.iteration)
        for metric in metrics:
            values, counts = metric(fixed)
            for name, value in values.items():
                meter.add(name, value, counts.get(name, 1))
    if writer is not None:
        for name in meter.keys():
            writer.add_scalar(f"Fixed_metrics/train/{name}",
                              meter.get_average(name), args.iteration)


def run_validation(dataloader, eval_forward, state, args, epoch,
                   writer=None, metrics=(), saver=None):
    """A pass over the val part with the EMA model: the metrics' averages as
    ``Metrics/val/*`` (with ``Data_time`` and ``Batch_time``), a grid of
    the first batch, and each batch's outputs through ``saver``.  Returns
    the averages."""
    meter = Meter()
    end = time.time()
    for it, (data_dict, target_dict) in enumerate(dataloader):
        meter.add("Data_time", time.time() - end)
        merged = dequantize_batch_host({**data_dict, **target_dict})
        merged.update(_host(eval_forward(state, merged)))
        for metric in metrics:
            values, counts = metric(merged)
            for name, value in values.items():
                meter.add(name, value, counts.get(name, 1))
        if it == 0 and writer is not None:
            grid, captions = make_visual(
                merged, n_samples=min(len(merged["fake_rgbs"]),
                                      args.num_visuals_per_img))
            writer.add_image("Images/val/visual", grid, captions,
                             args.iteration)
        if saver is not None:
            saver.save(epoch=epoch, iteration=args.iteration,
                       data={"fake_rgbs": merged["fake_rgbs"],
                             "fake_segm": merged.get("fake_segm"),
                             "label": merged.get("label")})
        meter.add("Batch_time", time.time() - end)
        end = time.time()
    if writer is not None:
        for name in meter.keys():
            writer.add_scalar(f"Metrics/val/{name}", meter.get_average(name),
                              args.iteration)
    averages = {name: meter.get_average(name) for name in meter.keys()}
    logger.info("Validation after epoch %d: %s", epoch,
                {k: round(v, 4) for k, v in averages.items()})
    return averages


class _Profile:
    """``--profile_dir``: a ``torch.profiler`` trace of steps
    [2, 2 + profile_steps) of epoch 0, written as a Chrome trace."""

    def __init__(self, args, epoch, device):
        self.dir = args.profile_dir if epoch == 0 and parallel.is_main() \
            else ""
        self.steps = int(args.profile_steps)
        self.cuda = device.type == "cuda"
        self.prof = None

    def before_step(self, it):
        if not self.dir:
            return
        if it == 2:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()
            logger.info("Profiler trace started -> %s", self.dir)
        elif it == 2 + self.steps:
            self.stop()

    def stop(self):
        if self.prof is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        Path(self.dir).mkdir(parents=True, exist_ok=True)
        path = Path(self.dir) / "trace.json"
        self.prof.export_chrome_trace(str(path))
        self.prof = None
        logger.info("Profiler trace written to %s", path)


def _render_visual(dataloader, eval_forward, state, args, host, writer):
    """The visual grid of a train batch, with the cross-driving columns
    in meta-train."""
    host = dequantize_batch_host(host)
    visual = {**host, **_host(eval_forward(state, host))}
    if not state.finetune:
        rng = random.Random(args.random_seed * 1_000_003 + args.iteration)
        for suffix, same in (("_other_video", True),
                             ("_other_person", False)):
            visual.update(try_other_driving_images(
                dataloader, eval_forward, state, host, suffix,
                same_identity=same, rng=rng))
    grid, captions = make_visual(visual, n_samples=args.num_visuals_per_img)
    writer.add_image("Images/train/visual", grid, captions, args.iteration)


def run_epoch(dataloader, step_fn, state, args, epoch, device, keys,
              writer=None, eval_forward=None, metrics=(), saver=None,
              stop=None):
    """Train one epoch in place on ``state``; returns its :class:`Meter`.

    ``keys``: the batch keys the step reads (moved to ``device``); ``stop``:
    the train CLI's ``StopFlag``, agreed on by every rank after each step
    (``agree``), which ends the epoch there when set."""
    meter = Meter()
    profile = _Profile(args, epoch, device)
    end = time.time()
    try:
        for it, (host, batch) in enumerate(device_prefetch(
                dataloader, device, keys,
                transfer_dtype=args.transfer_dtype)):
            profile.before_step(it)
            meter.add("Data_time", time.time() - end)
            scalars = step_fn(state, batch)
            if args.iteration % args.log_frequency_loss == 0 \
                    and parallel.is_main():
                logger.info("iteration %d: %s", args.iteration, " ".join(
                    f"{k}={float(v):.5g}" for k, v in scalars.items()))
            if args.detailed_metrics:
                for name, value in scalars.items():
                    meter.add(name, float(value))

            if writer is not None:
                if args.iteration % args.log_frequency_loss == 0:
                    for name in meter.keys():
                        writer.add_scalar(f"Metrics/train/{name}",
                                          meter.get_last(name),
                                          args.iteration)
            # rank 0 renders (its writer exists where args.logging); every
            # rank joins the gather of a sharded state
            renders = eval_forward is not None and (
                writer is not None or getattr(args, "logging", False))
            visual_now = renders \
                and args.iteration % args.log_frequency_images == 0
            probe_now = renders \
                and args.iteration % args.log_frequency_fixed_images == 0
            if visual_now or probe_now:
                with parallel.gathered(state, whole=True):
                    if writer is not None and visual_now:
                        _render_visual(dataloader, eval_forward, state, args,
                                       host, writer)
                    if writer is not None and probe_now:
                        run_fixed_id_eval(dataloader, eval_forward, state,
                                          args, writer, metrics)
            args.iteration += 1

            if saver is not None:
                saver.save(epoch=epoch, iteration=args.iteration,
                           scalars={k: float(v) for k, v in scalars.items()})
            meter.add("Batch_time", time.time() - end)
            end = time.time()
            if stop is not None and stop.agree(device):
                break
    finally:
        profile.stop()
    if parallel.is_main():
        logger.info("Epoch %d finished (loss_G=%.4f loss_D=%.4f, %.3fs/it)",
                    epoch, meter.get_average("loss_G"),
                    meter.get_average("loss_D"),
                    meter.get_average("Batch_time"))
    return meter
