#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``latentpose_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, drive, at the flagship model's full widths
(256², 64..512 channels) with seeded random weights, through the entry points
a user calls, and checks every hand-written kernel of that path:

1. device: require CUDA, print ``nvidia-smi`` name and power limit, turn
   TF32 off for the comparisons;
2. build the CUDA kernels from ``latentpose_tpu_torch/csrc/``;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the drive gives it (f32 and bf16), with both times;
4. write a flagship-width fine-tuned checkpoint through the port's writer
   (the JAX package's format);
5. drive ``synthetic://3`` (32 frames) through the CLI's ``load_finetuned``,
   ``load_driver_frames``, ``make_drive_fn`` and ``drive_sequence`` in bf16
   and f32; check shapes, finite values and that every kernel of the path
   launched; time bf16 frames/s at batch 32 and 128; peak memory;
6. the same 4 frames on the card (f32, TF32 off) and on the CPU, where the
   plain versions run: max abs difference within 1e-3.

Any failure exits non-zero.  The line before the last is the kernels' JSON
record; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from latentpose_tpu_torch import checkpoint as ckpt_lib  # noqa: E402
from latentpose_tpu_torch import convert, registry  # noqa: E402
from latentpose_tpu_torch.cli import drive as cli  # noqa: E402
from latentpose_tpu_torch.ops import adain as adain_op  # noqa: E402
from latentpose_tpu_torch.ops.cuda_build import (  # noqa: E402
    BUILD_DIR, build_log, load_library)
from latentpose_tpu_torch.runners import drive as drive_lib  # noqa: E402

FLAGSHIP = dict(
    generator="vector_pose_unsupervised_segmentation_noBottleneck",
    embedder="unsupervised_pose_separate_embResNeXt_segmentation",
    discriminator="no_landmarks", image_size=256, in_channels=3,
    out_channels=3, num_channels=64, max_num_channels=512,
    embed_channels=512, pose_embedding_size=256, gen_padding="zero",
    gen_constant_input_size=4, gen_num_residual_blocks=2, norm_layer="in",
    average_function="sum", compute_dtype="float32", num_devices=1,
    random_seed=0, finetune=True, iteration=0, data_root="",
    img_dir="images-cropped")
# (H*W, C) of the generator's 17 AdaIN + ReLU calls per frame, with counts
ADAIN_CALLS = [(16, 512, 5), (64, 512, 2), (256, 512, 2), (1024, 512, 2),
               (4096, 256, 2), (16384, 128, 2), (65536, 64, 2)]
TOL = {torch.float32: 2e-4, torch.bfloat16: 1.6e-2}   # bf16: ~2 ulps
DRIVE_BATCH = 32


def require(cond, message):
    if not cond:
        raise RuntimeError(f"chip_smoke: {message}")


def cuda_ms(fn, iters):
    """Mean milliseconds of ``fn()`` on the card, after one warm-up call."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def adain_inputs(batch, hw, c, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    side = int(round(hw ** 0.5))
    x = torch.randn(batch, side, side, c, generator=g, device=device) * 3 + 1
    w, b = (torch.randn(batch, c, generator=g, device=device)
            for _ in range(2))
    return x.to(dtype), w.to(dtype), b.to(dtype)


def phase_kernels(device):
    """Kernel against its plain version at every AdaIN shape of the path:
    B=8 in f32 and bf16, and the drive's own B=32 bf16, which is also timed."""
    max_err, ms, plain_ms = 0.0, 0.0, 0.0
    cases = [(8, torch.float32), (8, torch.bfloat16),
             (DRIVE_BATCH, torch.bfloat16)]
    for batch, dtype in cases:
        for hw, c, count in ADAIN_CALLS:
            x, w, b = adain_inputs(batch, hw, c, dtype, device, seed=hw + c)
            got = adain_op.adain(x, w, b, relu=True)
            want = adain_op.adain_reference(x, w, b, relu=True)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=TOL[dtype], atol=TOL[dtype])
            max_err = max(max_err, err)
            line = (f"adain B={batch} HW={hw} C={c} {str(dtype)[6:]}: "
                    f"max_abs_err={err:.3g}")
            if batch == DRIVE_BATCH:
                iters = 50 if hw < 16384 else 20
                k = cuda_ms(lambda: adain_op.adain(x, w, b), iters)
                p = cuda_ms(lambda: adain_op.adain_reference(x, w, b), iters)
                gbytes = 3 * x.numel() * x.element_size() / 1e9
                line += (f" kernel_ms={k:.4f} plain_ms={p:.4f} "
                         f"kernel_GB/s={gbytes / k * 1e3:.0f} "
                         f"(x{count} per frame batch)")
                ms += count * k
                plain_ms += count * p
            print(line, flush=True)
    print(f"adain: 17 calls of one bf16 frame batch of {DRIVE_BATCH}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    return max_err, ms, plain_ms


def phase_checkpoint(workdir):
    """Seeded flagship-width drive modules -> the port's writer."""
    args = types.SimpleNamespace(**FLAGSHIP)
    g = torch.Generator().manual_seed(0)
    embedder = registry.load_wrapper("embedders", args.embedder).get_net(
        args, generator=g)
    generator = registry.load_wrapper("generators", args.generator).get_net(
        args, generator=g)
    for mod in embedder.modules():     # non-trivial BatchNorm statistics
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.running_mean.uniform_(-0.1, 0.1, generator=g)
            mod.running_var.uniform_(0.5, 1.5, generator=g)
    flat = {"step": np.zeros((), np.int32)}
    flat.update(convert.export(embedder, "embedder"))
    flat.update(convert.export(generator, "generator"))
    identity = torch.rand(1, args.embed_channels, generator=g).numpy()
    flat["params::finetune_embedding"] = identity
    flat["ema_params::finetune_embedding"] = identity
    path = ckpt_lib.save_checkpoint(workdir, flat, FLAGSHIP, iteration=0,
                                    finetune=True)
    size = (path / "arrays.npz").stat().st_size
    print(f"checkpoint: {path.name}, {len(flat)} arrays, {size / 2**20:.1f} "
          f"MiB", flush=True)
    return path


def drive_once(ckpt, flags, frames):
    """The CLI's main path on the card, counting the kernel's launches from
    just before to just after it; returns (args, models, state, launches)."""
    args = cli.resolve_args([str(ckpt), "--device", "cuda", *flags])
    models, state = cli.load_finetuned(args, torch.device(args.device))
    drive_fn = drive_lib.make_drive_fn(models, args)
    torch.cuda.synchronize()
    adain_op.adain.launches = 0
    out = drive_lib.drive_sequence(drive_fn, state, frames,
                                   batch_size=args.drive_batch_size)
    torch.cuda.synchronize()
    launches = adain_op.adain.launches
    batches = -(-len(frames) // args.drive_batch_size)
    per_frame = len(models["generator"].adain_features)     # 17 at 256²
    size = args.image_size
    require(out.shape == (len(frames), size, size, 3),
            f"drive output shape {out.shape}")
    require(np.isfinite(out).all(), "drive output has non-finite values")
    # the pipelined sequence (pinned, asynchronous copies) gives what the
    # step gives for the same frames
    direct = drive_fn(state, torch.from_numpy(
        frames[:args.drive_batch_size]).cuda())[0].cpu().numpy()
    seq_err = float(np.abs(out[:args.drive_batch_size] - direct).max())
    require(seq_err <= 1e-3, f"drive_sequence differs from the step by "
            f"{seq_err}")
    require(launches == per_frame * batches,
            f"adain launched {launches} times, expected {per_frame} x "
            f"{batches}")
    print(f"drive {args.compute_dtype}: {out.shape}, range "
          f"[{out.min():.3f}, {out.max():.3f}], adain launches {launches}",
          flush=True)
    return args, models, state, launches


def phase_throughput(models, args, state, frames):
    """bf16 frames/s at batch 32 and 128: end to end through drive_sequence
    (512 host f32 frames in, results out) and the device step alone."""
    drive_fn = drive_lib.make_drive_fn(models, args)
    seq = np.concatenate([frames] * (512 // len(frames)))
    for batch in (32, 128):
        drive_lib.drive_sequence(drive_fn, state, seq[:batch], batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        drive_lib.drive_sequence(drive_fn, state, seq, batch)
        torch.cuda.synchronize()
        e2e = len(seq) / (time.perf_counter() - t0)
        wire = torch.from_numpy((seq[:batch] * 255).astype(np.uint8)).cuda()
        step_ms = cuda_ms(lambda: drive_fn(state, wire), 10)
        peak = torch.cuda.max_memory_allocated() / 2**20
        print(f"drive bf16 batch {batch}: end_to_end_fps={e2e:.1f} "
              f"({len(seq)} f32 frames from host) step_ms={step_ms:.3f} "
              f"device_step_fps={batch / step_ms * 1e3:.1f} "
              f"peak_mem_MiB={peak:.0f}", flush=True)


def phase_card_vs_cpu(ckpt, models, state, frames):
    args = cli.resolve_args([str(ckpt), "--device", "cpu", "--compute_dtype",
                             "float32"])
    card = drive_lib.make_drive_fn(models, args)(
        state, torch.from_numpy(frames).cuda())[0].cpu()
    cpu_models, cpu_state = cli.load_finetuned(args, torch.device("cpu"))
    cpu = drive_lib.make_drive_fn(cpu_models, args)(
        cpu_state, torch.from_numpy(frames))[0]
    diff = (card - cpu).abs().max().item()
    print(f"card vs cpu, {len(frames)} frames f32 (TF32 off): max_abs_diff="
          f"{diff:.3g}", flush=True)
    require(diff <= 1e-3, f"card and CPU differ by {diff}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke runs only on an NVIDIA GPU")
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    adain_op.kernel_entry()
    print(f"build: adain_fused in {time.perf_counter() - t0:.1f} s", flush=True)
    print(build_log(load_library(*adain_op.LIBRARY)), flush=True)

    max_err, ms, plain_ms = phase_kernels(device)

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as workdir:
        ckpt = phase_checkpoint(workdir)
        size = FLAGSHIP["image_size"]
        frames = cli.load_driver_frames("synthetic://3", size)
        require(frames.shape == (32, size, size, 3), f"frames {frames.shape}")
        args, models, state, launches = drive_once(ckpt, [], frames)
        drive_once(ckpt, ["--compute_dtype", "float32"], frames)
        phase_throughput(models, args, state, frames)
        phase_card_vs_cpu(ckpt, models, state, frames[:4])

    print(json.dumps({"kernels": [{
        "name": "adain_fused", "route": "cuda",
        "source": "latentpose_tpu_torch/csrc/adain_fused.cu",
        "replaces": "latentpose_tpu/ops/pallas/adain_fused.py:78",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
