#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``latentpose_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --meta-repro [default|deterministic|cudnn ...]

The second form only compares the card's meta-training in two processes
for each mode, leaf by leaf (ROADMAP C.8; :func:`meta_repro`).  The first
drives the port's main paths, meta-train and fine-tune (f32, and bf16 with
the uint8 wire) and drive (exact and int8), at the flagship model's full
widths (256², generator 64..512 channels, embed 512, pose 256,
discriminator 7 blocks) with seeded random weights, through the
entry points a user calls, and checks every hand-written kernel of those
paths:

1. device: require CUDA, print ``nvidia-smi`` name and power limit, turn
   TF32 off everywhere (cuBLAS and cuDNN) for the comparisons and timings;
2. build the CUDA kernels from ``latentpose_tpu_torch/csrc/``, one nvcc per
   source, all at once; print the compiler's report;
3. AdaIN against its plain version at the generator's 7 shapes (f32 and
   bf16); at the drive's batch of 32 its time, the plain version's, the
   bound (x read and written once at 3.35 TB/s) and the share of it; the
   wrapper's host microseconds per call (200 enqueues of a (16, 512) call);
   the profiler's count of CUDA kernels in one call;
4. the fused BN->ReLU->1x1-conv->stats kernel against its plain version at
   ResNeXt-50's four link shapes, f32 and bf16: 8 frames, a ragged M, and
   the 64 frames of a batch of 8 x K=8, timed there beside the plain
   version, the product alone (``torch.matmul`` of the normalised
   activation, TF32 off) and the bound (bytes at 3.35 TB/s or FLOPs at 989
   TFLOP/s bf16, 495 TF32);
5. the int8 product of the generator's 22 quantized convs at batch 32
   (``ops/quant.py``): the card's route (im2col + ``torch._int_mm``)
   against the plain route (an exact float64 convolution) on the same int8
   inputs, on the card and on the CPU, and the bf16 epilogue: any
   difference fails; each conv's int8 time beside cuDNN's bf16 conv of the
   same shape and both bounds;
6. the link's train form at the four shapes, 64 frames, f32: the
   ``autograd.Function``'s dx, dscale, doffset and dW (its plain backward
   after the kernel's forward), y and the stats against autograd through
   the plain version, within 2e-4 of each tensor's max |.|; the backward's
   ms per link beside the forward kernel's, by events and by the profiler;
7. write a flagship-width fine-tuned checkpoint through the port's writer
   (the JAX package's format) and drive ``synthetic://3`` (32 frames)
   through the drive CLI's functions in bf16 and f32: shapes, finite
   values, AdaIN launches; bf16 frames/s at batch 32 and 128; peak memory;
   the same 4 frames on the card and on the CPU within 1e-3;
8. write a flagship-width meta-trained checkpoint (16 labels, the
   generator's constant drawn from a normal) and meta-train
   it through the train CLI's functions: 5 steps at batch 8, K=8, f32, the
   six criteria of ``configs/default.yaml``, its three augmentations on:
   finite losses; both embedder towers, the generator and the discriminator
   moved, and ResNeXt-50's running statistics; exactly 16 conv_bn and 17
   AdaIN launches per step; median step ms, images/s, peak memory, one
   step's device-busy ms and idle share; then save, resume through the CLI
   and take one more step, the step and Adam count continuing;
9. one meta step on the card and on the CPU from the seeded meta
   checkpoint's state (ROADMAP C.8: a state the card meta-trained differs
   from call to call) and the same batch (batch 1, f32,
   train-mode BatchNorm in both towers, the same dropout masks,
   augmentation off: its per-pixel fields are drawn on the device): losses,
   the BatchNorm statistics' update and the discriminator's gradient within
   1e-3 relative, the generator's and each tower's gradient within GRAD_TOL
   (L2); beside it the card's step with the links through the plain version,
   and with a planted 30 % fault in the embeddings' gradient, which the gate
   must reject; then the same step in f64 on the card and on the CPU (both
   kernels' places taken by their plain versions): every group within
   GRAD_TOL64 = 1e-8 of its L2, with a 1e-6 fault that must read above it;
   and each f32 step's distance to its device's f64 step (f32's own
   rounding), the card's at most F32_C = 3 times the CPU's in each
   train-form tower's gradient, a gate the 30 % fault must fail (ROADMAP
   C.3);
10. fine-tune the meta-trained checkpoint through the train CLI's functions
   on ``synthetic://`` avatar frames, f32, batch 8, the fine-tune config's
   three augmentations on: ê through ResNeXt-50 (16 kernel launches per
   forward), then 10 GAN steps (17 AdaIN launches each): finite losses,
   moved generator and identity embedding, advanced spectral-norm state; ê
   frames/s, step ms, images/s and peak memory;
11. save the fine-tuned checkpoint and drive it in bf16: finite frames;
    then int8 serving through ``cli.drive.main`` on a directory of 48 PNG
    frames, bf16, ``--quantize int8`` and ``--quantize int8_static``: the
    frames it writes (PNG through the port's encoder), 17 AdaIN launches
    and 22 int8 products per generator forward, each int8 mode >= 40 dB
    PSNR against the exact frames; each mode's device step at batch 32 and
    128 in turns, and the calibration pass's time;
12. ê of one loader batch (64 frames) on the card and on the CPU, f32:
    within 1e-4 of max |ê|;
13. one fine-tune step on the card and on the CPU from the same batch
    (batch 2, f32, eval-mode pose encoder, augmentation off), from the
    state right after ê and from the trained one: losses and the
    discriminator's gradient within 1e-3 relative (the loss that reads
    highest named), the generator's and the identity embedding's within
    FT_GRAD_TOL; beside each, the
    card's step with the generator's frames 3 % off, whose losses must
    read above the gate;
6b. the link's train form in bf16 at the same shapes, gate 1.6e-2 of each
   tensor's max, and AdaIN in bf16 under autograd (the kernel's forward,
   the plain f32 backward) at the generator's 17 calls of batch 8 against
   autograd through its plain version: forward and backward ms (events,
   device), each bound, and for the link ``torch.matmul``'s time;
8b. the same meta-train path with ``--compute_dtype bfloat16
   --transfer_dtype uint8`` (staged uint8 batches): its launches a step,
   median ms beside the f32 step, peak memory, busy and idle shares, the
   ten longest kernels; save, resume in the same modes, one more step,
   which counts the link inputs that need a copy to channels_last;
8c. data parallelism (:func:`phase_distributed`): ``cli.train.main`` as
   the one rank of a torchrun world of 1 over NCCL (4 steps at batch 8,
   K=8, f32, both kernels every step, one checkpoint); the staged step in
   that group against the plain one, in turns; a step's gradient bytes and
   the reduce's ms in f32 and bf16; then two gloo ranks on the one card
   (``--dist-child``, 4 rows each) against one process on the whole batch
   under cuDNN's deterministic algorithms: losses, statistics' update and
   the generator's and discriminator's gradients within 1e-3, each tower's
   gradient within GRAD_TOL (the card-vs-CPU meta gate of step 9); the
   explicit regime's identity-tower statistics above 1e-3 and the default
   step with its moments' gradient unreduced (a planted fault) above a
   tower's gate (the witnesses); an FSDP step (``--param_sharding fsdp``)
   against the default regime's two ranks under that gate, with its
   planted fault (each rank's slice updated from its own unreduced
   gradient) above it, each rank's state bytes between steps and peak
   memory, FSDP beside replicated, and the FSDP ranks' checkpoint against
   the replicated ranks';
9b. bf16 against f32 on the card: one meta step from one state and batch
   (batch 2, towers in eval form, augmentation off) in f32 (T32), in bf16
   (T16) and in bf16 with both kernels' places taken by their plain
   versions (P16): ‖T16 - P16‖ <= 2 C ‖P16 - T32‖ for the losses and the
   generator's, discriminator's and embedder's gradients (C = 1.5, the C of
   ``tests/test_torch_bf16.py``: each bf16 route within C of a reference
   bf16 step), and a planted fault (AdaIN's statistics in bf16) that must
   read above that gate on the losses and the generator's and the
   embedder's gradients;
14. real data, through the CLIs' ``main``: write a VoxCeleb2-layout tree
    with no cv2 (16 videos of 12 rendered 320² PNG frames, masks, bboxes
    for half the videos, train.csv and val.csv); meta-train the seeded
    meta checkpoint on it (``voxceleb2_segmentation_nolandmarks``, batch 8,
    K=8, 1 epoch: 2 steps) with validation, PSNR and IoU, visual grids
    with the cross-driving columns and a fixed probe: exactly 16 conv_bn and
    17 AdaIN launches a step (the eval forwards' counted apart), finite
    losses, the checkpoint at step 2, the scalars, grids that decode to
    their tiles; fine-tune the result on one video's 12 frames (ê: 16
    conv_bn launches; 2 steps of 17 AdaIN), the generator moved; drive it
    from another video's directory (the C++ loader); the loop's Batch_time
    and Data_time, the step through the real loader beside the staged one
    of phase 8, and the loader's frames/s on this host; then the same
    phase again with ``--compute_dtype bfloat16 --transfer_dtype uint8``
    (uint8 batches from the loader's uint8 entries), its Data_time and
    Batch_time beside the f32 run's;
15. preprocessing, through ``cli.preprocess_dataset.main --do_crop
    --do_compute_segmentation``: seeded S3FD, FAN (4 hourglasses) and
    Graphonomy (Xception-65) at their published widths, written by the
    port's inverse converter in the JAX package's flat-npz layout and read
    back bit-equal; a raw tree of 2 identities x 2 videos x 8 faces on
    640x360 canvases: the dataset's tree (crops, landmarks, masks), one
    batch of it through ``voxceleb2_segmentation_nolandmarks``, each
    stage's frames/s and peak memory (detect, crop, landmarks, segment at
    four scales), S3FD's candidates before NMS; each net card vs CPU within
    1e-3 of its max (S3FD's heads at 640x360, FAN's heatmaps at 256²,
    Graphonomy's probabilities at 512²) with a planted fault above the gate;
    each net's device ms per batch and frame; one segmentation batch's busy
    time, idle share and longest kernels;
16. drive ``--crop`` through ``cli.drive.main`` from those raw frames with
    the fine-tuned checkpoint, boxes from ``--bboxes_dir`` and from S3FD:
    the generator's frames equal to the C++ crop of the same boxes, 17 AdaIN
    launches a forward; frames/s beside drive from the pre-cropped output;
17. the paper's evaluation protocol: 2 identities of 16 identity and 16
    driver frames at 256² (with masks), seeded ArcFace-r100 and FAN (4
    hourglasses) at their published widths in the JAX layout; the crop
    resizes bit-equal card vs CPU, ArcFace within 1e-3 of its max and LPIPS
    within 1e-3 relative, each with a planted fault above its gate;
    ArcFace's ms a batch of 64 crops with the flip beside its FLOP bound;
    ``cli.batched_finetune.main`` from the meta checkpoint (4 steps an
    identity) and ``cli.batched_drive.main`` (every avatar, every driver),
    as child processes that inherit the blocked imports (a sitecustomize on
    their PYTHONPATH), each child's start-up and work and its kernel
    launches (counted in the child, beside the count reckoned from the
    code); ``cli.compute_pose_identity_error.main`` on the card (again from
    its caches), on the CPU (identity error within 1e-4, pose errors within
    1e-4 relative; one identity's reenactments swapped for another's must
    read above), and with the proxies: each stage's time, frames scored a
    second, peak memory; then (ROADMAP C.6) the eval CLI as a child with
    its own defaults (nets in full f32) held against the CPU run at the
    same gates, and how far cuDNN's TF32 moves ArcFace's embeddings and
    FAN's heatmaps on the tree's frames, with each net's time both ways;
    and (C.7) the tree written as JPEG at quality 95 by a child that may
    import cv2, scored on the card through nvJPEG against cv2's decode of
    the same files (written as PNG): the decoders' gap within the bound
    predicted for it, and the planted fault at least 3x above that bound;
18. serving export through ``cli.export.main`` from the fine-tuned
    checkpoint at batch 32 on the uint8 wire, bf16 and int8_static
    (calibrated on the 32 frames, named explicitly): each ``.pt2`` runs in
    a child with the blocked imports within 1e-3 of eager
    ``drive_sequence``, with 17 AdaIN launches a forward through the
    ``latentpose::adain_fused`` operator; an artifact with the head
    AdaIN's weights moved must read above the gate; the export's seconds
    and bytes, the artifact's step beside eager's;
19. the reference's checkpoints without JAX: ``tools/
    fabricate_reference_checkpoint.py`` in a child writes a 256²
    reference ``.pth`` (meta and fine-tuned); the port's
    ``cli.convert_reference_checkpoint`` converts both; the meta one loads
    whole into the train state on the card, the fine-tuned one drives 32
    frames through ``cli.drive.main`` (17 AdaIN launches).
20. the FSTH family (the few-shot-talking-heads baseline) at its wrappers'
    full widths, 256², batch 8, K=8, on the preprocessed tree of 15 (FAN's
    keypoints, ``--dataloader voxceleb2``): the AdaIN kernel at each of the
    FSTH generator's 11 shapes (17 AdaINs, 6 instance norms of its
    stickman encoder), f32 and bf16, with a planted fault above the gate;
    ``cli.train.main`` meta-trains from a seeded init, saves and
    fine-tunes ``finetune_affine`` from the checkpoint, in f32 and in bf16
    on the uint8 wire, 23 AdaIN launches a step; one meta step with the
    kernels against the plain versions under the step gate, with a
    planted fault; step times, peak memory, the stickman's host ms.
21. the second half of the ablation families on that tree
    (:func:`phase_ablations`): FAbNet+ (ragan) and X2Face+ at the
    flagship's widths through ``cli.train.main`` (meta, ê and fine-tune;
    16 conv_bn and 17 AdaIN launches a meta step) and ``cli.drive.main``,
    their frozen encoders bit-unchanged; one FAbNet+ meta step against
    the plain kernels under the step gate with a planted fault; X2Face
    (``none``, ``l1_rgb``): meta, the identity images, drive, its forward
    card vs CPU with a planted fault; ``--do_crop_ffhq`` on the card
    against the CPU's FFHQ crops, with a planted fault.

Step 3 also times the AdaIN wrapper's host cost by call path: the
wrapper, the operator alone, and the checks and the ctypes launch called
directly.

jax, flax, optax, yaml, cv2, PIL, imageio and pandas are made unimportable
first: the card's path needs none of them.

Any failure exits non-zero.  The line before the last is the kernels' JSON
record (launches on the main paths, error, times, bound, the library call);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import types
import warnings
from pathlib import Path

# The card's path needs none of these (the machine with the card may have
# some of them): make them unimportable, so that the run shows it.
BLOCKED = ("jax", "flax", "optax", "yaml", "cv2", "PIL", "imageio", "pandas")
for _name in BLOCKED:
    sys.modules[_name] = None

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from latentpose_tpu_torch import checkpoint as ckpt_lib  # noqa: E402
from latentpose_tpu_torch import convert, registry  # noqa: E402
from latentpose_tpu_torch.cli import drive as cli  # noqa: E402
from latentpose_tpu_torch.cli import train as train_cli  # noqa: E402
from latentpose_tpu_torch.data import native_loader  # noqa: E402
from latentpose_tpu_torch.data.synthetic import render_face  # noqa: E402
from latentpose_tpu_torch.models.generators import (  # noqa: E402
    vector_pose_unsupervised_segmentation_noBottleneck as gen_mod)
from latentpose_tpu_torch.nn import backbones, blocks  # noqa: E402
from latentpose_tpu_torch.ops import adain as adain_op  # noqa: E402
from latentpose_tpu_torch.ops import conv_bn  # noqa: E402
from latentpose_tpu_torch.ops import quant  # noqa: E402
from latentpose_tpu_torch.ops.cuda_build import (  # noqa: E402
    BUILD_DIR, build_log, load_library)
from latentpose_tpu_torch.runners import drive as drive_lib  # noqa: E402
from latentpose_tpu_torch.runners import finetune as ft  # noqa: E402
from latentpose_tpu_torch.parallel import launch  # noqa: E402
from latentpose_tpu_torch.parallel import mesh as parallel  # noqa: E402
from latentpose_tpu_torch.runners import holycow, loop  # noqa: E402
from latentpose_tpu_torch.runners.state import (  # noqa: E402
    TrainState, ema_of)
from latentpose_tpu_torch.utils.png import write_png  # noqa: E402
from latentpose_tpu_torch.cli import preprocess_dataset as prep_cli  # noqa
from latentpose_tpu_torch.data import (  # noqa: E402
    voxceleb2_segmentation_nolandmarks as dataset_mod)
from latentpose_tpu_torch.data.common import crop as crop_lib  # noqa: E402
from latentpose_tpu_torch.eval import backends  # noqa: E402
from latentpose_tpu_torch.eval import fan as fan_mod  # noqa: E402
from latentpose_tpu_torch.ops.resize import resize_linear  # noqa: E402
from latentpose_tpu_torch.cli import batched_drive  # noqa: E402
from latentpose_tpu_torch.cli import batched_finetune  # noqa: E402
from latentpose_tpu_torch.cli import (  # noqa: E402
    compute_pose_identity_error as eval_cli)
from latentpose_tpu_torch.eval import arcface, lpips  # noqa: E402
from latentpose_tpu_torch.ops.resize import (  # noqa: E402
    resize_area, resize_cubic)
from latentpose_tpu_torch.preprocess import croppers  # noqa: E402
from latentpose_tpu_torch.preprocess import graphonomy as graph_mod  # noqa
from latentpose_tpu_torch.preprocess import s3fd as s3fd_mod  # noqa: E402
from latentpose_tpu_torch.preprocess import segmentation  # noqa: E402
from latentpose_tpu_torch.utils import weights  # noqa: E402

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
ADAIN_PER_FORWARD = sum(count for _, _, count in ADAIN_CALLS)
TOL = {torch.float32: 2e-4, torch.bfloat16: 1.6e-2}   # bf16: ~2 ulps
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
# dense tensor-core peaks by input type: bf16, and TF32 for f32 inputs
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12}
INT8_OPS = 1979e12                 # dense int8 tensor-core operations/s
DRIVE_BATCH = 32
# (rows per frame at 256², Cin, Cout, bottlenecks) of ResNeXt-50's
# bn2 -> ReLU -> conv3 links
CONV_LINKS = [(4096, 128, 256, 3), (1024, 256, 512, 4), (256, 512, 1024, 6),
              (64, 1024, 2048, 3)]
# the flagship meta-trained state: the discriminator has 16 identities
META = dict(FLAGSHIP, finetune=False, num_labels=16, dis_num_blocks=7,
            dis_padding="zero", dataloader="synthetic",
            criterions="idt_embed, perceptual, adversarial, featmat, "
                       "dis_embed, dice",
            optimizer="Adam", lr_gen=5e-5, lr_dis=2e-4, beta1=0.0,
            perc_weight=3e-2, idt_embed_weight=0.6e-2, batch_size=8,
            synthetic_num_labels=16, use_pixelwise_augs=True,
            use_affine_scale=True, use_affine_shift=True)
FT_BATCH = 8
FT_EPOCHS = 5          # 2 batches an epoch (16 identities // batch 8)
META_STEPS = 5
DIST_EPOCHS = 1        # part (i): 1 epoch of 2 steps (16 identities // 8)
DIST_TIMED = 2         # part (i): staged steps timed each way, in turns
# part (ii): a rank's FSDP state between steps over its replicated state
# (1/2 of the parameters, EMA and moments, plus the replicated buffers)
FSDP_RESIDENT = 0.6
STEP_TOL = 1e-3        # card vs CPU, one train step, relative
META_CHECK_BATCH = 1   # the meta step card vs CPU (f32 and f64): its batch
# card vs CPU, one train step: the generator's and each tower's gradient,
# L2 relative (the meta step's towers read 6.9e-3-3.1e-2); a fault of
# 1 - FAULT_SCALE in the embeddings' gradient must read above it (0.30)
GRAD_TOL = 1e-1
FAULT_SCALE = 0.7
# the same step in f64 on the card and on the CPU (both links and AdaIN
# through their plain versions): every group within GRAD_TOL64 of its L2;
# a fault of 1 - FAULT_SCALE64 in the embeddings' gradient must read above
GRAD_TOL64 = 1e-8
FAULT_SCALE64 = 1.0 - 1e-6
# f32 against its own rounding: each train-form tower's gradient
# ‖T32_card - T64_card‖ <= F32_C ‖T32_cpu - T64_cpu‖ (two f32 routes
# whose roundings are independent, each within C = 1.5 of the other's
# distance to f64: 2C, as BF16_C); the 30 % fault must read above it.  The
# generator's and discriminator's f32 rounding is not amplified (5e-5 and
# 6e-7 of their L2 on the CPU), so the card's is set by which cuDNN
# algorithm it picks (the choice follows free workspace) and read 0.35-4.93
# times the CPU's: printed; their card-vs-CPU gates hold them
F32_C = 2 * 1.5
FT_GRAD_TOL = 1e-2     # the same, one fine-tune step (read 4e-6-6e-6, H100)
# bf16 on the card: the kernels' bf16 step (T16) against the plain versions'
# bf16 step (P16), in units of bf16's effect ‖P16 - T32‖: each bf16 route is
# within C = 1.5 of a reference bf16 step (tests/test_torch_bf16.py), so the
# two are within 2 C of each other
BF16_C = 2 * 1.5
BF16_MODES = ("--compute_dtype", "bfloat16", "--transfer_dtype", "uint8")
# the fine-tune gate's witness: the generator's frames 3 % off in the
# forward (1 % moved the losses by 3.8e-3 at most in a CPU rehearsal at 32²)
FT_FAULT_SCALE = 1.03
EHAT_TOL = 1e-4        # card vs CPU, ê of one batch, relative to max |ê|
# the real-data phase's VoxCeleb2-layout tree: identities x videos x frames
# of SOURCE² PNG frames (cropped to 256² by the loader)
TREE = dict(identities=4, videos=4, frames=12)
SOURCE = 320
REAL_META_EPOCHS = 1   # 16 videos // batch 8 = 2 steps an epoch
REAL_FT_EPOCHS = 2     # 12 frames at batch 8: 1 step an epoch (drop_last)
INT8_FRAMES = 48       # the int8 phase's driver directory: a batch and a tail
INT8_CALIB_FRAMES = 16  # int8_static calibrates on these leading frames
INT8_MIN_PSNR = 40.0   # the JAX package's int8 gate (tests/test_quantize.py)
QUANT_MODES = ("", "int8", "int8_static")
# the preprocessing phase's raw footage: identities x videos x frames of
# PREP_FACE² faces pasted on PREP_CANVAS (h, w) canvases; the nets' batch
PREP = dict(identities=2, videos=2, frames=8)
PREP_CANVAS = (360, 640)
PREP_FACE = 144
PREP_BATCH = 8
PREP_TOL = 1e-3        # card vs CPU, each net's output, relative to its max
# the seeded S³FD's face biases: this many of the logit's spreads above its
# mean, so that ~0.1 % of the anchors pass the decode's threshold of 0.5
PREP_ANCHOR_SIGMA = 3.0
# the eval phase's tree: identities, each with this many identity and
# driver frames at size²; the fine-tune children's steps
EVAL = dict(identities=2, frames=16, size=256)
EVAL_FT_ITERATIONS = 4
EVAL_NET_TOL = 1e-3    # card vs CPU: ArcFace (of max |e|), LPIPS (relative)
EVAL_ID_TOL = 1e-4     # card vs CPU: the identity error, absolute
EVAL_POSE_TOL = 1e-4   # card vs CPU: each pose error, relative
# the protocol on a JPEG tree (ROADMAP C.7): the numbers from nvJPEG's decode
# against those from cv2's decode of the same files within JPEG_BOUND (the
# bound predicted before its first card run, PERF.md's findings); the planted
# fault must read at least 3x above it
JPEG_BOUND = (5e-4, 2e-3)   # identity error absolute, pose errors relative

# The FSTH family at the wrappers' full widths, 256²: the
# generator's 17 AdaIN + ReLU calls a forward as (H*W, C, count), and the 6
# instance norms (+ ReLU) of its stickman encoder, which run through the
# same kernel with their shared affine expanded over the batch
FSTH_ADAIN_CALLS = [(256, 512, 9), (1024, 512, 2), (4096, 256, 2),
                    (16384, 128, 2), (65536, 64, 2)]
FSTH_IN_CALLS = [(16384, 64, 1), (16384, 128, 1), (4096, 128, 1),
                 (4096, 256, 1), (1024, 256, 1), (1024, 512, 1)]
FSTH_PER_FORWARD = sum(n for _, _, n in FSTH_ADAIN_CALLS + FSTH_IN_CALLS)
FSTH_MODELS = ["--embedder", "FSTH", "--generator", "FSTH",
               "--discriminator", "FSTH", "--criterions",
               "adversarial, featmat, l1_rgb, idt_embed"]
FSTH_BATCH = 8         # and K=8: n_frames_for_encoder
FSTH_META_STEPS = 2    # epochs of one step: 8 samples of the split
FSTH_FT_STEPS = 2      # epochs of one step: one video's 8 frames
FSTH_FAULT_SCALE = 4   # the planted kernel fault: weight x (1 + 4 TOL)


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


# the profiler records the card's activity alone: the host's operator
# events, which no reading here uses, took most of a meta step's parse
DEVICE_ONLY = [torch.profiler.ProfilerActivity.CUDA]


def device_busy_ms(fn, steps, names=()):
    """Per call of ``fn`` over ``steps`` profiled calls: the summed duration
    of its CUDA kernels (one stream: the device's busy time), and of the
    kernels whose name holds each of ``names``; None where the profiler
    records no device activity.  Unlike :func:`cuda_ms` it leaves out the
    host's time between launches, which bounds back-to-back calls of a
    kernel shorter than its wrapper's host cost."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=DEVICE_ONLY) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None, {}

    def ms(events):
        return sum(e.device_time_total for e in events) / 1e3 / steps

    return ms(kernels), {n: ms([e for e in kernels if n in e.name])
                         for n in names}


# substrings of CUDA kernel names, by the layer that launches them
KERNEL_KINDS = (("AdaIN kernel", ("adain_cluster",)),
                ("conv_bn kernel", ("bn_relu_conv1x1", "stats_finalize")),
                ("cuDNN / cuBLAS convolutions and products",
                 ("conv", "gemm", "xmma", "fft", "winograd", "cutlass",
                  "cudnn", "sm90", "sm80", "dgrad", "wgrad")))


def kernel_breakdown(fn):
    """One profiled call of ``fn`` after a warm-up: its device time by
    KERNEL_KINDS ("other": elementwise, reductions, copies) and its ten
    longest kernel names, in ms; None where the profiler records no device
    activity."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=DEVICE_ONLY) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.device_time_total / 1e3
    if not by_name:
        return None, None
    kinds = {}
    for name, ms in by_name.items():
        low = name.lower()
        kind = next((k for k, subs in KERNEL_KINDS
                     if any(sub in low for sub in subs)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return kinds, top


def _device(ms, bound):
    """The profiler's device time of a call and its share of the bound."""
    if ms is None:
        return "device_ms=not measured"
    return f"device_ms={ms:.4f} device_share={bound / ms:.3f}"


def adain_inputs(batch, hw, c, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    side = int(round(hw ** 0.5))
    x = torch.randn(batch, side, side, c, generator=g, device=device) * 3 + 1
    w, b = (torch.randn(batch, c, generator=g, device=device)
            for _ in range(2))
    return x.to(dtype), w.to(dtype), b.to(dtype)


def bound_ms(nbytes, flops=0.0, peak=None):
    """The least time the card could take: bytes over 3.35 TB/s or FLOPs
    over ``peak`` FLOP/s, whichever is larger; returns (ms, "bytes" or
    "operations")."""
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / peak * 1e3 if peak else 0.0
    return (byte_ms, "bytes") if byte_ms >= flop_ms else (flop_ms,
                                                          "operations")


def adain_bound_ms(x):
    """x read once and written once, plus the (B, C) weight and bias;
    a few operations per element, far below the ridge."""
    b, _, _, c = x.shape
    return bound_ms(2 * x.numel() * x.element_size()
                    + 2 * b * c * x.element_size())[0]


def adain_host_us(device):
    """Host microseconds per AdaIN call, (16, 512) bf16 at batch 32: a host
    clock over 200 enqueues before the one synchronise that ends them, and
    with it, for the wrapper (through the ``latentpose::adain_fused``
    operator).  Beside it, in rounds taken in turns (the median of 5): the
    wrapper; the operator alone; the operator's CUDA implementation (its
    checks and the ctypes launch) called directly, which is what the
    wrapper was before the operator existed."""
    x, w, b = adain_inputs(DRIVE_BATCH, 16, 512, torch.bfloat16, device, 7)
    for _ in range(10):
        adain_op.adain(x, w, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        adain_op.adain(x, w, b)
    enqueue = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) / 200 * 1e6
    calls = {"wrapper": lambda: adain_op.adain(x, w, b),
             "operator": lambda: adain_op.ADAIN_OP(x, w, b, True, 1e-4),
             "direct ctypes": lambda: adain_op._launch(x, w, b, True, 1e-4)}
    rounds = {k: [] for k in calls}
    for _ in range(5):
        for name, fn in calls.items():
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            rounds[name].append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
    return enqueue, total, {k: float(np.median(v)) for k, v in rounds.items()}


def adain_kernels_per_call(device):
    """CUDA kernels the profiler sees in one AdaIN call (bf16, batch 32,
    (65536, 64)); None where the profiler records no device activity."""
    x, w, b = adain_inputs(DRIVE_BATCH, 65536, 64, torch.bfloat16, device, 8)
    adain_op.adain(x, w, b)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=DEVICE_ONLY) as prof:
        adain_op.adain(x, w, b)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return (len(names), sorted(set(names))) if names else (None, [])


def phase_kernels(device):
    """Kernel against its plain version at every AdaIN shape of the path:
    B=8 in f32 and bf16, and the drive's own B=32 bf16, which is also timed
    beside its bound; then the wrapper's host cost and the profiler's count
    of kernels in one call.  Returns (max_abs_err, ms, plain_ms, bound_ms)
    summed over the 17 calls of one bf16 frame batch of 32, and the device
    time of those calls from the profiler."""
    max_err, ms, plain_ms, bound, busy = 0.0, 0.0, 0.0, 0.0, 0.0
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
                dev, _ = device_busy_ms(lambda: adain_op.adain(x, w, b),
                                        iters)
                lo = adain_bound_ms(x)
                plan, _ = adain_op.card_plan(hw, c, dtype)
                line += (f" kernel_ms={k:.4f} plain_ms={p:.4f} "
                         f"bound_ms={lo:.4f} (bytes) share={lo / k:.3f} "
                         f"{_device(dev, lo)} cluster={plan.cluster} "
                         f"holds_sample={plan.holds_sample} (x{count} per "
                         f"frame batch)")
                ms += count * k
                plain_ms += count * p
                bound += count * lo
                busy = None if dev is None or busy is None else \
                    busy + count * dev
            print(line, flush=True)
    print(f"adain: 17 calls of one bf16 frame batch of {DRIVE_BATCH}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
          f"(bytes, 3.35 TB/s), share {bound / ms:.3f}; "
          f"{_device(busy, bound)}", flush=True)
    enqueue, total, paths = adain_host_us(device)
    print(f"adain host cost, (16, 512) bf16 batch {DRIVE_BATCH}: "
          f"{enqueue:.1f} us per call enqueued (200 calls), {total:.1f} us "
          f"with the closing synchronise", flush=True)
    print("adain host cost by call path, us per call enqueued (median of 5 "
          "rounds in turns): " + ", ".join(f"{k} {v:.2f}"
                                           for k, v in paths.items()),
          flush=True)
    kernels, names = adain_kernels_per_call(device)
    print(f"adain: CUDA kernels in one call (torch.profiler): "
          f"{kernels if kernels is not None else 'not measured'} {names}",
          flush=True)
    return max_err, ms, plain_ms, bound, busy


def link_inputs(m, cin, cout, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, cin, generator=g, device=device) * 2 + 0.5
    w = torch.randn(cout, cin, generator=g, device=device) / cin ** 0.5
    scale = torch.rand(cin, generator=g, device=device) + 0.5
    offset = torch.randn(cin, generator=g, device=device) * 0.1
    return x.to(dtype), scale, offset, w.to(dtype).t()    # w: conv3's view


def check_link(x, scale, offset, w):
    """The kernel against its plain version on the same inputs: y within
    TOL of max |y|, stats within 1e-4 relative; returns (max_abs_err,
    max |y|)."""
    y, stats = conv_bn.bn_relu_conv1x1_stats(x, scale, offset, w)
    want_y, want_stats = conv_bn.bn_relu_conv1x1_stats_reference(
        x, scale, offset, w)
    torch.cuda.synchronize()
    err = (y.float() - want_y.float()).abs().max().item()
    ref = want_y.float().abs().max().item()
    torch.testing.assert_close(y.float() / ref, want_y.float() / ref,
                               rtol=TOL[x.dtype], atol=TOL[x.dtype])
    torch.testing.assert_close(stats, want_stats, rtol=1e-4,
                               atol=1e-4 * want_stats.abs().max().item())
    return err, ref


def link_bound_ms(m, cin, cout, dtype):
    """x, W, scale and offset read once, y and the (2, Cout) stats written
    once; 2·M·Cin·Cout FLOPs at the tensor cores' rate for the input type
    (bf16, or TF32 for f32 inputs, the card's fastest f32-input rate)."""
    size = torch.finfo(dtype).bits // 8
    nbytes = ((m * cin + cin * cout + m * cout) * size
              + (2 * cin + 2 * cout) * 4)
    return bound_ms(nbytes, 2 * m * cin * cout, PEAK_FLOPS[dtype])


@torch.no_grad()
def phase_conv_bn(device):
    """The fused kernel against its plain version at every link shape of
    ResNeXt-50, f32 and bf16: at 8 frames, a ragged M, and the ê pass's 64
    frames, which are also timed beside the plain version, the bound and
    the product alone (``torch.matmul`` of the already-normalised
    activation in W's dtype, TF32 off); returns (max_abs_err, ms, plain_ms,
    bound_ms, bound_by, library_ms, device_ms) with the times summed over the
    16 links of one f32 forward."""
    max_err, ms, plain_ms, library, busy = 0.0, 0.0, 0.0, 0.0, 0.0
    bound = {"bytes": 0.0, "operations": 0.0}
    cases = [(8 * rows, cin, cout, dtype) for rows, cin, cout, _ in CONV_LINKS
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(1000, 256, 512, torch.float32), (1000, 256, 512,
                                                torch.bfloat16)]
    for m, cin, cout, dtype in cases:
        err, ref = check_link(*link_inputs(m, cin, cout, dtype, device, m))
        max_err = max(max_err, err)
        print(f"conv_bn M={m} {cin}->{cout} {str(dtype)[6:]}: max_abs_err="
              f"{err:.3g} (max |y| {ref:.3g})", flush=True)
    for rows, cin, cout, count in CONV_LINKS:
        for dtype in (torch.float32, torch.bfloat16):
            m = 64 * rows
            x, scale, offset, w = link_inputs(m, cin, cout, dtype, device, 1)
            err, ref = check_link(x, scale, offset, w)
            max_err = max(max_err, err)
            k = cuda_ms(lambda: conv_bn.bn_relu_conv1x1_stats(
                x, scale, offset, w), 20)
            p = cuda_ms(lambda: conv_bn.bn_relu_conv1x1_stats_reference(
                x, scale, offset, w), 20)
            dev, _ = device_busy_ms(lambda: conv_bn.bn_relu_conv1x1_stats(
                x, scale, offset, w), 20)
            h = torch.relu(x.float() * scale + offset).to(w.dtype)
            lib = cuda_ms(lambda: torch.matmul(h, w), 20)
            del h
            lo, by = link_bound_ms(m, cin, cout, dtype)
            tflops = 2 * m * cin * cout / k / 1e9
            print(f"conv_bn 64 frames M={m} {cin}->{cout} {str(dtype)[6:]}: "
                  f"max_abs_err={err:.3g} (max |y| {ref:.3g}) "
                  f"kernel_ms={k:.4f} plain_ms={p:.4f} matmul_ms={lib:.4f} "
                  f"bound_ms={lo:.4f} ({by}) share={lo / k:.3f} "
                  f"{_device(dev, lo)} kernel_TFLOP/s={tflops:.1f} "
                  f"(x{count} per forward)", flush=True)
            if dtype == torch.float32:
                ms += count * k
                plain_ms += count * p
                bound[by] += count * lo
                library += count * lib
                busy = None if dev is None or busy is None else \
                    busy + count * dev
    total = sum(bound.values())
    print(f"conv_bn: 16 links of one f32 forward of 64 frames: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, product alone "
          f"{library:.4f} ms, bound {total:.4f} ms ({bound['bytes']:.4f} "
          f"from bytes, {bound['operations']:.4f} from operations), share "
          f"{total / ms:.3f}; {_device(busy, total)}", flush=True)
    # the sum's bound_by: the kind that contributes more of it
    return (max_err, ms, plain_ms, total, max(bound, key=bound.get),
            library, busy)


def link_grads(fn, x, scale, offset, w, cot_y, cot_stats):
    """(y, stats, dx, dscale, doffset, dW) of ``fn`` for the cotangents,
    with fresh leaves; W enters as conv3's weight (Cout, Cin), viewed."""
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, scale, offset, w.t())]
    y, stats = fn(leaves[0], leaves[1], leaves[2], leaves[3].t())
    grads = torch.autograd.grad((y, stats), leaves, (cot_y, cot_stats))
    return (y.detach(), stats.detach(), grads[0], grads[1], grads[2],
            grads[3].t())


def phase_conv_bn_train(device, dtype=torch.float32):
    """The link's train form at ResNeXt-50's four shapes, 64 frames, in
    ``dtype``: the ``autograd.Function`` (the kernel's forward, the plain
    backward) against autograd through the plain version, y, stats and the
    four gradients within TOL of each tensor's max |.|; the forward's and
    the backward's time per link (events and the profiler's device time),
    beside the forward's bound and ``torch.matmul``'s time on the same
    product.  Returns those times summed over the 16 links of one forward,
    the bound's kind and the largest error relative to its tensor's max."""
    names = ("y", "stats", "dx", "dscale", "doffset", "dW")
    out = dict(forward_ms=0.0, forward_device_ms=0.0, backward_ms=0.0,
               backward_device_ms=0.0, bound_ms=0.0, matmul_ms=0.0,
               max_rel_err=0.0)
    kinds = {"bytes": 0.0, "operations": 0.0}
    label = str(dtype)[6:]

    def add(key, value, count):
        out[key] = None if value is None or out[key] is None else \
            out[key] + count * value

    for rows, cin, cout, count in CONV_LINKS:
        m = 64 * rows
        x, scale, offset, w = link_inputs(m, cin, cout, dtype, device, 3)
        g = torch.Generator(device=device).manual_seed(4)
        cot_y = torch.randn(m, cout, generator=g, device=device).to(dtype)
        cot_stats = torch.randn(2, cout, generator=g, device=device) / m
        got = link_grads(conv_bn.bn_relu_conv1x1_stats, x, scale, offset, w,
                         cot_y, cot_stats)
        want = link_grads(conv_bn.bn_relu_conv1x1_stats_reference, x, scale,
                          offset, w, cot_y, cot_stats)
        torch.cuda.synchronize()
        errs = []
        for name, a, b in zip(names, got, want):
            require(a.dtype == b.dtype, f"conv_bn train form {label}: {name} "
                    f"is {a.dtype}, the plain version's {b.dtype}")
            ref = b.float().abs().max().item()
            err = (a.float() - b.float()).abs().max().item()
            errs.append(f"{name} {err / ref:.2g}")
            out["max_rel_err"] = max(out["max_rel_err"], err / ref)
            require(err <= TOL[dtype] * ref,
                    f"conv_bn train form {label} M={m} {cin}->{cout}: {name} "
                    f"differs by {err} (max |.| {ref})")
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, scale, offset, w.t())]
        y, stats = conv_bn.bn_relu_conv1x1_stats(
            leaves[0], leaves[1], leaves[2], leaves[3].t())

        def backward():
            torch.autograd.grad((y, stats), leaves, (cot_y, cot_stats),
                                retain_graph=True)

        def forward():
            conv_bn.bn_relu_conv1x1_stats(x, scale, offset, w)

        fwd, bwd = cuda_ms(forward, 10), cuda_ms(backward, 10)
        fwd_dev, _ = device_busy_ms(forward, 10)
        bwd_dev, _ = device_busy_ms(backward, 10)
        h = torch.relu(x.float() * scale + offset).to(w.dtype)
        lib = cuda_ms(lambda: torch.matmul(h, w), 10)
        del h
        lo, by = link_bound_ms(m, cin, cout, dtype)
        print(f"conv_bn train form 64 frames M={m} {cin}->{cout} {label}: "
              f"max_err/max|.| {', '.join(errs)}; forward kernel_ms="
              f"{fwd:.4f} device_ms={_ms(fwd_dev)} bound_ms={lo:.4f} ({by}) "
              f"share={lo / fwd:.3f} matmul_ms={lib:.4f}; backward_ms="
              f"{bwd:.4f} (plain, events) device_ms={_ms(bwd_dev)} (x{count} "
              f"per forward)", flush=True)
        for key, value in (("forward_ms", fwd), ("forward_device_ms", fwd_dev),
                           ("backward_ms", bwd),
                           ("backward_device_ms", bwd_dev),
                           ("bound_ms", lo), ("matmul_ms", lib)):
            add(key, value, count)
        kinds[by] += count * lo
        del x, y, stats, leaves, got, want, cot_y
    out["bound_by"] = max(kinds, key=kinds.get)
    print(f"conv_bn train form, 16 links of one {label} forward of 64 frames: "
          f"forward {out['forward_ms']:.4f} ms (events), "
          f"{_ms(out['forward_device_ms'])} ms (device), bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}), torch.matmul "
          f"{out['matmul_ms']:.4f} ms; plain backward "
          f"{out['backward_ms']:.4f} ms (events), "
          f"{_ms(out['backward_device_ms'])} ms (device)",
          flush=True)
    return out


def adain_grads(fn, x, w, b, cot):
    """(y, dx, dweight, dbias) of ``fn`` (AdaIN + ReLU) for ``cot``."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    y = fn(*leaves, relu=True)
    return (y.detach(), *torch.autograd.grad(y, leaves, cot))


def phase_adain_train(device):
    """AdaIN in bf16 under autograd at the generator's 17 calls, batch 8 (a
    meta or fine-tune step's): the ``autograd.Function`` (the kernel's
    forward, the plain f32 backward) against autograd through the plain
    version, y and the three gradients within TOL of each tensor's max |.|;
    the forward's and the backward's ms per call (events, device) beside
    the bound of each (x, and the gradient, read once; the outputs written
    once).  Returns those summed over the 17 calls."""
    dtype, batch = torch.bfloat16, 8
    out = dict(forward_ms=0.0, forward_device_ms=0.0, backward_ms=0.0,
               backward_device_ms=0.0, bound_ms=0.0, backward_bound_ms=0.0,
               max_rel_err=0.0)
    for hw, c, count in ADAIN_CALLS:
        x, w, b = adain_inputs(batch, hw, c, dtype, device, seed=hw + c)
        cot = torch.randn(x.shape, device=device,
                          generator=torch.Generator(device=device)
                          .manual_seed(hw)).to(dtype)
        got = adain_grads(adain_op.adain, x, w, b, cot)
        want = adain_grads(adain_op.adain_reference, x, w, b, cot)
        torch.cuda.synchronize()
        errs = []
        for name, a, r in zip(("y", "dx", "dweight", "dbias"), got, want):
            require(a.dtype == r.dtype == dtype, f"adain train form: {name} "
                    f"is {a.dtype}, the plain version's {r.dtype}")
            ref = r.float().abs().max().item()
            err = (a.float() - r.float()).abs().max().item()
            errs.append(f"{name} {err / ref:.2g}")
            out["max_rel_err"] = max(out["max_rel_err"], err / ref)
            require(err <= TOL[dtype] * ref, f"adain train form HW={hw} "
                    f"C={c}: {name} differs by {err} (max |.| {ref})")
        leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
        y = adain_op.adain(*leaves, relu=True)

        def backward():
            torch.autograd.grad(y, leaves, cot, retain_graph=True)

        def forward():
            adain_op.adain(x, w, b)

        fwd, bwd = cuda_ms(forward, 20), cuda_ms(backward, 10)
        fwd_dev, _ = device_busy_ms(forward, 20)
        bwd_dev, _ = device_busy_ms(backward, 10)
        lo = adain_bound_ms(x)
        # the backward reads x, the gradient, weight and bias, writes dx,
        # dweight and dbias
        lo_bwd = bound_ms(3 * x.numel() * x.element_size()
                          + 4 * batch * c * x.element_size())[0]
        print(f"adain train form B={batch} HW={hw} C={c} bf16: "
              f"max_err/max|.| {', '.join(errs)}; forward kernel_ms="
              f"{fwd:.4f} device_ms={_ms(fwd_dev)} bound_ms={lo:.4f} (bytes) "
              f"share={lo / fwd:.3f}; backward_ms={bwd:.4f} (plain, events) "
              f"device_ms={_ms(bwd_dev)} bound_ms={lo_bwd:.4f} (bytes) "
              f"(x{count} per generator forward)", flush=True)
        for key, value in (("forward_ms", fwd), ("forward_device_ms", fwd_dev),
                           ("backward_ms", bwd),
                           ("backward_device_ms", bwd_dev), ("bound_ms", lo),
                           ("backward_bound_ms", lo_bwd)):
            out[key] = None if value is None or out[key] is None else \
                out[key] + count * value
        del x, y, leaves, got, want, cot
    print(f"adain train form, 17 calls of one bf16 generator forward at batch "
          f"{batch}: forward {out['forward_ms']:.4f} ms (events), "
          f"{_ms(out['forward_device_ms'])} ms (device), bound "
          f"{out['bound_ms']:.4f} ms; plain backward {out['backward_ms']:.4f} "
          f"ms (events), {_ms(out['backward_device_ms'])} ms (device), bound "
          f"{out['backward_bound_ms']:.4f} ms", flush=True)
    return out


def _ms(value):
    return "not measured" if value is None else f"{value:.4f}"


def phase_meta_checkpoint(workdir):
    """Seeded flagship-width meta-trained state (identity and pose encoders,
    generator, a 16-label discriminator; EMA off the live weights, non-trivial
    BatchNorm statistics) -> the port's writer.

    The generator's constant is drawn from a normal, as a trained one is
    spread: the init's constant is ones, and a few Adam steps leave each
    channel of its first instance norm flat to ~lr, where the one-pass
    variance that both devices take in f32 cancels and their rounding drives
    every generator-side gradient apart (ROADMAP.md C.3).  Every state the
    smoke trains from this checkpoint inherits the spread constant."""
    args = types.SimpleNamespace(**META)
    g = torch.Generator().manual_seed(1)
    models = train_cli.build_models(args, generator=g)
    for mod in models["embedder"].modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.running_mean.uniform_(-0.1, 0.1, generator=g)
            mod.running_var.uniform_(0.5, 1.5, generator=g)
    with torch.no_grad():
        models["generator"].constant.normal_(generator=g)
    ema = {}
    for part in ("embedder", "generator"):
        ema[part] = {k: v * (1 + 0.01 * (2 * torch.rand(v.shape, generator=g)
                                         - 1))
                     for k, v in ema_of(models[part]).items()}
    flat = convert.export_train_state(TrainState(models=models,
                                                 ema_params=ema))
    path = ckpt_lib.save_checkpoint(workdir, flat, META, iteration=0,
                                    finetune=False)
    size = (path / "arrays.npz").stat().st_size
    print(f"meta checkpoint: {len(flat)} arrays, {size / 2**20:.1f} MiB",
          flush=True)
    return path


def _sample(p):
    """A few entries of a tensor, copied (to see whether it moved)."""
    return p.detach().flatten()[:4096].clone()


def phase_finetune(meta_ckpt, workdir, device):
    """The train CLI's fine-tune path on the card; returns (args, state,
    a CPU copy of the state right after ê, dataloader, fine-tuned
    checkpoint, launches)."""
    args = train_cli.resolve_args([
        "--finetune", "--config_name", "finetuning-base",
        "--checkpoint_path", str(meta_ckpt), "--dataloader",
        "synthetic", "--device", str(device), "--allow_random_vgg",
        "--batch_size", str(FT_BATCH), "--num_epochs", str(FT_EPOCHS),
        "--experiments_dir", str(workdir)])
    args.experiment_dir = str(workdir)
    loader = train_cli.build_dataloader(args)
    state = train_cli.load_checkpoint(args, device)
    criteria = train_cli.build_criteria(args, device)
    gen = state.models["generator"]
    before = {"head_conv": _sample(gen.head_conv.weight),
              "block0.conv0": _sample(gen.block0.conv0.weight),
              "dis.stem_conv0.u": _sample(
                  state.models["discriminator"].stem_conv0.u),
              "gen.block0.conv0.u": _sample(gen.block0.conv0.u)}

    torch.cuda.synchronize()
    conv_bn.bn_relu_conv1x1_stats.launches = 0
    adain_op.adain.launches = 0
    t0 = time.perf_counter()
    state = train_cli.start_finetuning(args, state, loader, device)
    torch.cuda.synchronize()
    ehat_s = time.perf_counter() - t0
    e_hat = state.finetune_embedding.detach().clone()
    seeded = _copy_state(state, args, torch.device("cpu"))
    forwards = len(loader)
    require(conv_bn.bn_relu_conv1x1_stats.launches == 16 * forwards,
            f"conv_bn launched {conv_bn.bn_relu_conv1x1_stats.launches} times "
            f"in the ê pass, expected 16 x {forwards} ResNeXt forwards")
    require(torch.isfinite(e_hat).all()
            and e_hat.shape == (1, args.embed_channels),
            f"ê {tuple(e_hat.shape)} not finite")

    args.iteration = state.step
    step_fn = train_cli.make_step(args, criteria)
    losses = []

    def step(st, batch):
        scalars = step_fn(st, batch)
        losses.append({k: float(v) for k, v in scalars.items()})
        return scalars

    for epoch in range(args.num_epochs):
        loop.run_epoch(loader, step, state, args, epoch, device,
                       holycow.STEP_KEYS)
    torch.cuda.synchronize()
    launches = {"bn_relu_conv1x1_stats": conv_bn.bn_relu_conv1x1_stats.launches,
                "adain_fused": adain_op.adain.launches}
    steps = len(losses)
    per_step = len(gen.adain_features)          # 17 at 256²
    require(steps >= 10, f"only {steps} fine-tune steps ran")
    require(launches["adain_fused"] == per_step * steps,
            f"adain launched {launches['adain_fused']} times in {steps} "
            f"steps, expected {per_step} per step")
    require(launches["bn_relu_conv1x1_stats"] == 16 * forwards,
            "conv_bn launched during the steps")
    require(all(np.isfinite(v) for s in losses for v in s.values()),
            f"non-finite losses: {losses[-1]}")
    after = {"head_conv": _sample(gen.head_conv.weight),
             "block0.conv0": _sample(gen.block0.conv0.weight),
             "dis.stem_conv0.u": _sample(
                 state.models["discriminator"].stem_conv0.u),
             "gen.block0.conv0.u": _sample(gen.block0.conv0.u)}
    for key in before:
        require(not torch.equal(before[key], after[key]), f"{key} did not "
                "change in fine-tuning")
    require(not torch.equal(e_hat, state.finetune_embedding.detach()),
            "finetune_embedding did not change")
    print(f"finetune: {steps} steps, step {state.step}; first losses "
          f"{losses[0]}; last {losses[-1]}; launches {launches}", flush=True)

    # timings: ê over one epoch of host batches; the step on a staged batch
    frames = forwards * FT_BATCH * args.num_enc_frames
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ft.compute_averaged_identity_embedding(state, loader, device)
    torch.cuda.synchronize()
    ehat_fps = frames / (time.perf_counter() - t0)
    enc = torch.as_tensor(loader.get_batch(0)[0]["enc_rgbs"]).to(device)
    staged = [({"enc_rgbs": enc}, None)]      # one batch already on the card
    ehat_card_ms = cuda_ms(lambda: ft.compute_averaged_identity_embedding(
        state, staged, device), 5)
    card_frames = enc.shape[0] * enc.shape[1]
    del staged, enc
    batch = holycow.to_device(loader.get_batch(0), device)
    step_fn(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        step_fn(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"finetune f32 batch {FT_BATCH} {args.image_size}²: ehat_frames/s="
          f"{ehat_fps:.1f} ({frames} frames from the host; first pass with ê setup "
          f"{ehat_s:.2f} s) ehat_card_ms={ehat_card_ms:.3f} ({card_frames} "
          f"frames on the card, {card_frames / ehat_card_ms * 1e3:.1f} "
          f"frames/s) step_ms={step_ms:.2f} images/s="
          f"{FT_BATCH / step_ms * 1e3:.2f} peak_mem_MiB={peak:.0f}",
          flush=True)
    path = train_cli.save(args, state)
    print(f"fine-tuned checkpoint: {path.name}", flush=True)
    return args, state, seeded, loader, path, launches


@torch.no_grad()
def phase_ehat_card_vs_cpu(state, loader, device):
    """ê of one loader batch (8 samples x K=8 frames, the kernel's main-path
    shapes) through the fine-tune runner on the card (ResNeXt-50 with the
    fused kernel, channels_last, conv3's weight view) and on the CPU (the
    plain version), f32, TF32 off."""
    batch = [loader.get_batch(0)]
    cpu_state = TrainState(
        models={"embedder": copy.deepcopy(state.models["embedder"]).cpu()},
        ema_params={"embedder": {k: v.cpu() for k, v in
                                 state.ema_params["embedder"].items()}})
    out = {}
    for name, st, dev in (("card", state, device),
                          ("cpu", cpu_state, torch.device("cpu"))):
        t0 = time.perf_counter()
        out[name] = ft.compute_averaged_identity_embedding(st, batch, dev).cpu()
        b, k = batch[0][0]["enc_rgbs"].shape[:2]
        print(f"ê of {b} x {k} frames on the {name}: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    rel = ((out["card"] - out["cpu"]).abs().max()
           / out["cpu"].abs().max()).item()
    print(f"ê card vs cpu (TF32 off): max_rel_diff={rel:.3g}", flush=True)
    require(out["card"].shape == (1, 512) and rel <= EHAT_TOL,
            f"card and CPU ê differ: {rel} relative")


def _copy_state(state, args, device, dtype=torch.float32):
    """A copy of a TrainState on ``device`` in ``dtype``, optimizer moments
    included."""
    models = {k: copy.deepcopy(m).to(device=device, dtype=dtype)
              for k, m in state.models.items()}
    ema = {part: ({k: v.to(device, dtype, copy=True) for k, v in t.items()}
                  if isinstance(t, dict) else t.to(device, dtype, copy=True))
           for part, t in state.ema_params.items()}
    leaves = {k: v.detach().to(device, copy=True).requires_grad_()
              for k, v in state.finetune_leaves().items()}
    new = TrainState(models=models, ema_params=ema, step=state.step,
                     **leaves)
    new.opt_g, new.opt_d = ft.optimizers(new, args)
    for src, dst in ((state.opt_g, new.opt_g), (state.opt_d, new.opt_d)):
        dst.count = src.count
        for a, b in zip(dst.mu + dst.nu, src.mu + src.nu):
            a.copy_(b)
    return new


def _leaves(state, kinds=("stats", "gradient")):
    """{(module, kind): {name: CPU copy}} of ``kinds``: each module's
    BatchNorm statistics ("stats") and the optimizers' first moments by
    parameter ("gradient": Adam's ``mu``, with beta1 = 0 the step's
    gradient), the embedder's split by tower.  No gate reads the
    parameters, so they are not copied."""
    out = {}
    if "stats" in kinds:
        for part, m in state.models.items():
            out[(part, "stats")] = {k: v.detach().cpu().clone()
                                    for k, v in m.named_buffers()
                                    if "running" in k}
    if "gradient" not in kinds:
        return out
    # g_trainable's order: the generator, then the embedder (meta-train)
    # or the identity embedding (fine-tune)
    owners = ["generator"] * sum(
        1 for _ in state.models["generator"].parameters())
    owners += list(state.finetune_leaves()) if state.finetune else [
        "embedder." + name.split(".")[0]
        for name, _ in state.models["embedder"].named_parameters()]
    for i, mu in enumerate(state.opt_g.mu):
        out.setdefault((owners[i], "gradient"), {})[str(i)] = \
            mu.detach().cpu().clone()
    out[("discriminator", "gradient")] = {
        str(i): mu.detach().cpu().clone()
        for i, mu in enumerate(state.opt_d.mu)}
    return out


# a phase's criteria by (device, compute dtype, build function, names): seeded
# towers, rebuilt the same for every step; cleared after each phase
_CRITERIA = {}


def _criteria(args, device):
    key = (str(device), args.compute_dtype, train_cli.build_criteria,
           args.criterions)
    if key not in _CRITERIA:
        _CRITERIA[key] = train_cli.build_criteria(args, device)
    return _CRITERIA[key]


def _run_step(args, state, host, keys, device, patch=contextlib.nullcontext,
              dtype=torch.float32):
    """One train step from a copy of ``state`` in ``dtype`` on ``device``
    with the host batch, inside ``patch()``: (losses, leaves before, leaves
    after, s)."""
    st = _copy_state(state, args, device, dtype)
    before = _leaves(st, ("stats",))
    with patch():
        step_fn = train_cli.make_step(args, _criteria(args, device))
        t0 = time.perf_counter()
        scalars = step_fn(st, holycow.to_device(host, device, keys))
        scalars = {k: float(v) for k, v in scalars.items()}
    return scalars, before, _leaves(st), time.perf_counter() - t0


def _gaps(ref, other):
    """({loss: relative gap}, {group: L2 gap relative to the reference's
    L2}) between two runs of :func:`_run_step`: the gradients, and the
    BatchNorm statistics' update."""
    (losses, before, after, _), (o_losses, _, o_after, _) = ref, other
    loss = {k: abs(o_losses[k] - losses[k]) / max(abs(losses[k]), 1e-6)
            for k in losses}
    rel = {}
    for group, leaves in after.items():
        num = sum(float((o_after[group][k] - leaves[k]).square().sum())
                  for k in leaves)
        den = sum(float((leaves[k] - (before[group][k] if group[1] == "stats"
                                      else 0)).square().sum())
                  for k in leaves)
        if den:
            rel[".".join(group)] = (num / den) ** 0.5
    return loss, rel


def _worst_loss(loss):
    """(name, gap) of the loss that reads highest."""
    name = max(loss, key=loss.get)
    return name, loss[name]


def _print_gaps(what, loss, rel):
    name, gap = _worst_loss(loss)
    print(f"{what}: losses max_rel_diff={gap:.3g} ({name}); L2 relative: "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()), flush=True)


def _step_limits(rel, grad_tol, limits=None):
    """{group: limit}: BatchNorm statistics and the discriminator's gradient
    STEP_TOL, the generator side's gradients ``grad_tol``, but where
    ``limits`` names the group."""
    tol = {k: grad_tol if k.endswith("gradient")
           and not k.startswith("discriminator") else STEP_TOL for k in rel}
    tol.update(limits or {})
    return tol


def _require_step(what, loss, rel, grad_tol, limits=None):
    """Losses within STEP_TOL, each group within :func:`_step_limits`."""
    name, gap = _worst_loss(loss)
    require(gap <= STEP_TOL, f"card and CPU {what}s differ: losses {gap} "
            f"({name})")
    for key, limit in _step_limits(rel, grad_tol, limits).items():
        require(rel[key] <= limit, f"card and CPU {what}s differ: {key} "
                f"{rel[key]} > {limit}")


def _batch_of(loader, size):
    data, target = loader.get_batch(0)
    return ({k: v[:size] for k, v in data.items()},
            {k: v[:size] for k, v in target.items()})


@contextlib.contextmanager
def _planted_frame_fault(cls):
    """The generator (class ``cls``) returns its frames FT_FAULT_SCALE off:
    a fault in the forward, which every loss reads."""
    forward = cls.forward

    def faulty(self, *a, **k):
        rgbs, segm = forward(self, *a, **k)
        return rgbs * FT_FAULT_SCALE, segm

    cls.forward = faulty
    try:
        yield
    finally:
        cls.forward = forward


def phase_step_card_vs_cpu(args, states, loader, device):
    """One fine-tune step from the same state and batch on the card and on
    the CPU (batch 2, f32, TF32 off, eval-mode pose encoder, augmentation
    off): losses and the discriminator's gradient within STEP_TOL relative,
    the generator's and the identity embedding's (Adam's first moment with
    beta1 = 0 is the step's gradient) within FT_GRAD_TOL.  From each of
    ``states`` ({"seeded": the state right after ê, "trained": after the
    fine-tune steps}), so that whether the gap follows the trained state
    is on record; beside each, the card's step with a planted fault (the
    generator's frames FT_FAULT_SCALE off), whose losses must read above
    the gate.  The loss that reads highest is named.  Every reading is
    printed before any is held to its gate.  Both states carry the meta
    checkpoint's spread generator constant (:func:`phase_meta_checkpoint`);
    its per-channel spread is printed beside each."""
    args = copy.copy(args)
    args.set_eval_mode_in_train = True
    args.use_pixelwise_augs = args.use_affine_scale = \
        args.use_affine_shift = False
    host, keys = _batch_of(loader, 2), holycow.STEP_KEYS
    generator = type(states["trained"].models["generator"])
    gaps = {}
    for label, state in states.items():
        spread = state.models["generator"].constant.detach().std(dim=(2, 3))
        print(f"finetune step, {label} state: the generator constant's "
              f"per-channel std min {spread.min():.3g} median "
              f"{spread.median():.3g} max {spread.max():.3g}", flush=True)
        cpu = _run_step(args, state, host, keys, torch.device("cpu"))
        for way, patch in (("card", contextlib.nullcontext),
                           ("card, planted fault",
                            lambda: _planted_frame_fault(generator))):
            run = _run_step(args, state, host, keys, device, patch)
            gaps[label, way] = _gaps(cpu, run)
            _print_gaps(f"finetune step, {label} state, {way} vs cpu, batch "
                        f"2 {args.image_size}² f32 (TF32 off; {run[3]:.2f} "
                        f"s, cpu {cpu[3]:.2f} s)", *gaps[label, way])
    for label in states:
        _require_step(f"finetune step ({label} state)", *gaps[label, "card"],
                      FT_GRAD_TOL)
        name, gap = _worst_loss(gaps[label, "card, planted fault"][0])
        require(gap > STEP_TOL, f"the planted fault passes the fine-tune "
                f"loss gate ({label} state): {name} {gap} <= {STEP_TOL}")


@contextlib.contextmanager
def _plain_link():
    """ResNeXt-50's links through the plain version, under autograd."""
    kernel = backbones.bn_relu_conv1x1_stats
    backbones.bn_relu_conv1x1_stats = conv_bn.bn_relu_conv1x1_stats_reference
    try:
        yield
    finally:
        backbones.bn_relu_conv1x1_stats = kernel


@contextlib.contextmanager
def _planted_fault(cls, scale=FAULT_SCALE):
    """The embedder (class ``cls``) passes on ``scale`` of its identity
    and pose embeddings' gradient, the forward unchanged: a fault in the
    two gradient paths meta-train adds."""
    forward = cls.forward

    def scaled(t):
        return None if t is None else \
            scale * t + (1.0 - scale) * t.detach()

    def faulty(self, *a, **k):
        embeds, elemwise, pose = forward(self, *a, **k)
        return scaled(embeds), elemwise, scaled(pose)

    cls.forward = faulty
    try:
        yield
    finally:
        cls.forward = forward


@contextlib.contextmanager
def _float64(args):
    """The meta step in f64 wherever it computes in f32: ``args`` switched
    to compute dtype float64, every ``.float()`` made ``.double()`` (the
    plain versions' and BatchNorm's f32 statistics, the losses' means), the
    VGG towers in f64, and both kernels' places taken by their plain
    versions (the CUDA kernels take f32 and bf16 only)."""
    from latentpose_tpu_torch.losses.common.perceptual_loss import \
        PerceptualLoss
    to_float, build = torch.Tensor.float, train_cli.build_criteria
    compute_dtype = args.compute_dtype

    def criteria64(a, device):
        out = build(a, device)
        for crit in out:
            for sub in (crit, *vars(crit).values()):
                if isinstance(sub, PerceptualLoss):
                    sub.module.double()
        return out

    torch.Tensor.float = lambda self, *a, **k: self.double(*a, **k)
    holycow.DTYPES["float64"] = torch.float64
    train_cli.build_criteria = criteria64
    args.compute_dtype = "float64"
    try:
        with _plain_kernels():
            yield
    finally:
        torch.Tensor.float = to_float
        del holycow.DTYPES["float64"]
        train_cli.build_criteria = build
        args.compute_dtype = compute_dtype


def phase_meta_step_card_vs_cpu(args, meta_ckpt, loader, device):
    """One meta step from the same state and batch on the card and on the
    CPU: batch META_CHECK_BATCH, train-mode BatchNorm in both towers (its
    K=8 identity frames in the identity tower), the same dropout
    masks (drawn on the CPU, keyed on seed and step), augmentation off (its
    per-pixel fields come from a generator on the device).

    The state is the seeded meta checkpoint's, ``meta_ckpt``, the same in
    every call.  (A state that the card meta-trained is not: PyTorch's
    default cuDNN backward algorithms are nondeterministic, so two
    processes' first steps differ in f32's last bits and a few steps spread
    that over every leaf, the towers' conditioning with it; ROADMAP C.8,
    ``--meta-repro``.)  Its generator constant is spread
    (:func:`phase_meta_checkpoint` draws it from a normal).  The towers' train-form gradients at this
    state still carry a gap of a few 1e-2 (L2) in f32, the devices'
    convolutions or the link's kernel against its plain version: so beside
    the f32 gate run the card's step with ResNeXt-50's links through the
    plain version (what the kernel adds; the pose tower has no link, so its
    reading there is the card's own spread) and with a planted fault
    (FAULT_SCALE of the embeddings' gradient), which the gate must reject.

    Which of that gap is rounding: the same step in f64 on the card and on
    the CPU (:func:`_float64`) must agree within GRAD_TOL64 of every group's
    L2 (the non-kernel path is sound), with its own planted fault
    (FAULT_SCALE64) above that gate; and each f32 step's distance to its
    device's f64 step is f32's own rounding, which the train-form towers
    carry up to 1e-2, so in each tower the card's may be at most F32_C
    times the CPU's, a gate the 30 % fault must fail.  Every reading is
    printed before any is held to its gate."""
    args = copy.copy(args)
    args.use_pixelwise_augs = args.use_affine_scale = \
        args.use_affine_shift = False
    args.checkpoint_path = str(meta_ckpt)
    state = train_cli.load_checkpoint(args, torch.device("cpu"))
    host, keys = _batch_of(loader, META_CHECK_BATCH), holycow.META_STEP_KEYS
    embedder = type(state.models["embedder"])
    ways = {"card": contextlib.nullcontext, "card, plain link": _plain_link,
            "card, planted fault": lambda: _planted_fault(embedder)}
    cpu = _run_step(args, state, host, keys, torch.device("cpu"))
    runs, gaps = {}, {}
    for way, patch in ways.items():
        runs[way] = _run_step(args, state, host, keys, device, patch)
        gaps[way] = _gaps(cpu, runs[way])
        _print_gaps(f"meta step {way} vs cpu, batch {META_CHECK_BATCH} "
                    f"{args.image_size}² "
                    f"f32 (TF32 off; {runs[way][3]:.2f} s, cpu "
                    f"{cpu[3]:.2f} s)", *gaps[way])
    _print_gaps("meta step card, kernel vs plain link",
                *_gaps(runs["card, plain link"], runs["card"]))

    f64 = torch.float64
    cpu64 = _run_step(args, state, host, keys, torch.device("cpu"),
                      lambda: _float64(args), f64)
    card64 = _run_step(args, state, host, keys, device,
                       lambda: _float64(args), f64)

    @contextlib.contextmanager
    def fault64():
        with _float64(args), _planted_fault(embedder, FAULT_SCALE64):
            yield

    fault64_run = _run_step(args, state, host, keys, device, fault64, f64)
    gaps64 = {"card": _gaps(cpu64, card64),
              "card, planted fault": _gaps(cpu64, fault64_run)}
    for way, gap in gaps64.items():
        _print_gaps(f"meta step f64 {way} vs cpu f64, batch "
                    f"{META_CHECK_BATCH} "
                    f"{args.image_size}² (plain link and AdaIN; "
                    f"{card64[3]:.2f} s, cpu {cpu64[3]:.2f} s)", *gap)
    # f32 against its own rounding: each f32 step's distance to its own
    # device's f64 step
    own = {way: _gaps(card64, runs[way])[1]
           for way in ("card", "card, planted fault")}
    cpu_own = _gaps(cpu64, cpu)[1]
    ratios = {way: {k: own[way][k] / max(cpu_own[k], 1e-30)
                    for k in cpu_own if k.endswith("gradient")}
              for way in own}
    print("meta step f32 rounding: ‖T32 - T64‖ / L2 on the cpu: "
          + ", ".join(f"{k} {v:.3g}" for k, v in cpu_own.items()),
          flush=True)
    for way, ratio in ratios.items():
        print(f"meta step {way} f32 rounding against the cpu's "
              f"(‖T32_card - T64_card‖ / ‖T32_cpu - T64_cpu‖, gate "
              f"{F32_C}): " + ", ".join(f"{k} {v:.3g}"
                                        for k, v in ratio.items()),
              flush=True)

    _require_step("meta step", *gaps["card"], GRAD_TOL)
    rel = gaps["card, planted fault"][1]
    caught = [k for k in rel if k.startswith("embedder.")
              and k.endswith("gradient") and rel[k] > GRAD_TOL]
    require(len(caught) == 2, f"the planted fault passes the gate: {rel}")
    loss64, rel64 = gaps64["card"]
    name, gap = _worst_loss(loss64)
    require(gap <= GRAD_TOL64, f"card and CPU f64 meta steps differ: "
            f"losses {gap} ({name})")
    for key, value in rel64.items():
        require(value <= GRAD_TOL64, f"card and CPU f64 meta steps differ: "
                f"{key} {value} > {GRAD_TOL64}")
    rel = gaps64["card, planted fault"][1]
    caught = [k for k in rel if k.startswith("embedder.")
              and k.endswith("gradient") and rel[k] > GRAD_TOL64]
    require(len(caught) == 2, f"the f64 planted fault passes the f64 gate: "
            f"{rel}")
    for key, value in ratios["card"].items():
        require(value <= F32_C or not key.startswith("embedder."),
                f"the card's f32 meta step is further from its f64 step "
                f"than the CPU's: {key} {value} > {F32_C}")
    caught = [k for k, v in ratios["card, planted fault"].items()
              if k.startswith("embedder.") and v > F32_C]
    require(len(caught) == 2, f"the planted fault passes the f32 rounding "
            f"gate: {ratios['card, planted fault']}")


@contextlib.contextmanager
def _plain_kernels():
    """Both hand kernels' places taken by their plain versions, under
    autograd: ResNeXt-50's links and the generator's AdaIN."""
    adain = blocks.adain
    blocks.adain = adain_op.adain_reference
    try:
        with _plain_link():
            yield
    finally:
        blocks.adain = adain


def _bf16_stats_adain(x, weight, bias, relu=True, eps=1e-4):
    """AdaIN + ReLU with its statistics in bf16 (the planted fault of the
    bf16 gate): Σx and Σx² of each (sample, channel) accumulated pixel by
    pixel in bf16 (beyond 4096 pixels in 4096 rounds, a lane taking every
    4096th pixel), the lanes summed and the mean, E[x²] and the variance
    taken in bf16; the rest as the plain version, under autograd."""
    b, h, w, c = x.shape
    flat = x.to(torch.bfloat16).reshape(b, h * w, c)
    rounds = min(4096, h * w)
    flat = F.pad(flat, (0, 0, 0, -(h * w) % rounds))
    lanes = flat.reshape(b, rounds, -1, c)
    total = torch.zeros_like(lanes[:, 0])
    squares = torch.zeros_like(lanes[:, 0])
    for i in range(rounds):
        total = total + lanes[:, i]
        squares = squares + lanes[:, i] * lanes[:, i]
    mean = total.sum(dim=1, keepdim=True) / (h * w)
    var = torch.clamp(squares.sum(dim=1, keepdim=True) / (h * w)
                      - mean * mean, min=0.0)
    y = (x.float() - mean.float()[:, None]) * torch.rsqrt(
        var.float()[:, None] + eps)
    y = y * weight.float()[:, None, None] + bias.float()[:, None, None]
    return (torch.relu(y) if relu else y).to(x.dtype)


@contextlib.contextmanager
def _bf16_stats_fault():
    adain = blocks.adain
    blocks.adain = _bf16_stats_adain
    try:
        yield
    finally:
        blocks.adain = adain


def _gradient_vectors(run):
    """{group: flat f64 vector} of one :func:`_run_step`'s gradients: the
    generator's, the discriminator's, each tower's and the embedder's."""
    out = {}
    for (part, kind), leaves in run[2].items():
        if kind == "gradient":
            out[part] = torch.cat([v.double().flatten()
                                   for v in leaves.values()])
    out["embedder"] = torch.cat([out[k] for k in sorted(out)
                                 if k.startswith("embedder.")])
    return out


def phase_bf16_step_card(args, state, loader, device):
    """One meta step in bf16 against the same step in f32, on the card, from
    the same state and batch (batch 2, augmentation off, both towers
    in eval form: in train form their gradients turn any rounding into
    gaps of 1e-2 to 1 (ROADMAP.md C.3), bf16's effect included, which no
    planted fault could read above), and the bf16 step with both kernels'
    places taken by their plain versions: the
    gate of ``tests/test_torch_bf16.py`` with the plain bf16 step as the
    second bf16 route, ‖T16 − P16‖ ≤ BF16_C · ‖P16 − T32‖ for the losses
    and for the generator's, the discriminator's and the embedder's
    gradients (each tower's is printed too).  The planted fault (AdaIN's
    statistics in bf16) must read above BF16_C on the losses and on the
    generator's and the embedder's gradients in the same run: the
    embedder's gradient, through which the link is held, reaches it
    through the generator's AdaIN.  The discriminator's reads it only
    through the fake frames (0.73-6.1 on an H100) and is not required
    to.  Every reading is printed before any is held."""
    args = copy.copy(args)
    args.use_pixelwise_augs = args.use_affine_scale = \
        args.use_affine_shift = False
    args.set_eval_mode_in_train = True
    state = _copy_state(state, args, torch.device("cpu"))
    host, keys = _batch_of(loader, 2), holycow.META_STEP_KEYS
    bf16 = copy.copy(args)
    bf16.compute_dtype = "bfloat16"
    runs = {"T32": _run_step(args, state, host, keys, device),
            "T16": _run_step(bf16, state, host, keys, device),
            "P16": _run_step(bf16, state, host, keys, device,
                             _plain_kernels),
            "fault": _run_step(bf16, state, host, keys, device,
                               _bf16_stats_fault)}

    names = sorted(runs["T32"][0])
    vectors = {}
    for name, run in runs.items():
        vectors[name] = _gradient_vectors(run)
        vectors[name]["losses"] = torch.tensor([run[0][k] for k in names],
                                               dtype=torch.float64)

    def ratio(a, b, c, group):
        num = (vectors[a][group] - vectors[b][group]).norm().item()
        den = (vectors[b][group] - vectors[c][group]).norm().item()
        return num / den

    groups = sorted(vectors["T32"])
    gate = {g: ratio("T16", "P16", "T32", g) for g in groups}
    fault = {g: ratio("fault", "P16", "T32", g) for g in groups}
    effect = {g: ((vectors["T16"][g] - vectors["T32"][g]).norm()
                  / vectors["T32"][g].norm()).item() for g in groups}
    print(f"bf16 vs f32 meta step on the card, batch 2 {args.image_size}² "
          f"(TF32 off; {runs['T16'][3]:.2f} s bf16, {runs['T32'][3]:.2f} s "
          f"f32): bf16's effect ‖T16 - T32‖/‖T32‖ " + ", ".join(
              f"{g} {v:.3g}" for g, v in effect.items()), flush=True)
    print("bf16 gate ‖T16 - P16‖ / ‖P16 - T32‖ (kernels vs plain, in bf16; "
          f"gate {BF16_C}): " + ", ".join(f"{g} {v:.3g}"
                                           for g, v in gate.items())
          + "; planted fault (AdaIN's statistics in bf16): "
          + ", ".join(f"{g} {v:.3g}" for g, v in fault.items()), flush=True)
    held = ("losses", "generator", "discriminator", "embedder")
    worst = max(held, key=gate.get)
    require(gate[worst] <= BF16_C, f"the bf16 step on the card: {worst} "
            f"reads {gate[worst]} > {BF16_C}")
    caught = ("losses", "generator", "embedder")
    least = min(caught, key=fault.get)
    require(fault[least] > BF16_C, f"the planted fault passes the bf16 "
            f"gate: {least} {fault[least]} <= {BF16_C}")


_META_SAMPLES = {
    "identity tower conv3": lambda s: s.models["embedder"]
    .identity_encoder.layer1_0.conv3.weight,
    "pose tower classifier": lambda s: s.models["embedder"]
    .pose_encoder.classifier.weight,
    "generator head_conv": lambda s: s.models["generator"].head_conv.weight,
    "discriminator linear": lambda s: s.models["discriminator"].linear.weight,
    "identity bn3 running_mean": lambda s: s.models["embedder"]
    .identity_encoder.layer1_0.bn3.running_mean,
    "identity bn2 running_var": lambda s: s.models["embedder"]
    .identity_encoder.layer4_2.bn2.running_var,
}


def _launches():
    return {"bn_relu_conv1x1_stats": conv_bn.bn_relu_conv1x1_stats.launches,
            "adain_fused": adain_op.adain.launches}


def _zero_launches():
    conv_bn.bn_relu_conv1x1_stats.launches = 0
    adain_op.adain.launches = 0


@contextlib.contextmanager
def _link_input_layouts(state):
    """Record, for each Bottleneck of the identity tower, whether its
    grouped conv's output (the link's input) already lies channels_last, so
    that the ``.contiguous`` before the link copies nothing."""
    seen, handles = [], []
    for module in state.models["embedder"].identity_encoder.modules():
        if isinstance(module, backbones.Bottleneck):
            handles.append(module.conv2.register_forward_hook(
                lambda mod, inputs, out: seen.append(out.is_contiguous(
                    memory_format=torch.channels_last))))
    try:
        yield seen
    finally:
        for handle in handles:
            handle.remove()


def phase_meta_train(meta_ckpt, workdir, device, modes=()):
    """The train CLI's meta-train path on the card: resume the seeded meta
    checkpoint with the flags ``modes`` (``--compute_dtype``,
    ``--transfer_dtype``), META_STEPS steps on staged batches (as the
    loader gives them: uint8 on the wire), save, resume the result (its
    modes from the checkpoint alone) and take one more step, save.  Returns
    (args, state, loader, final checkpoint, launches, median step ms)."""
    argv = ["--dataloader", "synthetic", "--device", str(device),
            "--allow_random_vgg", "--batch_size", "8", "--num_epochs", "1",
            "--experiments_dir", str(workdir)]
    args = train_cli.resolve_args(argv + ["--checkpoint_path",
                                          str(meta_ckpt), *modes])
    label = f"{args.compute_dtype}, wire {args.transfer_dtype}"
    require(not args.finetune and args.use_pixelwise_augs
            and args.use_affine_scale and args.use_affine_shift
            and args.optimizer == "Adam" and len(args.criterions.split(","))
            == 6, f"meta-train args {vars(args)}")
    args.experiment_dir = str(workdir)
    loader = train_cli.build_dataloader(args)
    state = train_cli.load_checkpoint(args, device)
    criteria = train_cli.build_criteria(args, device)
    step_fn = train_cli.make_step(args, criteria)
    before = {k: _sample(f(state)) for k, f in _META_SAMPLES.items()}
    per_step = len(state.models["generator"].adain_features)     # 17
    batches = [holycow.to_device(loader.get_batch(i), device,
                                 holycow.META_STEP_KEYS)
               for i in range(META_STEPS)]
    wire = {"uint8": torch.uint8, "float32": torch.float32}
    require({b[k].dtype for b in batches for k in b if k != "label"}
            == {wire[args.transfer_dtype]}, f"staged batches are not "
            f"{args.transfer_dtype}")
    losses, times, launches = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = {"bn_relu_conv1x1_stats": 0, "adain_fused": 0}
    for batch in batches:
        torch.cuda.synchronize()
        _zero_launches()
        t0 = time.perf_counter()
        scalars = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches.append(_launches())
        total = {k: total[k] + v for k, v in launches[-1].items()}
        losses.append({k: float(v) for k, v in scalars.items()})
    peak = torch.cuda.max_memory_allocated() / 2**20
    for count in launches:
        require(count == {"bn_relu_conv1x1_stats": 16,
                          "adain_fused": per_step},
                f"meta step launched {count}, expected 16 conv_bn and "
                f"{per_step} AdaIN")
    require(all(np.isfinite(v) for s in losses for v in s.values()),
            f"non-finite meta losses: {losses[-1]}")
    require(len(losses[0]) == 9, f"meta losses {sorted(losses[0])}")
    for key, f in _META_SAMPLES.items():
        require(not torch.equal(before[key], _sample(f(state))),
                f"{key} did not change in meta-training")
    median = float(np.median(times))
    print(f"meta-train ({label}): {META_STEPS} steps, step {state.step}, "
          f"Adam count {state.opt_g.count}; first losses {losses[0]}; last "
          f"{losses[-1]}; launches per step {launches[0]}", flush=True)
    # one profiled step: its device busy time and its time by kind
    kinds, top = kernel_breakdown(lambda: step_fn(state, batches[1]))
    busy = None if kinds is None else sum(kinds.values())
    idle = "not measured" if busy is None else f"{1 - busy / median:.3f}"
    print(f"meta-train {label}, batch 8 K=8 {args.image_size}², 6 criteria, "
          f"3 augmentations: step_ms median={median:.2f} (each "
          f"{', '.join(f'{t:.1f}' for t in times)}) images/s="
          f"{8 / median * 1e3:.2f} peak_mem_MiB={peak:.0f}; one step "
          f"device_busy_ms={_ms(busy)} idle_share={idle}", flush=True)
    if kinds is not None:
        traced = sum(kinds.values())
        print(f"meta-train step ({label}) device time by kind: " + "; ".join(
            f"{k} {v:.2f} ms ({v / traced:.1%})" for k, v in
            sorted(kinds.items(), key=lambda kv: -kv[1])), flush=True)
        print(f"meta-train step's ({label}) ten longest kernels (ms): "
              + "; ".join(f"{n[:60]} {v:.2f}" for n, v in top), flush=True)

    path = train_cli.save(args, state)
    step, count = state.step, state.opt_g.count
    del state, step_fn, batches
    torch.cuda.empty_cache()
    modes = (args.compute_dtype, args.transfer_dtype)
    args = train_cli.resolve_args(argv + ["--checkpoint_path", str(path)])
    require((args.compute_dtype, args.transfer_dtype) == modes,
            f"resumed in {args.compute_dtype}, wire {args.transfer_dtype}; "
            f"saved in {modes}")
    args.experiment_dir = str(workdir)
    state = train_cli.load_checkpoint(args, device)
    require(state.step == step and state.opt_g.count == count
            and state.opt_d.count == count,
            f"resumed at step {state.step}, counts {state.opt_g.count} "
            f"{state.opt_d.count}; saved at {step}, {count}")
    step_fn = train_cli.make_step(args, train_cli.build_criteria(args,
                                                                 device))
    _zero_launches()
    with _link_input_layouts(state) as layouts:
        scalars = step_fn(state, holycow.to_device(
            loader.get_batch(META_STEPS), device, holycow.META_STEP_KEYS))
    torch.cuda.synchronize()
    resumed = _launches()
    require(len(layouts) == 16, f"{len(layouts)} link inputs, expected 16")
    print(f"meta-train ({label}): {sum(layouts)} of the 16 link inputs "
          f"leave the grouped conv channels_last ({16 - sum(layouts)} "
          f"copies a step before the link)", flush=True)
    total = {k: total[k] + v for k, v in resumed.items()}
    require(state.step == step + 1 and state.opt_g.count == count + 1
            and all(np.isfinite(float(v)) for v in scalars.values()),
            f"the resumed step: step {state.step}, count "
            f"{state.opt_g.count}")
    path = train_cli.save(args, state)
    print(f"meta-train ({label}) resumed from "
          f"{Path(args.checkpoint_path).name}: step "
          f"{step} -> {state.step}, Adam count {count} -> "
          f"{state.opt_g.count}; launches {resumed}; saved {path.name}",
          flush=True)
    return args, state, loader, path, total, median


def write_tree(root):
    """A VoxCeleb2-layout tree with no cv2: TREE's identities x videos x
    frames of rendered faces (SOURCE² PNG, the port's PNG writer), their
    head masks as segmentation PNGs, ``bboxes.npy`` boxes (256-space l, t,
    r, b, as the preprocessing writes them) for half the videos, which pads
    the crops and strips the 1px border, and ``train.csv`` (every video) and
    ``val.csv`` (two)."""
    root = Path(root)
    bboxes, rows = {}, []
    for i in range(TREE["identities"]):
        ident = f"id{i:05d}"
        for v in range(TREE["videos"]):
            video = f"video{v}"
            img_dir = root / "images-cropped" / ident / video
            segm_dir = root / "segmentation-cropped" / ident / video
            img_dir.mkdir(parents=True)
            segm_dir.mkdir(parents=True)
            boxes = []
            for f in range(TREE["frames"]):
                img, segm = render_face(i, 3 * f + 11 * v, SOURCE)
                write_png(img_dir / f"{f:05d}.png",
                          (img * 255 + 0.5).astype(np.uint8), level=1)
                write_png(segm_dir / f"{f:05d}.png",
                          (segm[..., 0] * 255 + 0.5).astype(np.uint8),
                          level=1)
                boxes.append([48 + 2 * f, 40 + v, 208 + 2 * f, 216 + v])
            if v % 2 == 0:
                bboxes.setdefault(ident, {})[video] = np.array(boxes,
                                                               np.float32)
            rows.append(f"{ident}/{video}")
    np.save(root / "bboxes.npy", bboxes, allow_pickle=True)
    (root / "train.csv").write_text("path\n" + "\n".join(rows) + "\n")
    (root / "val.csv").write_text("path\n" + "\n".join(rows[:2]) + "\n")
    return root, rows


@contextlib.contextmanager
def _counted_steps(record):
    """``train_cli.make_step``'s steps, each timed on the card and its
    kernel launches counted (the counters' difference across it), its losses
    kept: one dict a step in ``record``."""
    make_step = train_cli.make_step

    def counted_make_step(args, criteria):
        step = make_step(args, criteria)

        def counted(state, batch):
            torch.cuda.synchronize()
            before, t0 = _launches(), time.perf_counter()
            scalars = step(state, batch)
            torch.cuda.synchronize()
            after = _launches()
            record.append(dict(
                ms=(time.perf_counter() - t0) * 1e3,
                launches={k: after[k] - before[k] for k in after},
                losses={k: float(v) for k, v in scalars.items()},
                wire={v.dtype for k, v in batch.items() if k != "label"}))
            return scalars
        return counted

    train_cli.make_step = counted_make_step
    try:
        yield
    finally:
        train_cli.make_step = make_step


def _scalars(experiment):
    """{tag: [values by step]} of an experiment's scalars.jsonl."""
    out = {}
    for line in (Path(experiment) / "scalars.jsonl").read_text().splitlines():
        entry = json.loads(line)
        out.setdefault(entry["tag"], []).append(entry["value"])
    return out


def _require_steps(what, steps, per_step, count):
    require(len(steps) == count, f"{what}: {len(steps)} steps, expected "
            f"{count}")
    for s in steps:
        require(s["launches"] == per_step, f"{what} step launched "
                f"{s['launches']}, expected {per_step}")
        require(all(np.isfinite(v) for v in s["losses"].values()),
                f"{what}: non-finite losses {s['losses']}")


@contextlib.contextmanager
def _epoch_meters(meters):
    """The loop's own meters: the Meter of each epoch ``loop.run_epoch``
    returns, kept in ``meters``."""
    run_epoch = loop.run_epoch

    def kept(*a, **k):
        meters.append(run_epoch(*a, **k))
        return meters[-1]

    loop.run_epoch = kept
    try:
        yield
    finally:
        loop.run_epoch = run_epoch


def _loop_times(what, meters, steps):
    """The loop's Data_time and Batch_time (each epoch's mean, ms) and the
    counted steps' card time; returns the medians (step, Data_time,
    Batch_time) in ms."""
    data = [m.get_average("Data_time") * 1e3 for m in meters]
    batch = [m.get_average("Batch_time") * 1e3 for m in meters]
    times = [s["ms"] for s in steps]
    step = float(np.median(times))
    print(f"{what} through the real loader: the loop's Batch_time_ms "
          f"median={np.median(batch):.2f} (epoch means "
          f"{', '.join(f'{t:.1f}' for t in batch)}; with the visuals' and "
          f"probes' eval forwards at their steps) Data_time_ms median="
          f"{np.median(data):.2f} (epoch means "
          f"{', '.join(f'{t:.2f}' for t in data)}; "
          f"{np.median(data) / np.median(batch):.1%} of Batch_time); step_ms "
          f"median={step:.2f} (each {', '.join(f'{t:.1f}' for t in times)})",
          flush=True)
    return step, float(np.median(data)), float(np.median(batch))


def phase_real_data(meta_ckpt, tree, rows, workdir, device, staged_ms,
                    modes=()):
    """The real-data path through the CLIs' ``main`` with the flags
    ``modes`` (``--compute_dtype``, ``--transfer_dtype``): meta-train the
    seeded flagship meta checkpoint on the VoxCeleb2-layout ``tree``
    (validation, visuals with the cross-driving columns, fixed probes, PSNR
    and IoU), fine-tune the result from one video's directory, drive it
    from another's.  Returns (launches on these paths, {"meta", "finetune":
    the loop's medians (step, Data_time, Batch_time) ms})."""
    size = META["image_size"]
    wire = torch.uint8 if "uint8" in modes else torch.float32
    label = " ".join(modes) or "f32"
    tag = "_bf16" if "bfloat16" in modes else ""
    data = ["--dataloader", "voxceleb2_segmentation_nolandmarks",
            "--data_root", str(tree), "--bboxes_dir",
            str(tree / "bboxes.npy"), "--device", str(device),
            "--allow_random_vgg", "--experiments_dir", str(workdir), *modes]
    total = {"bn_relu_conv1x1_stats": 0, "adain_fused": 0}

    # meta-train: REAL_META_EPOCHS epochs of 2 steps at batch 8, K=8
    steps, meters = [], []
    torch.cuda.synchronize()
    _zero_launches()
    with _counted_steps(steps), _epoch_meters(meters):
        state, path = train_cli.main([
            "--checkpoint_path", str(meta_ckpt), *data,
            "--train_split_path", str(tree / "train.csv"),
            "--val_split_path", str(tree / "val.csv"),
            "--batch_size", "8", "--n_frames_for_encoder", "8",
            "--num_epochs", str(REAL_META_EPOCHS), "--no-skip_eval",
            "--metrics", "psnr,segmentation_iou",
            "--log_frequency_images", "2", "--log_frequency_fixed_images",
            "3", "--fixed_val_ids", "0", "--experiment_name",
            "real_meta" + tag])
    torch.cuda.synchronize()
    launches = _launches()
    total = {k: total[k] + launches[k] for k in total}
    adains = len(state.models["generator"].adain_features)      # 17 at 256²
    _require_steps("real-data meta", steps,
                   {"bn_relu_conv1x1_stats": 16, "adain_fused": adains},
                   2 * REAL_META_EPOCHS)
    require(path.name == f"model_{2 * REAL_META_EPOCHS:08d}.ckpt"
            and state.step == 2 * REAL_META_EPOCHS, f"meta checkpoint "
            f"{path.name} at step {state.step}")
    require(all(s["wire"] == {wire} for s in steps), f"real-data meta "
            f"({label}): batches {[s['wire'] for s in steps]}, expected "
            f"{wire}")
    experiment = Path(workdir) / ("real_meta" + tag)
    scalars = _scalars(experiment)
    require({"Metrics/train/loss_G", "Metrics/val/PSNR",
             "Fixed_metrics/train/PSNR"} <= set(scalars),
            f"scalars {sorted(scalars)}")
    # (rows, columns) of each grid: the train one with the cross-driving
    # columns, the probe one with its one sample
    layouts = {"Images_train": (2, 9), "Images_val": (2, 5),
               "Fixed_images_train": (1, 5)}
    grids = {g.name: native_loader.decode(g).shape
             for g in sorted((experiment / "images").glob("*.png"))}
    require({n.split("_visual")[0] for n in grids} == set(layouts),
            f"grids {sorted(grids)}")
    for name, shape in grids.items():
        r, c = layouts[name.split("_visual")[0]]
        require(shape == (38 + r * size, c * size, 3),
                f"{name} decodes to {shape}, expected {r} x {c} tiles")
    eval_launches = {k: launches[k] - sum(s["launches"][k] for s in steps)
                     for k in launches}
    print(f"real-data meta-train ({label}): {len(steps)} steps, step "
          f"{state.step}, "
          f"saved {path.name}; first losses {steps[0]['losses']}; "
          f"launches per step {steps[0]['launches']}; eval forwards' "
          f"launches {eval_launches} (visuals, cross-driving, fixed probes, "
          f"validation); grids {grids}; "
          f"val PSNR {scalars['Metrics/val/PSNR']}", flush=True)
    times = {"meta": _loop_times(f"meta step ({label})", meters, steps)}
    print(f"meta step, {label} batch 8 K=8 {size}²: real loader "
          f"{times['meta'][0]:.2f} ms vs staged batches {staged_ms:.2f} ms "
          f"(same run): {times['meta'][0] / staged_ms - 1:+.1%}", flush=True)
    del state
    torch.cuda.empty_cache()

    # fine-tune from one video's directory: ê, then a step an epoch
    steps, ehat, meters = [], {}, []
    start_finetuning = train_cli.start_finetuning

    def counted_start(*a):
        before = _launches()
        out = start_finetuning(*a)
        torch.cuda.synchronize()
        ehat.update({k: v - before[k] for k, v in _launches().items()})
        return out

    torch.cuda.synchronize()
    _zero_launches()
    train_cli.start_finetuning = counted_start
    try:
        with _counted_steps(steps), _epoch_meters(meters):
            state, ft_path = train_cli.main([
                "--finetune", "--config_name", "finetuning-base",
                "--checkpoint_path", str(path), *data,
                "--train_split_path", rows[4], "--skip_eval",
                "--batch_size", "8", "--num_epochs", str(REAL_FT_EPOCHS),
                "--log_frequency_fixed_images", "1",
                "--experiment_name", "real_finetune" + tag])
    finally:
        train_cli.start_finetuning = start_finetuning
    torch.cuda.synchronize()
    launches = _launches()
    total = {k: total[k] + launches[k] for k in total}
    require(ehat == {"bn_relu_conv1x1_stats": 16, "adain_fused": 0},
            f"ê over the directory launched {ehat}, expected 16 conv_bn")
    _require_steps("real-data fine-tune", steps,
                   {"bn_relu_conv1x1_stats": 0, "adain_fused": adains},
                   REAL_FT_EPOCHS)
    key = "params::generator::head_conv::kernel"
    with ckpt_lib.open_arrays(path) as before, \
            ckpt_lib.open_arrays(ft_path) as after:
        require(state.finetune and not np.array_equal(before[key],
                                                      after[key]),
                "the generator did not move in fine-tuning")
    eval_launches = {k: launches[k] - ehat[k]
                     - sum(s["launches"][k] for s in steps) for k in launches}
    require(all(s["wire"] == {wire} for s in steps), f"real-data fine-tune "
            f"({label}): batches {[s['wire'] for s in steps]}")
    print(f"real-data fine-tune ({label}) on {rows[4]}: ê launches {ehat}; "
          f"{len(steps)} steps, saved {ft_path.name}; losses "
          f"{steps[-1]['losses']}; fixed probes' launches {eval_launches}",
          flush=True)
    times["finetune"] = _loop_times(f"fine-tune step ({label})", meters,
                                    steps)
    del state
    torch.cuda.empty_cache()

    # drive from another video's frames (the C++ loader, bilinear)
    frames = cli.load_driver_frames(tree / "images-cropped" / rows[10], size)
    require(frames.shape == (TREE["frames"], size, size, 3)
            and frames.dtype == np.float32, f"driver frames {frames.shape}")
    # f32: drive_once holds the padded sequence against one call on the
    # first 12 frames, and bf16 rounds differently at another batch size
    _, _, _, drive_launches = drive_once(
        ft_path, ["--compute_dtype", "float32"], frames)
    total["adain_fused"] += drive_launches

    # the loader on this host: frames/s of the dataset's crop (the wire's
    # entry under uint8), and batches
    paths = sorted((tree / "images-cropped").rglob("*.png"))[:72]
    boxes = np.tile([[-0.1, -0.1, 1.1, 1.1]], (len(paths), 1))
    loader = native_loader.NativeBatchLoader()
    out = np.uint8 if wire == torch.uint8 else np.float32
    loader.load_cropped(paths[:8], boxes[:8], np.ones(8, np.uint8), size, out)
    t0 = time.perf_counter()
    loader.load_cropped(paths, boxes, np.ones(len(paths), np.uint8), size,
                        out)
    fps = len(paths) / (time.perf_counter() - t0)
    loader.close()
    print(f"native loader ({np.dtype(out).name} entry) on this host "
          f"({os.cpu_count()} CPUs, JPEG decoder "
          f"{native_loader.jpeg_decoder()}): {fps:.1f} frames/s "
          f"({SOURCE}² PNG -> padded crop -> {size}², 72 frames = one meta "
          f"batch's loads, {72 / fps * 1e3:.1f} ms)", flush=True)
    return total, times


def int8_conv_bound_ms(b, cin, cout, k, side, peak):
    """A quantized conv as a function of its bf16 input: x and the kernel
    read once, the bf16 output written once, 2 x MACs operations at
    ``peak``; returns (ms, "bytes" or "operations")."""
    nbytes = 2 * (b * cin * side * side + cout * cin * k * k
                  + b * cout * side * side)
    return bound_ms(nbytes, 2.0 * b * side * side * cin * k * k * cout, peak)


def phase_int8_convs(device):
    """The int8 product of every quantized conv of the flagship at batch
    DRIVE_BATCH (``gen_mod.quantized_conv_shapes``, 22): the card's route
    (im2col + ``torch._int_mm``) against the plain route (the exact float64
    convolution) on the same int8 inputs, on the card over the whole batch
    and on the CPU over its first and last sample; the bf16 epilogue of the
    card's accumulators against the CPU's of the plain ones.  Any
    difference fails.  Then per conv: the int8 route's time (quantize +
    im2col + GEMM + epilogue), the product's alone, cuDNN's bf16
    ``F.conv2d`` of the same shape, and both bounds.  Returns the rows."""
    b, rows = DRIVE_BATCH, []
    worst = {"card": 0, "cpu": 0, "bf16": 0.0}
    for i, (name, cin, cout, k, side) in enumerate(
            gen_mod.quantized_conv_shapes()):
        g = torch.Generator(device=device).manual_seed(100 + i)
        x = torch.relu(torch.randn(b, cin, side, side, generator=g,
                                   device=device)).to(torch.bfloat16) \
            .contiguous(memory_format=torch.channels_last)
        w = (torch.randn(cout, cin, k, k, generator=g, device=device)
             * (cin * k * k) ** -0.5).to(torch.bfloat16)
        pad = k // 2
        xq, s_x = quant.quantize_dynamic(x)
        kq, s_k = quant.quantize_kernel_per_channel(w)
        acc = quant.int8_conv(xq, kq, pad)
        plain = quant.int8_conv_reference(xq, kq, pad)
        ends = [0, b - 1]
        cpu = quant.int8_conv_reference(xq[ends].cpu(), kq.cpu(), pad)
        out = quant.epilogue(acc[ends], s_x, s_k, torch.bfloat16).cpu()
        out_cpu = quant.epilogue(cpu, s_x.cpu(), s_k.cpu(), torch.bfloat16)
        diff = {"card": int((acc - plain).abs().max()),
                "cpu": int((acc[ends].cpu() - cpu).abs().max()),
                "bf16": float((out.float() - out_cpu.float()).abs().max())}
        worst = {key: max(worst[key], diff[key]) for key in worst}
        del plain, cpu
        iters = 20 if side <= 32 else 5
        int8_ms = cuda_ms(lambda: quant.conv2d_int8(x, w, pad), iters)
        gemm_ms = cuda_ms(lambda: quant.int8_conv(xq, kq, pad), iters)
        bf16_ms = cuda_ms(lambda: F.conv2d(x, w, padding=pad), iters)
        bound8 = int8_conv_bound_ms(b, cin, cout, k, side, INT8_OPS)
        bound16 = int8_conv_bound_ms(b, cin, cout, k, side,
                                     PEAK_FLOPS[torch.bfloat16])
        rows.append((name, cin, cout, k, side, int8_ms, gemm_ms, bf16_ms,
                     bound8, bound16))
        print(f"int8 conv {name} (B={b}, {cin}->{cout}, {k}x{k}, {side}²): "
              f"card vs plain route max |d acc| {diff['card']} (card), "
              f"{diff['cpu']} (CPU, samples 0 and {b - 1}), bf16 out "
              f"{diff['bf16']:.3g}; int8_route_ms={int8_ms:.4f} "
              f"(product alone {gemm_ms:.4f}) cudnn_bf16_ms={bf16_ms:.4f}; "
              f"bound int8 {bound8[0]:.4f} ({bound8[1]}), bf16 "
              f"{bound16[0]:.4f} ({bound16[1]})", flush=True)
        del x, w, xq, kq, acc
    torch.cuda.empty_cache()
    total = [sum(r[j] for r in rows) for j in (5, 6, 7)]
    print(f"int8 convs, all {len(rows)} at batch {b}: largest differences "
          f"{worst}; int8 route {total[0]:.3f} ms (products alone "
          f"{total[1]:.3f}) against cuDNN bf16 {total[2]:.3f} ms; bounds "
          f"int8 {sum(r[8][0] for r in rows):.3f}, bf16 "
          f"{sum(r[9][0] for r in rows):.3f} ms", flush=True)
    require(len(rows) == 22, f"{len(rows)} quantized convs, expected 22")
    require(worst == {"card": 0, "cpu": 0, "bf16": 0.0},
            f"the card's int8 route differs from the plain route: {worst}")
    return rows


def _psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * np.log10(1.0 / mse) if mse else float("inf")


def phase_int8_drive(ckpt, workdir, frames, device):
    """int8 serving through ``cli.drive.main`` (cv2, PIL and imageio are
    unimportable): the fine-tuned checkpoint (seeded random weights, the
    JAX package's "proxy" mode of ``tools/check_int8_quality.py``) drives a
    directory of INT8_FRAMES PNG frames in bf16, ``--quantize int8`` and
    ``--quantize int8_static`` (calibrated on the leading frames), each
    counting its AdaIN launches and int8 products from just before to just
    after; each int8 mode's frames against the exact ones, gated at
    INT8_MIN_PSNR.  Then each mode's device step at batch 32 and 128 (in
    turns), and the calibration pass's time.  Returns the AdaIN launches."""
    size = FLAGSHIP["image_size"]
    source = Path(workdir) / "int8_driver"
    source.mkdir(parents=True)
    for f in range(INT8_FRAMES):
        img, _ = render_face(5, f, size)
        write_png(source / f"{f:05d}.png", (img * 255).astype(np.uint8))
    batch = DRIVE_BATCH
    batches = -(-INT8_FRAMES // batch)
    plan = gen_mod.quantized_conv_shapes(
        FLAGSHIP["num_channels"], FLAGSHIP["max_num_channels"],
        FLAGSHIP["gen_constant_input_size"],
        FLAGSHIP["gen_num_residual_blocks"], size)
    adain_features = gen_mod.schedule(
        FLAGSHIP["num_channels"], FLAGSHIP["max_num_channels"],
        FLAGSHIP["gen_constant_input_size"],
        FLAGSHIP["gen_num_residual_blocks"], size)[1]
    # 17 and 22 at 256²
    per_forward = {"adain": len(adain_features), "int8": len(plan)}
    outs, adains = {}, 0
    for mode in QUANT_MODES:
        flags = ["--quantize", mode] if mode else []
        if mode == "int8_static":
            flags += ["--calibration_frames", str(INT8_CALIB_FRAMES)]
        torch.cuda.synchronize()
        adain_op.adain.launches = quant.int8_conv.launches = 0
        t0 = time.perf_counter()
        written = cli.main([str(ckpt), "--images_paths", str(source),
                            "--destination",
                            str(Path(workdir) / f"int8_out_{mode or 'bf16'}"),
                            "--device", str(device), "--drive_batch_size",
                            str(batch), *flags])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = {"adain": adain_op.adain.launches,
               "int8": quant.int8_conv.launches}
        adains += got["adain"]
        # int8_static also runs the calibration pass on its leading frames
        forwards = batches + (-(-INT8_CALIB_FRAMES // batch)
                              if mode == "int8_static" else 0)
        want = {"adain": per_forward["adain"] * forwards,
                "int8": per_forward["int8"] * forwards if mode else 0}
        files = sorted(Path(f"{written[0]}.frames").glob("*.png"))
        require(len(files) == INT8_FRAMES, f"--quantize {mode!r} wrote "
                f"{len(files)} frames")
        outs[mode] = np.stack([native_loader.decode(f)[:, size:]
                               for f in files])
        print(f"drive CLI {mode or 'bf16'} on {INT8_FRAMES} PNG frames (cv2, "
              f"PIL, imageio unimportable): {seconds:.2f} s, launches {got} "
              f"(expected {want}: {forwards} generator forwards)",
              flush=True)
        require(got == want, f"--quantize {mode!r} launched {got}, "
                f"expected {want}")
    # static scales from the leading frames, dynamic ones per batch
    print(f"int8_static against int8: PSNR "
          f"{_psnr(outs['int8_static'] / 255.0, outs['int8'] / 255.0):.2f} dB, "
          f"{int((outs['int8_static'] != outs['int8']).sum())} of "
          f"{outs['int8'].size} output bytes differ", flush=True)
    for mode in QUANT_MODES[1:]:
        psnr = _psnr(outs[mode] / 255.0, outs[""] / 255.0)
        print(f"int8 quality ({mode}, seeded random weights: the JAX "
              f"package's proxy mode): PSNR {psnr:.2f} dB against the exact "
              f"bf16 frames (gate >= {INT8_MIN_PSNR})", flush=True)
        require(np.isfinite(outs[mode]).all() and psnr >= INT8_MIN_PSNR,
                f"--quantize {mode}: PSNR {psnr:.2f} dB")

    # device steps, frames on the card (uint8), modes in turns
    seq = np.concatenate([frames] * (128 // len(frames)))
    steps, calib_ms = {}, None
    drive = {}
    for mode in QUANT_MODES:
        flags = ["--quantize", mode] if mode else []
        args = cli.resolve_args([str(ckpt), "--device", str(device),
                                 *flags])
        models, state = cli.load_finetuned(args, device)
        calib = None
        if mode == "int8_static":
            calib_frames = seq[:args.calibration_frames]
            drive_lib.calibrate_quant_scales(models, args, state,
                                             calib_frames, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calib = drive_lib.calibrate_quant_scales(models, args, state,
                                                     calib_frames, batch)
            torch.cuda.synchronize()
            calib_ms = (time.perf_counter() - t0) * 1e3
        drive[mode] = (drive_lib.make_drive_fn(models, args, calib), state)
    for b in (32, 128):
        wire = torch.from_numpy((seq[:b] * 255).astype(np.uint8)).to(device)
        for mode in QUANT_MODES + QUANT_MODES[::-1]:
            fn, state = drive[mode]
            steps.setdefault((b, mode), []).append(
                cuda_ms(lambda: fn(state, wire), 5))
    for (b, mode), ms in steps.items():
        print(f"drive device step {mode or 'bf16'} batch {b}: step_ms="
              f"{ms[0]:.3f} / {ms[1]:.3f} (two turns) device_step_fps="
              f"{b / min(ms) * 1e3:.1f}", flush=True)
    print(f"int8_static calibration pass: {args.calibration_frames} frames "
          f"at batch {batch} in {calib_ms:.2f} ms", flush=True)
    del drive
    torch.cuda.empty_cache()
    return adains


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
    (512 host f32 frames in, results out) and the device step alone, with
    the step's device-busy time and AdaIN's part of it from the profiler."""
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
        busy, parts = device_busy_ms(lambda: drive_fn(state, wire), 5,
                                     ["adain_cluster"])
        traced = ("device busy not measured" if busy is None else
                  f"device_busy_ms={busy:.3f} (idle {1 - busy / step_ms:.2f} "
                  f"of the untraced step) adain_kernel_ms="
                  f"{parts['adain_cluster']:.3f}")
        print(f"drive bf16 batch {batch}: end_to_end_fps={e2e:.1f} "
              f"({len(seq)} f32 frames from host) step_ms={step_ms:.3f} "
              f"device_step_fps={batch / step_ms * 1e3:.1f} "
              f"peak_mem_MiB={peak:.0f}; {traced}", flush=True)


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


# ------------------------------------------------------ export, reference .pth

# Run in a child with the blocked imports (CHILD_SITE), started before the
# exports: it loads a small artifact (the deserialiser's imports, the card's
# context), says it is ready, and waits for the jobs' file on its input;
# then for each job it loads a ``.pt2``, runs it once over the frames with
# the kernel's launches counted, saves the frames, and times its step with
# CUDA events.
EXPORT_CHILD = '''
import json, sys, time
import numpy as np, torch
from latentpose_tpu_torch.cli.export import load_serving_artifact
from latentpose_tpu_torch.ops import adain
device, warm = sys.argv[1:3]
# as eager drive runs in the smoke: cuDNN's convolutions in full f32
torch.backends.cudnn.allow_tf32 = False
cuda = device == "cuda"
sync = torch.cuda.synchronize if cuda else (lambda: None)
load_serving_artifact(warm)
print("export child: ready", flush=True)
jobs = json.loads(open(sys.stdin.readline().strip()).read())
for job in jobs:
    t0 = time.perf_counter()
    serve = load_serving_artifact(job["pt2"])
    load_s = time.perf_counter() - t0
    frames = torch.from_numpy(np.load(job["frames"])).to(device)
    sync()
    adain.adain.launches = 0
    with torch.inference_mode():
        rgbs, segm = serve(frames)
    sync()
    launches = adain.adain.launches
    np.save(job["out"], rgbs.cpu().numpy())
    serve(frames)
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        sync()
        start.record()
        for _ in range(5):
            serve(frames)
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / 5
    else:
        t0 = time.perf_counter()
        serve(frames)
        step_ms = (time.perf_counter() - t0) * 1e3
    del serve
    print("export child: " + json.dumps({
        "name": job["name"], "launches": launches, "load_s": load_s,
        "step_ms": step_ms,
        "segm": None if segm is None else list(segm.shape)}), flush=True)
'''


def _on(device):
    """The flag that moves a CLI off its default device, the card."""
    return [] if device.type == "cuda" else ["--device", str(device)]


def _run_child(command, env, prefix=None):
    """A child process with ``env``; (its last output line that starts with
    ``prefix``, parsed as JSON after it, or None; wall seconds; the
    completed process).  A child that fails fails the smoke."""
    t0 = time.perf_counter()
    proc = subprocess.run(command, env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode:
        print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
    require(proc.returncode == 0, f"child {command[1:3]} exited with "
            f"{proc.returncode}")
    found = [line[len(prefix):] for line in proc.stdout.splitlines()
             if prefix and line.startswith(prefix)]
    return (json.loads(found[-1]) if found else None), wall, proc


def phase_export(ckpt, avatars, workdir, frames, device):
    """``cli.export.main`` on the card at batch 32 on the uint8 wire: the
    fine-tuned flagship checkpoint in bf16, and in int8_static calibrated
    on the smoke's 32 frames (``synthetic://3``, named explicitly); the
    ablation avatars (``avatars``: FAbNet+, X2Face+ and X2Face, from
    :func:`phase_ablations`) in f32.  One child with the blocked imports
    loads each ``.pt2`` in turn and serves the same frames, against eager
    ``drive_sequence`` here within 1e-3, with the AdaIN launches a forward
    through the operator reckoned from the code (17; X2Face none, and no
    mask); the bf16 artifact against eager drive with the head AdaIN's
    weights moved by 0.05 must read above that gate.  The child starts
    before the exports and waits for its jobs, so its start-up runs beside
    them; it serves and times alone.  The export's seconds and bytes, the
    load's seconds, the artifact's step (CUDA events) beside eager's.
    Returns the child's AdaIN launches."""
    t_phase = time.perf_counter()
    workdir.mkdir(parents=True, exist_ok=True)
    env = child_env(workdir)
    (workdir / "export_child.py").write_text(EXPORT_CHILD)
    wire = (frames * 255 + 0.5).astype(np.uint8)
    np.save(workdir / "frames.npy", wire)
    host = torch.from_numpy(wire).to(device)
    warm = workdir / "warm.pt2"
    torch.export.save(torch.export.export(
        torch.nn.Conv2d(3, 3, 1).to(device),
        (torch.zeros(1, 3, 8, 8, device=device),)), str(warm))
    t_child = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, str(workdir / "export_child.py"), device.type,
         str(warm)], env=env, cwd=ROOT, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        return _export_jobs(ckpt, avatars, workdir, frames, device, wire,
                            host, child, t_child, t_phase)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


def _export_jobs(ckpt, avatars, workdir, frames, device, wire, host, child,
                 t_child, t_phase):
    """:func:`phase_export`'s exports, eager drives and checks, with the
    serving ``child`` started."""
    from latentpose_tpu_torch.cli import export as export_cli
    # (name, checkpoint, the export's flags, drive's flags, AdaIN launches
    # a forward); the ablation avatars in f32, as the CPU tests hold them
    f32 = ["--compute_dtype", "float32"]
    quant = ["--quantize", "int8_static"]
    jobs = [("bf16", ckpt, [], [], ADAIN_PER_FORWARD),
            ("int8_static", ckpt, quant + ["--calibration_source",
                                           "synthetic://3"], quant,
             ADAIN_PER_FORWARD)]
    jobs += [(name, path, f32, f32,
              0 if name == "X2Face" else ADAIN_PER_FORWARD)
             for name, path in avatars.items()]
    wants, notes = {}, {}
    for mode, path, flags, drive_flags, _ in jobs:
        dest = workdir / f"{mode}.pt2"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export_cli.main([str(path), "--destination", str(dest),
                         "--transfer_dtype", "uint8", *flags, *_on(device)])
        torch.cuda.synchronize()
        export_s = time.perf_counter() - t0
        meta = json.loads(Path(f"{dest}.json").read_text())
        masked = mode != "X2Face"
        require(meta["platforms"] == [device.type] and meta["batch_size"] ==
                DRIVE_BATCH and meta["transfer_dtype"] == "uint8"
                and meta["outputs"] == ["fake_rgbs",
                                        "fake_segm" if masked else None],
                f"export {mode}: {meta}")
        args = cli.resolve_args([str(path), *drive_flags])
        models, state = cli.load_finetuned(args, device)
        calib = None if mode != "int8_static" else \
            drive_lib.calibrate_quant_scales(models, args, state, frames,
                                             batch_size=DRIVE_BATCH)
        drive_fn = drive_lib.make_drive_fn(models, args, quant_calib=calib)
        wants[mode] = drive_lib.drive_sequence(drive_fn, state, wire,
                                               DRIVE_BATCH)
        notes[mode] = (export_s, meta["bytes"],
                       cuda_ms(lambda: drive_fn(state, host), 5))
        if mode == "bf16":      # the planted fault: eager drive moved
            head = models["generator"].adain_features[-1]
            with torch.no_grad():
                models["generator"].projector_1.bias[-head:] += 0.05
            faulty = drive_lib.drive_sequence(
                drive_lib.make_drive_fn(models, args), state, wire,
                DRIVE_BATCH)
        del models, state, drive_fn
        torch.cuda.empty_cache()

    spec = [{"name": mode, "pt2": str(workdir / f"{mode}.pt2"),
             "frames": str(workdir / "frames.npy"),
             "out": str(workdir / f"{mode}.npy")} for mode, *_ in jobs]
    (workdir / "jobs.json").write_text(json.dumps(spec))
    t0 = time.perf_counter()
    out, _ = child.communicate(str(workdir / "jobs.json") + "\n",
                               timeout=900)
    served, wall = time.perf_counter() - t0, time.perf_counter() - t_child
    if child.returncode:
        print(out[-3000:], flush=True)
    require(child.returncode == 0, f"the export child exited with "
            f"{child.returncode}")
    require("export child: ready" in out, "the export child did not warm up")
    records = {r["name"]: r for r in (
        json.loads(line[len("export child: "):])
        for line in out.splitlines()
        if line.startswith("export child: {"))}
    require(set(records) == set(wants), f"export child served "
            f"{sorted(records)}, exported {sorted(wants)}")
    launches = 0
    size = FLAGSHIP["image_size"]
    for mode, _, _, _, per_forward in jobs:
        record, want = records[mode], wants[mode]
        got = np.load(workdir / f"{mode}.npy")
        gap = float(np.abs(got - want).max())
        launches += record["launches"]
        export_s, nbytes, eager_ms = notes[mode]
        print(f"export {mode}: cli.export {export_s:.2f} s, {nbytes} bytes "
              f"({nbytes / 2**20:.1f} MiB); in the child load "
              f"{record['load_s']:.2f} s; artifact vs eager drive_sequence, "
              f"{len(wire)} frames: max_abs_diff {gap:.3g} (gate 1e-3); "
              f"adain launches in one forward {record['launches']} "
              f"(reckoned {per_forward}); step at batch {DRIVE_BATCH}: "
              f"artifact {record['step_ms']:.3f} ms, eager {eager_ms:.3f} "
              f"ms (events)", flush=True)
        segm = None if mode == "X2Face" else [len(wire), size, size, 1]
        require(np.isfinite(got).all() and got.shape == want.shape and
                record["segm"] == segm,
                f"export {mode}: frames {got.shape}, segm {record['segm']}")
        require(gap <= 1e-3, f"export {mode}: the artifact differs from "
                f"eager drive by {gap}")
        require(record["launches"] == per_forward,
                f"export {mode}: {record['launches']} AdaIN launches a "
                f"forward, reckoned {per_forward}")
    fault = float(np.abs(np.load(workdir / "bf16.npy") - faulty).max())
    print(f"export planted fault (eager drive with the head AdaIN's "
          f"weights + 0.05) against the bf16 artifact: max_abs_diff "
          f"{fault:.3g} (gate 1e-3)", flush=True)
    require(fault > 1e-3, f"the planted export fault passes the gate: "
            f"{fault}")
    print(f"export: one child served {len(jobs)} artifacts in {served:.1f} "
          f"s after its jobs came ({wall:.1f} s from its start, beside the "
          f"exports); phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def phase_reference_checkpoint(workdir, device):
    """The reference's checkpoints without JAX: ``tools/
    fabricate_reference_checkpoint.py`` as a child with the blocked imports
    writes a reference-shaped ``.pth`` at 256² in its meta and fine-tuned
    forms; the port's ``cli.convert_reference_checkpoint`` converts both
    here; the meta one loads whole into the train state on the card
    (``cli.train``'s loader), the fine-tuned one drives ``synthetic://3``
    through ``cli.drive.main`` (17 AdaIN launches).  Returns those
    launches."""
    from latentpose_tpu_torch.cli import convert_reference_checkpoint as conv
    t_phase = time.perf_counter()
    workdir.mkdir(parents=True, exist_ok=True)
    env = child_env(workdir)
    out, forms = {}, (("meta", []), ("finetuned", ["--finetune"]))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(forms)) as pool:
        walls = [future.result()[1] for future in [pool.submit(
            _run_child, [sys.executable, str(
                ROOT / "tools" / "fabricate_reference_checkpoint.py"),
                str(workdir / f"{form}.pth"), "--image_size", "256",
                "--iteration", "1230", *flags], env)
            for form, flags in forms]]
    print(f"reference checkpoint: both forms fabricated by two children at "
          f"once in {time.perf_counter() - t0:.1f} s", flush=True)
    for (form, _), wall in zip(forms, walls):
        pth = workdir / f"{form}.pth"
        t0 = time.perf_counter()
        out[form] = conv.main([str(pth), str(workdir / form)])
        convert_s = time.perf_counter() - t0
        arrays = out[form] / "arrays.npz"
        with np.load(arrays) as raw:
            count = len(raw.files)
        print(f"reference checkpoint {form}: fabricated in a child "
              f"{wall:.1f} s ({pth.stat().st_size / 2**20:.1f} MiB .pth); "
              f"converted by the port in {convert_s:.2f} s: {count} arrays, "
              f"{arrays.stat().st_size / 2**20:.1f} MiB", flush=True)
        pth.unlink()
    args = train_cli.resolve_args(["--checkpoint_path", str(out["meta"]),
                                   *_on(device)])
    state = train_cli.load_checkpoint(args, device)
    require(state.step == 1230 and not state.finetune and args.num_labels
            == 100, f"converted meta checkpoint: step {state.step}")
    del state
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    adain_op.adain.launches = 0
    written = cli.main([str(out["finetuned"]), "--images_paths",
                        "synthetic://3", "--destination",
                        str(workdir / "drive"), "--drive_batch_size",
                        str(DRIVE_BATCH), *_on(device)])
    torch.cuda.synchronize()
    launches = adain_op.adain.launches
    frames = sorted(Path(f"{written[0]}.frames").glob("*.png"))
    print(f"reference checkpoint: the meta form loads whole into the train "
          f"state on the card (step 1230, 100 labels); the fine-tuned form "
          f"drives synthetic://3 through cli.drive.main: {len(frames)} "
          f"frames, adain launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    require(len(frames) == 32 and launches == ADAIN_PER_FORWARD,
            f"reference drive: {len(frames)} frames, {launches} launches")
    return launches


# ---------------------------------------------------------------- preprocess


def _seeded(net, seed):
    """``net`` with seeded weights in eval form: kernels ~ N(0, 1/fan-in),
    biases and BatchNorm offsets within 0.1 of 0, BatchNorm scales and
    variances in [0.5, 1.5], means within 0.3 of 0 (eval-form BatchNorm is
    not the identity); Graphonomy's label adjacency ~ N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                                 generator=g)
                if m.bias is not None:
                    m.bias.uniform_(-0.1, 0.1, generator=g)
            elif isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.1, 0.1, generator=g)
                m.running_mean.uniform_(-0.3, 0.3, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
            elif isinstance(m, graph_mod.GraphReasoning):
                m.adjacency.normal_(generator=g)
    return net.eval()


def _cls_logits(net, frame, device):
    """S³FD's six class heads' face-minus-background logit on one frame
    (conv3_3's background the max of its first three channels)."""
    out, hooks = [], []
    for i in range(6):
        hooks.append(getattr(net, f"cls{i}").register_forward_hook(
            lambda mod, inp, o: out.append(o.detach())))
    try:
        with torch.no_grad():
            net.to(device)(s3fd_mod.preprocess(
                torch.from_numpy(frame[None]).to(device)))
    finally:
        for h in hooks:
            h.remove()
    return [o[:, 3] - o[:, :3].amax(1) if i == 0 else o[:, 1] - o[:, 0]
            for i, o in enumerate(out)]


def _background_logit(net, image, device):
    """Graphonomy's log P(background) / P(person) at each pixel of one
    (H, W, 3) uint8 image."""
    x = torch.from_numpy(image[None]).to(device).permute(0, 3, 1, 2)
    with torch.no_grad():
        p0 = net.to(device)(x.float() / 255.0)[:, 0].double()
    return torch.log(p0) - torch.log1p(-p0)


def write_prep_weights(wdir, frame, device):
    """Seeded S³FD, FAN (4 modules) and Graphonomy (Xception-65, 20 CIHP
    classes) at their published widths, written by the port's inverse
    converter in the JAX package's flat-npz layout (``s3fd.npz``,
    ``fan_2d.npz``, ``graphonomy.npz``) and read back bit-equal.  S³FD's
    offset heads are scaled down (boxes near their anchors) and each class
    head's face bias set PREP_ANCHOR_SIGMA of its logit's spread on
    ``frame`` above the mean, so that few anchors pass the decode's fixed
    threshold; Graphonomy's background bias is set so that its person
    probability's median on ``frame`` (resized to 256²) is 0.5."""
    empty = weights.empty_module      # _seeded sets every drawn value
    nets = {"s3fd.npz": _seeded(empty(s3fd_mod.S3FD), 11),
            "fan_2d.npz": _seeded(empty(fan_mod.FAN), 12),
            "graphonomy.npz": _seeded(empty(graph_mod.Graphonomy), 13)}
    s3fd_net = nets["s3fd.npz"]
    with torch.no_grad():
        for i in range(6):
            getattr(s3fd_net, f"reg{i}").weight.mul_(0.05)
        for i, d in enumerate(_cls_logits(s3fd_net, frame, device)):
            shift = float(d.mean() + PREP_ANCHOR_SIGMA * d.std())
            getattr(s3fd_net, f"cls{i}").bias[-1] -= shift
        s3fd_net.cpu()
        seg_net = nets["graphonomy.npz"]
        small = resize_linear(torch.from_numpy(frame[None]), (256, 256))[0]
        seg_net.classifier.bias[0] -= float(
            _background_logit(seg_net, small.numpy(), device).median())
        seg_net.cpu()
    wdir.mkdir(parents=True, exist_ok=True)
    for name, net in nets.items():
        np.savez(wdir / name, **weights.flax_from_state_dict(net))
        back = weights.state_dict_from_flax(
            net, weights.load_flat_npz_variables(str(wdir / name)))
        own = net.state_dict()
        require(all(torch.equal(back[k], own[k]) for k in back)
                and len(back) == len([k for k in own
                                      if "num_batches" not in k]),
                f"{name} does not round-trip bit-equal")
        size = (wdir / name).stat().st_size
        print(f"preprocess weights: {name} {len(back)} arrays, "
              f"{size / 2**20:.1f} MiB, round-trip bit-equal", flush=True)


def write_raw_tree(root):
    """PREP's identities x videos x frames of ``render_face`` pasted off
    centre on PREP_CANVAS canvases (PNG, the port's encoder), and
    ``bboxes.npy``: {identity: {video: {frame: LTRB}}} in the dataset's
    256-space (pixels x 256 / frame height)."""
    h, w = PREP_CANVAS
    face = PREP_FACE
    bboxes = {}
    for i in range(PREP["identities"]):
        for v in range(PREP["videos"]):
            d = root / "images-raw" / f"id{i:05d}" / f"video{v}"
            d.mkdir(parents=True)
            boxes = {}
            for f in range(PREP["frames"]):
                img = (render_face(i, 5 * f + 13 * v, face)[0] * 255
                       + 0.5).astype(np.uint8)
                canvas = np.full((h, w, 3), 90 + 20 * i, np.uint8)
                y, x = 40 + 9 * f + 20 * v, 80 + 30 * f + 60 * i
                canvas[y:y + face, x:x + face] = img
                write_png(d / f"{f:05d}.png", canvas, level=1)
                boxes[f] = np.array([x, y, x + face, y + face],
                                    np.float32) * 256 / h
            bboxes.setdefault(f"id{i:05d}", {})[f"video{v}"] = boxes
    np.save(root / "bboxes.npy", bboxes, allow_pickle=True)
    return root / "images-raw", root / "bboxes.npy"


@contextlib.contextmanager
def _stage_timers(record):
    """Each preprocessing stage's calls timed (host clock, the card
    synchronised) with its frames and peak device memory: S³FD with its
    host NMS ("detect"), FAN ("landmarks"), the C++ crop ("crop"),
    Graphonomy at the test-time scales ("segment")."""
    targets = [(croppers.S3FDDetector, "__call__", "detect"),
               (backends.FANBackend, "__call__", "landmarks"),
               (native_loader.NativeBatchLoader, "crop_boxes", "crop"),
               (segmentation, "segment_with_tta", "segment")]
    saved = []
    for owner, name, stage in targets:
        fn = getattr(owner, name)
        saved.append((owner, name, fn))

        def timed(*a, _fn=fn, _stage=stage, **k):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            entry = record.setdefault(_stage, [0.0, 0, 0.0])
            entry[0] += time.perf_counter() - t0
            entry[1] += len(a[1])        # each target's second argument
            entry[2] = max(entry[2],
                           torch.cuda.max_memory_allocated() / 2**20)
            return out

        setattr(owner, name, timed)
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _rel_gap(got, want):
    """Largest |got - want| over max |want|."""
    want = want.double()
    return float((got.double().cpu() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _prep_gate(what, runs, faulty):
    """Print each net's card-vs-CPU reading and its planted fault's, then
    hold the first within PREP_TOL and the second above it."""
    print(f"preprocess card vs cpu, {what} (TF32 off): max_rel_diff="
          f"{runs:.3g}, planted fault {faulty:.3g} (gate {PREP_TOL})",
          flush=True)
    require(runs <= PREP_TOL, f"card and CPU {what} differ: {runs}")
    require(faulty > PREP_TOL, f"the planted fault passes the {what} gate: "
            f"{faulty}")


def phase_prep_card_vs_cpu(wdir, frame, crop, device):
    """S³FD's six heads at PREP_CANVAS, FAN's four heatmap stacks at 256²
    and Graphonomy's probabilities at 512² on the card and on the CPU from
    the same weights and frames, each within PREP_TOL of its max; beside
    each the card with a planted fault (S³FD: conv3_3's L2Norm scale
    x1.03; FAN: the stem BatchNorm's eps 1e-5 -> 0.1; Graphonomy: the graph
    reasoning's residual dropped), which must read above the gate."""
    cpu = torch.device("cpu")
    dets = {d: croppers.S3FDDetector(wdir / "s3fd.npz", d)
            for d in (cpu, device)}
    want = dets[cpu].heads(frame[None])

    def s3fd_gap():
        got = dets[device].heads(frame[None])
        return max(_rel_gap(g, w) for gh, wh in zip(got, want)
                   for g, w in zip(gh, wh))

    runs = s3fd_gap()
    with torch.no_grad():
        dets[device].model.l2norm3.scale.mul_(1.03)
    _prep_gate(f"S3FD six heads at {PREP_CANVAS[1]}x{PREP_CANVAS[0]}", runs,
               s3fd_gap())
    del dets

    fans = {d: backends.FANBackend(wdir / "fan_2d.npz", d)
            for d in (cpu, device)}
    want = fans[cpu].heatmaps(crop[None])

    def fan_gap():
        return max(_rel_gap(g, w) for g, w in
                   zip(fans[device].heatmaps(crop[None]), want))

    runs = fan_gap()
    fans[device].model.bn1.eps = 0.1
    _prep_gate("FAN four heatmap stacks at 256²", runs, fan_gap())
    del fans

    big = resize_linear(torch.from_numpy(crop[None]),
                                     (512, 512))
    x = big.permute(0, 3, 1, 2).float() / 255.0
    segs = {d: segmentation.GraphonomyBackend(wdir / "graphonomy.npz", d)
            for d in (cpu, device)}
    with torch.no_grad():
        want = segs[cpu].model(x)

        def seg_gap():
            return _rel_gap(segs[device].model(x.to(device)), want)

        runs = seg_gap()
        refine = segs[device].model.classifier_refine
        refine.weight.zero_()
        refine.bias.zero_()
        _prep_gate("Graphonomy probabilities at 512²", runs, seg_gap())
    del segs
    torch.cuda.empty_cache()


def _prep_net_times(wdir, frames, crops, device):
    """Each net's device time per batch of PREP_BATCH and per frame
    (events, after a warm-up), and one segmentation batch (the four scales)
    traced: its device busy time, the idle share of its untraced wall time
    and its longest kernels."""
    det = croppers.S3FDDetector(wdir / "s3fd.npz", device)
    x = s3fd_mod.preprocess(torch.from_numpy(frames[:PREP_BATCH]).to(device))
    fan = backends.FANBackend(wdir / "fan_2d.npz", device)
    seg = segmentation.GraphonomyBackend(wdir / "graphonomy.npz", device)
    c = torch.from_numpy(crops[:PREP_BATCH]).to(device)
    y = c.permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        calls = {f"S3FD {PREP_CANVAS[1]}x{PREP_CANVAS[0]}":
                 lambda: det.model(x),
                 "FAN 256²": lambda: fan.model(y)}
        for s in segmentation.TTA_SCALES:
            side = int(256 * s)
            z = resize_linear(c, (side, side)).permute(
                0, 3, 1, 2).float() / 255.0
            calls[f"Graphonomy {side}²"] = lambda z=z: seg.model(z)
        for name, fn in calls.items():
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(fn, 3)
            peak = torch.cuda.max_memory_allocated() / 2**20
            print(f"preprocess net {name}, batch {PREP_BATCH}: {ms:.3f} ms "
                  f"a batch, {ms / PREP_BATCH:.3f} ms a frame, peak "
                  f"{peak:.0f} MiB", flush=True)

    def segment():
        return segmentation.segment_with_tta(seg, crops[:PREP_BATCH])

    wall = cuda_ms(segment, 2)
    kinds, top = kernel_breakdown(segment)
    busy = None if kinds is None else sum(kinds.values())
    traced = "device busy not measured" if busy is None else \
        f"device busy {busy:.3f} ms, idle {1 - busy / wall:.3f}"
    print(f"preprocess segmentation batch of {PREP_BATCH} crops, 4 scales: "
          f"{wall:.3f} ms wall; {traced}", flush=True)
    if kinds is not None:
        print("  by kind (ms): " + ", ".join(f"{k} {v:.3f}"
                                             for k, v in kinds.items()),
              flush=True)
        for name, ms in top:
            print(f"  {ms:8.3f} ms  {name[:110]}", flush=True)
    del det, fan, seg
    torch.cuda.empty_cache()


def phase_preprocess(root, device):
    """Raw footage into the port on the card: seeded weights in the JAX
    layout, a raw tree of PREP frames, then ``cli.preprocess_dataset.main
    --do_crop --do_compute_segmentation`` (S³FD boxes, the latentpose crop,
    FAN landmarks, Graphonomy masks at four scales): the dataset's tree,
    each stage's frames/s and peak memory, one batch through
    ``voxceleb2_segmentation_nolandmarks``; the nets card vs CPU; their
    device times.  Returns {raw, bboxes, weights, data_root}."""
    t_phase = time.perf_counter()
    raw, bboxes = write_raw_tree(root)
    frames = np.stack([native_loader.decode(p) for p in
                       sorted((raw / "id00000" / "video0").glob("*.png"))])
    wdir = root / "weights"
    write_prep_weights(wdir, frames[0], device)
    n = PREP["identities"] * PREP["videos"] * PREP["frames"]

    record = {}
    t0 = time.perf_counter()
    with _stage_timers(record):
        prep_cli.main(["--data_root", str(root), "--do_crop",
                       "--do_compute_segmentation", "--weights_dir",
                       str(wdir), "--batch_size", str(PREP_BATCH),
                       "--device", str(device)])
    total = time.perf_counter() - t0
    for stage in ("detect", "crop", "landmarks", "segment"):
        sec, count, peak = record[stage]
        print(f"preprocess stage {stage}: {count} frames in {sec:.3f} s, "
              f"{count / sec:.1f} frames/s, peak {peak:.0f} MiB", flush=True)
    print(f"preprocess_dataset --do_crop --do_compute_segmentation: {n} "
          f"frames of {PREP_CANVAS[1]}x{PREP_CANVAS[0]} in {total:.2f} s, "
          f"{n / total:.1f} frames/s end to end", flush=True)

    for sub, suffix in (("images-cropped", ".png"),
                        ("keypoints-cropped", ".npy"),
                        ("segmentation-cropped", ".png")):
        files = sorted((root / sub).rglob(f"*{suffix}"))
        require(len(files) == n and {p.parent.parent.name for p in files}
                == {f"id{i:05d}" for i in range(PREP["identities"])},
                f"{sub}: {len(files)} files, expected {n}")
    crops = np.stack([native_loader.decode(p) for p in
                      sorted((root / "images-cropped").rglob("*.png"))])
    require(crops.shape == (n, 256, 256, 3), f"crops {crops.shape}")
    lms = np.stack([np.load(p) for p in
                    sorted((root / "keypoints-cropped").rglob("*.npy"))])
    require(lms.shape == (n, 68, 3) and np.isfinite(lms).all(),
            f"landmarks {lms.shape}")
    masks = np.stack([native_loader.decode(p) for p in sorted(
        (root / "segmentation-cropped").rglob("*.png"))])
    require(set(np.unique(masks)) <= {0, 255} and 0 < masks.mean() < 255,
            f"masks hold {np.unique(masks)[:5]}")
    cands = croppers.S3FDDetector(wdir / "s3fd.npz", device)
    cands(frames)
    print(f"preprocess: S3FD candidates before NMS {cands.candidates} over "
          f"{len(frames)} frames; mask foreground {masks.mean() / 255:.3f}",
          flush=True)
    del cands

    args = types.SimpleNamespace(
        data_root=str(root), img_dir="images-cropped",
        segm_dir="segmentation-cropped", bboxes_dir="/non/existent/file",
        train_split_path="/non/existent/train.csv", transfer_dtype="float32",
        finetune=False, checkpoint_path="",
        inference=False, n_frames_for_encoder=8, image_size=256,
        random_seed=0, batch_size=4, num_workers=1, prefetch_size=1)
    batches = iter(dataset_mod.Wrapper.get_dataloader(args, "train"))
    data, target = next(batches)
    batches.close()           # stops and joins the loader's producer
    require(data["enc_rgbs"].shape == (4, 8, 256, 256, 3)
            and target["real_segm"].shape == (4, 1, 256, 256, 1)
            and all(np.isfinite(v).all() for v in (*data.values(),
                                                   *target.values())),
            f"the preprocessed tree's batch: {data['enc_rgbs'].shape}")
    print(f"preprocess: one batch of the preprocessed tree through "
          f"voxceleb2_segmentation_nolandmarks: enc_rgbs "
          f"{data['enc_rgbs'].shape}, real_segm mean "
          f"{target['real_segm'].mean():.3f}", flush=True)

    phase_prep_card_vs_cpu(wdir, frames[0], crops[0], device)
    _prep_net_times(wdir, frames, crops, device)
    print(f"preprocess phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"raw": raw, "bboxes": bboxes, "weights": wdir, "data_root": root}


@contextlib.contextmanager
def _captured_drives(record):
    """drive_sequence's frames kept, and each driver source's load and
    drive seconds (the card synchronised)."""
    drive_seq = drive_lib.drive_sequence
    loaders = {"crop": cli.inline_crop_frames,
               "load": cli.load_driver_frames}

    def drive(fn, state, frames, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = drive_seq(fn, state, frames, **k)
        torch.cuda.synchronize()
        record.setdefault("frames", []).append(frames)
        record["drive"] = record.get("drive", 0.0) \
            + time.perf_counter() - t0
        return out

    def timed(name):
        def load(*a, **k):
            t0 = time.perf_counter()
            out = loaders[name](*a, **k)
            record["load"] = record.get("load", 0.0) \
                + time.perf_counter() - t0
            return out
        return load

    drive_lib.drive_sequence = drive
    cli.inline_crop_frames = timed("crop")
    cli.load_driver_frames = timed("load")
    try:
        yield
    finally:
        drive_lib.drive_sequence = drive_seq
        cli.inline_crop_frames = loaders["crop"]
        cli.load_driver_frames = loaders["load"]


def phase_drive_crop(ckpt, prep, workdir, device):
    """``cli.drive.main --crop`` on the fine-tuned checkpoint from raw
    frames (every video of the raw tree), once with ``--bboxes_dir`` and
    once with S³FD (the weights through $LATENTPOSE_WEIGHTS_DIR), and drive
    from the preprocessed (pre-cropped) directories: the frames given to
    the generator equal the C++ crop of the same boxes (the dict's, or the
    detector's run apart), 17 AdaIN launches a generator forward; each
    run's frames/s (load or crop, then drive), after an untimed warm-up.
    Returns the AdaIN launches of the three timed runs."""
    t_phase = time.perf_counter()
    raw, wdir = prep["raw"], prep["weights"]
    videos = sorted(str(p) for p in raw.glob("*/*"))
    bboxes = np.load(prep["bboxes"], allow_pickle=True).item()
    loader = native_loader.NativeBatchLoader()
    detector = croppers.S3FDDetector(wdir / "s3fd.npz", device)
    args = cli.resolve_args([str(ckpt), "--device", "cpu"])
    size = args.image_size
    per_frame = len(registry.load_wrapper("generators", args.generator)
                    .get_net(args).adain_features)          # 17 at 256²
    launches = 0
    runs = (("--crop, boxes from --bboxes_dir", videos,
             ["--crop", "--bboxes_dir", str(prep["bboxes"])]),
            ("--crop, boxes from S3FD", videos,
             ["--crop", "--bboxes_dir", "/non/existent/file"]),
            ("pre-cropped frames", sorted(
                str(p) for p in (prep["data_root"] / "images-cropped")
                .glob("*/*")), []))
    os.environ["LATENTPOSE_WEIGHTS_DIR"] = str(wdir)
    try:
        # a warm-up of the same drive (cuDNN's first calls), untimed
        cli.main([str(ckpt), "--images_paths", *runs[2][1], "--destination",
                  str(workdir / "warm-up"), "--device", str(device),
                  "--drive_batch_size", str(PREP_BATCH)])
        for label, paths, flags in runs:
            record = {}
            torch.cuda.synchronize()
            adain_op.adain.launches = 0
            with _captured_drives(record):
                cli.main([str(ckpt), "--images_paths", *paths,
                          "--destination", str(workdir / "crop"),
                          "--device", str(device),
                          "--drive_batch_size", str(PREP_BATCH), *flags])
            torch.cuda.synchronize()
            count = adain_op.adain.launches
            launches += count
            n = sum(len(f) for f in record["frames"])
            require(count == per_frame * sum(-(-len(f) // PREP_BATCH)
                                             for f in record["frames"]),
                    f"drive {label}: {count} AdaIN launches for {n} frames")
            for path, frames in zip(paths, record["frames"]):
                if not flags:
                    continue
                raw_frames = np.stack([native_loader.decode(p) for p in
                                       sorted(Path(path).glob("*.png"))])
                h = raw_frames.shape[1]
                if "S3FD" in label:
                    ltrb = [[v / s for v, s in zip(
                        croppers.choose_one_detection(f)[:4],
                        (raw_frames.shape[2], h) * 2)]
                        for f in detector(raw_frames)]
                else:
                    ident, video = Path(path).parts[-2:]
                    ltrb = [(bboxes[ident][video][i] / 256.0).tolist()
                            for i in range(len(raw_frames))]
                boxes = []
                for box in ltrb:
                    l, t, r, b = crop_lib.square_and_scale_bbox(*box)
                    boxes.append(crop_lib.bbox_to_integer_coords(
                        t, l, b, r, h, raw_frames.shape[2]))
                want = loader.crop_boxes(
                    raw_frames, boxes,
                    [size > b - t for t, _, b, _ in boxes], size)
                require(frames.dtype == np.uint8
                        and np.array_equal(frames, want),
                        f"drive {label}: the generator's frames are not the "
                        f"C++ crop of the same boxes ({path})")
            print(f"drive {label}: {n} frames, load/crop {record['load']:.3f}"
                  f" s + drive {record['drive']:.3f} s: "
                  f"{n / (record['load'] + record['drive']):.1f} frames/s "
                  f"({n / record['load']:.1f} frames/s loading), AdaIN "
                  f"launches {count}", flush=True)
    finally:
        del os.environ["LATENTPOSE_WEIGHTS_DIR"]
        loader.close()
    print(f"drive --crop phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# ---------------------------------------------------------------------- eval


# the blocked imports of this process, carried into the batched CLIs'
# children by a sitecustomize on their PYTHONPATH, which also imports the
# CLIs, loads both kernels and opens the card (the child's start-up) and
# reports each kernel's launches and the peak device memory at exit
def fsth_kernel_checks(device):
    """The AdaIN kernel against its plain version at every (H*W, C) of an
    FSTH generator forward, batch 8, f32 and bf16, each error relative to
    the plain output's max within TOL, and a planted fault (the weight
    FSTH_FAULT_SCALE x TOL off) above it; the 23 calls' f32 time beside
    the plain version's and the bound.  Returns (max relative error, ms,
    plain ms, bound ms, device ms) of the 23 f32 calls."""
    worst, ms, plain_ms, bound, busy = 0.0, 0.0, 0.0, 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for hw, c, count in FSTH_ADAIN_CALLS + FSTH_IN_CALLS:
            x, w, b = adain_inputs(FSTH_BATCH, hw, c, dtype, device,
                                   seed=3 * hw + c)
            want = adain_op.adain_reference(x, w, b).float()
            scale = want.abs().max().item()
            err = (adain_op.adain(x, w, b).float() - want).abs().max().item()
            faulty = adain_op.adain(x, w * (1 + FSTH_FAULT_SCALE * TOL[dtype]),
                                    b)
            fault = (faulty.float() - want).abs().max().item()
            plan, _ = adain_op.card_plan(hw, c, dtype)
            line = (f"fsth adain B={FSTH_BATCH} HW={hw} C={c} "
                    f"{str(dtype)[6:]}: err/max={err / scale:.3g} planted "
                    f"fault {fault / scale:.3g} (gate {TOL[dtype]}) "
                    f"cluster={plan.cluster} "
                    f"holds_sample={plan.holds_sample}")
            require(err <= TOL[dtype] * scale, f"FSTH AdaIN HW={hw} C={c} "
                    f"{dtype}: {err} > {TOL[dtype]} x {scale}")
            require(fault > TOL[dtype] * scale, f"the planted AdaIN fault "
                    f"passes the gate at HW={hw} C={c} {dtype}: {fault}")
            worst = max(worst, err / scale)
            if dtype == torch.float32:
                k = cuda_ms(lambda: adain_op.adain(x, w, b), 10)
                p = cuda_ms(lambda: adain_op.adain_reference(x, w, b), 10)
                dev, _ = device_busy_ms(lambda: adain_op.adain(x, w, b), 10)
                lo = adain_bound_ms(x)
                line += (f" kernel_ms={k:.4f} plain_ms={p:.4f} "
                         f"bound_ms={lo:.4f} (bytes) {_device(dev, lo)} "
                         f"(x{count} a forward)")
                ms += count * k
                plain_ms += count * p
                bound += count * lo
                busy = None if dev is None or busy is None else \
                    busy + count * dev
            print(line, flush=True)
            del x, w, b, want, faulty
    print(f"fsth adain: the {FSTH_PER_FORWARD} calls of one f32 FSTH "
          f"generator forward at batch {FSTH_BATCH}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms (bytes, 3.35 "
          f"TB/s), share {bound / ms:.3f}; {_device(busy, bound)}",
          flush=True)
    return worst, ms, plain_ms, bound, busy


def _fsth_tree(prep, workdir):
    """The preprocessed tree's videos (FAN keypoints) as a split of
    FSTH_BATCH samples (each video listed again to fill the batch)."""
    root = Path(prep["data_root"])
    videos = sorted(str(p.relative_to(root / "images-cropped"))
                    for p in (root / "images-cropped").glob("*/*")
                    if p.is_dir())
    rows = (videos * FSTH_BATCH)[:FSTH_BATCH]
    split = workdir / "fsth_split.csv"
    split.write_text("path\n" + "\n".join(rows) + "\n")
    return root, videos, split


def _stickman_ms(root):
    """Host ms a 256² stickman of FAN's keypoints (one core, median of 5
    rounds of 50)."""
    from latentpose_tpu_torch.data.common import voxceleb
    kp = np.load(sorted((root / "keypoints-cropped").rglob("*.npy"))[0])
    kp = kp[:, :2]
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(50):
            voxceleb.draw_stickman((256, 256), kp)
        rounds.append((time.perf_counter() - t0) / 50 * 1e3)
    return float(np.median(rounds))


def phase_fsth(prep, workdir, device):
    """The FSTH family on the card at the wrappers' full widths (256², 64
    to 512 channels, embedder 6 blocks, generator 4 down and 4 residual
    blocks, discriminator 7 blocks), batch 8, K=8, on the preprocessed
    tree's frames and FAN keypoints through ``--dataloader voxceleb2``:

    - the AdaIN kernel at each FSTH shape, f32 and bf16, with its planted
      fault (:func:`fsth_kernel_checks`);
    - ``cli.train.main`` meta-trains FSTH_META_STEPS steps from a seeded
      init in f32 and saves; fine-tunes FSTH_FT_STEPS steps from that
      checkpoint (``finetune_affine`` trained, the projector untouched);
      then the same in bf16 on the uint8 wire, each step launching
      FSTH_PER_FORWARD AdaIN kernels and no conv_bn; FSTH_plus (the
      keypoints' generator, 17 AdaINs a forward) 2 meta and 2 fine-tune
      steps (ê) in f32;
    - one FSTH meta step with the kernels against the same step under
      ``_plain_kernels()`` (batch 2, card, f32) under the step gate, and
      the step with the generator's frames FT_FAULT_SCALE off, which must
      read above it;
    - the step times (the median of the steps after the first, which
      builds the cuDNN plans), peak memory and the stickman's host ms.

    Returns the AdaIN launches of the CLI runs and the kernel numbers."""
    t_phase = time.perf_counter()
    workdir.mkdir(parents=True, exist_ok=True)
    kernel = fsth_kernel_checks(device)
    root, videos, split = _fsth_tree(prep, workdir)
    data = ["--dataloader", "voxceleb2", "--data_root", str(root),
            "--n_frames_for_encoder", "8", "--batch_size", str(FSTH_BATCH),
            "--device", str(device), "--allow_random_vgg",
            "--save_frequency", "0", "--experiments_dir", str(workdir)]
    launches, times = 0, {}
    ckpts = {}
    for label, modes, meta_steps, ft_steps in (
            ("f32", [], FSTH_META_STEPS, FSTH_FT_STEPS),
            ("bf16 + uint8", list(BF16_MODES), FSTH_META_STEPS,
             FSTH_FT_STEPS)):
        tag = "" if not modes else "_bf16"
        steps = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _counted_steps(steps):
            _, meta = train_cli.main([
                *FSTH_MODELS, *data, *modes, "--train_split_path",
                str(split), "--num_epochs", str(meta_steps),
                "--experiment_name", f"fsth_meta{tag}"])
        peak = torch.cuda.max_memory_allocated() / 2**20
        _require_steps(f"FSTH meta-train ({label})", steps,
                       {"bn_relu_conv1x1_stats": 0,
                        "adain_fused": FSTH_PER_FORWARD}, meta_steps)
        meta_ms = float(np.median([s["ms"] for s in steps[1:]]))
        launches += sum(s["launches"]["adain_fused"] for s in steps)
        ft_record = []
        torch.cuda.reset_peak_memory_stats()
        with _counted_steps(ft_record):
            _, ft_path = train_cli.main([
                "--finetune", "--checkpoint_path", str(meta), *data,
                "--train_split_path", videos[0], "--optimizer", "RAdam",
                "--lr_gen", "5e-4", "--lr_dis", "8e-4", "--num_epochs",
                str(ft_steps), "--experiment_name", f"fsth_ft{tag}"])
        ft_peak = torch.cuda.max_memory_allocated() / 2**20
        _require_steps(f"FSTH fine-tune ({label})", ft_record,
                       {"bn_relu_conv1x1_stats": 0,
                        "adain_fused": FSTH_PER_FORWARD}, ft_steps)
        launches += sum(s["launches"]["adain_fused"] for s in ft_record)
        with ckpt_lib.open_arrays(meta) as before, \
                ckpt_lib.open_arrays(ft_path) as after:
            require("params::finetune_affine" in after.files
                    and "params::finetune_embedding" not in after.files
                    and np.isfinite(after["params::finetune_affine"]).all(),
                    f"FSTH fine-tune ({label}): its checkpoint's leaves")
            for key in ("params::generator::project::kernel",
                        "spectral::generator::project::u"):
                require(np.array_equal(before[key], after[key]),
                        f"FSTH fine-tune ({label}) moved {key}")
            require(not np.array_equal(
                before["params::generator::head_conv::kernel"],
                after["params::generator::head_conv::kernel"]),
                f"FSTH fine-tune ({label}) left the generator as it was")
        ft_ms = float(np.median([s["ms"] for s in ft_record[1:]]))
        times[label] = (meta_ms, ft_ms)
        ckpts[label] = meta
        print(f"fsth {label}: meta-train {meta_steps} steps through "
              f"cli.train, batch {FSTH_BATCH} K=8 256², step_ms (median "
              f"after the first)="
              f"{meta_ms:.2f} (each "
              f"{', '.join(f'{s['ms']:.1f}' for s in steps)}) peak_mem_MiB="
              f"{peak:.0f}; losses {steps[-1]['losses']}; fine-tune "
              f"{ft_steps} steps (finetune_affine), step_ms (median after "
              f"the first)="
              f"{ft_ms:.2f} (each "
              f"{', '.join(f'{s['ms']:.1f}' for s in ft_record)}) "
              f"peak_mem_MiB={ft_peak:.0f}; AdaIN launches a step "
              f"{steps[0]['launches']['adain_fused']}", flush=True)

    # FSTH_plus: the flagship's decoder driven by the keypoints, 17 AdaINs
    # a forward; its fine-tune trains ê
    plus = [a if a != "FSTH" or FSTH_MODELS[i - 1] != "--generator"
            else "FSTH_plus" for i, a in enumerate(FSTH_MODELS)]
    plus_steps, plus_ft = [], []
    with _counted_steps(plus_steps):
        _, plus_meta = train_cli.main([
            *plus, *data, "--train_split_path", str(split), "--num_epochs",
            "2", "--experiment_name", "fsth_plus_meta"])
    with _counted_steps(plus_ft):
        _, plus_path = train_cli.main([
            "--finetune", "--checkpoint_path", str(plus_meta), *data,
            "--train_split_path", videos[0], "--optimizer", "RAdam",
            "--num_epochs", "2", "--experiment_name", "fsth_plus_ft"])
    for what, record in (("meta-train", plus_steps),
                         ("fine-tune", plus_ft)):
        _require_steps(f"FSTH_plus {what}", record,
                       {"bn_relu_conv1x1_stats": 0,
                        "adain_fused": ADAIN_PER_FORWARD}, 2)
        launches += sum(s["launches"]["adain_fused"] for s in record)
    with ckpt_lib.open_arrays(plus_path) as arrays:
        held = arrays.files
    require("params::finetune_embedding" in held
            and "params::finetune_affine" not in held,
            "FSTH_plus fine-tune: its checkpoint's leaves")
    print(f"fsth_plus f32: meta-train 2 steps (each "
          f"{', '.join(f'{s['ms']:.1f}' for s in plus_steps)} ms), "
          f"fine-tune 2 steps (ê; each "
          f"{', '.join(f'{s['ms']:.1f}' for s in plus_ft)} ms) through "
          f"cli.train; AdaIN launches a step "
          f"{plus_steps[0]['launches']['adain_fused']}", flush=True)

    # the step with the kernels against the plain versions, batch 2
    args = train_cli.resolve_args([
        "--checkpoint_path", str(ckpts["f32"]), *data, "--train_split_path",
        str(split)])
    state = train_cli.load_checkpoint(args, torch.device("cpu"))
    batches = iter(train_cli.build_dataloader(args, "train", "train"))
    data_dict, target = next(batches)
    batches.close()
    host = ({k: v[:2] for k, v in data_dict.items()},
            {k: v[:2] for k, v in target.items()})
    keys = holycow.META_STEP_KEYS
    generator = type(state.models["generator"])
    plain = _run_step(args, state, host, keys, device, _plain_kernels)
    runs = {"kernels": _run_step(args, state, host, keys, device),
            "planted fault": _run_step(
                args, state, host, keys, device,
                lambda: _planted_frame_fault(generator))}
    gaps = {way: _gaps(plain, run) for way, run in runs.items()}
    for way, gap in gaps.items():
        _print_gaps(f"fsth meta step {way} vs plain kernels, batch 2 256² "
                    f"f32 (TF32 off)", *gap)
    _require_step("FSTH meta step (kernels vs plain)", *gaps["kernels"],
                  GRAD_TOL)
    name, gap = _worst_loss(gaps["planted fault"][0])
    require(gap > STEP_TOL, f"the planted FSTH fault passes the step gate: "
            f"{name} {gap}")
    del state
    torch.cuda.empty_cache()
    stick_ms = _stickman_ms(root)
    print(f"fsth: stickman of 68 FAN keypoints at 256² on the host "
          f"(csrc/stickman.cpp through ctypes): {stick_ms:.3f} ms median",
          flush=True)
    print(f"fsth phase: {time.perf_counter() - t_phase:.1f} s; AdaIN "
          f"launches {launches} ({FSTH_PER_FORWARD} a forward)", flush=True)
    return launches, kernel, times, stick_ms


# the pretrained-pose families: (embedder, VoxCeleb1 crop, gan_type)
ABLATION_POSE = (("FAbNet_pretrained_embResNeXt", "fabnet", "ragan"),
                 ("X2Face_pretrained_embResNeXt", "x2face", "gan"))
ABLATION_NAMES = {"FAbNet_pretrained_embResNeXt": "FAbNet+",
                  "X2Face_pretrained_embResNeXt": "X2Face+"}
ABLATION_FROZEN = {"FAbNet_pretrained_embResNeXt": ("pose_encoder",),
                   "X2Face_pretrained_embResNeXt": ("pose_unet", "pose_proj")}
ABLATION_META_STEPS = 2     # epochs of one step: 8 samples of the split
ABLATION_FT_STEPS = 2       # epochs of one step: one video's 8 frames
X2FACE_TOL = 1e-4           # X2Face's forward, card vs CPU, of the max
X2FACE_FAULT_PX = 1.0       # the planted fault: the warp's grid 1 px off
FFHQ_LEVELS = 2             # FFHQ crops, card vs CPU: levels apart at most
FFHQ_EQUAL = 0.99           # ... and the share of values equal
FFHQ_LM_TOL = 1e-2          # ... and the landmarks, pixels
FFHQ_FAULT_PX = 0.5         # the planted fault: landmarks 0.5 px off


def _frozen_keys(keys, embedder):
    """The frozen pose encoder's keys (parameters and, FAb-Net's,
    BatchNorm statistics) among flat JAX-layout keys."""
    prefixes = tuple(f"{coll}::embedder::{name}::"
                     for coll in ("params", "batch_stats")
                     for name in ABLATION_FROZEN[embedder])
    return [k for k in keys if k.startswith(prefixes)]


def _written(video):
    """Whether drive wrote ``video``: the file, or without an encoder on
    the machine its ``.frames`` directory of PNGs."""
    return Path(video).exists() or Path(f"{video}.frames").is_dir()


def _counted(fn):
    """(fn(), the kernels' launches inside it)."""
    torch.cuda.synchronize()
    before = _launches()
    out = fn()
    torch.cuda.synchronize()
    after = _launches()
    return out, {k: after[k] - before[k] for k in after}


def _x2face_forward_gate(avatar, frames, device):
    """The X2Face generator of ``avatar`` on the card and on the CPU on the
    same batch (the stored identity images, 8 driver frames, f32, TF32
    off): the gap relative to the output's max, the planted fault's (the
    warp's grid moved X2FACE_FAULT_PX pixels right and down), and the
    card's frames/s at the drive's batch."""
    from latentpose_tpu_torch.models.generators import X2Face as x2g_mod
    args = cli.resolve_args([str(avatar), "--device", "cpu",
                             "--compute_dtype", "float32"])
    models, state = cli.load_finetuned(args, torch.device("cpu"))
    gen = models["generator"]
    images = state[convert.IDENTITY_IMAGES]
    driver = torch.from_numpy(frames[:8]).float() / 255.0
    enc = images.expand(len(driver), *images.shape[1:])
    with torch.no_grad():
        want, _ = gen(enc, driver[:, None])
        card = copy.deepcopy(gen).to(device)
        got, _ = card(enc.to(device), driver[:, None].to(device))
        warp = x2g_mod.grid_sample_bilinear
        shift = 2 * X2FACE_FAULT_PX / images.shape[-2]   # normalised
        x2g_mod.grid_sample_bilinear = lambda img, gx, gy: warp(
            img, gx + shift, gy + shift)
        try:
            faulty, _ = card(enc.to(device), driver[:, None].to(device))
        finally:
            x2g_mod.grid_sample_bilinear = warp
    scale = float(want.abs().max())
    gap = float((got.cpu() - want).abs().max()) / scale
    fault = float((faulty.cpu() - want).abs().max()) / scale
    step = drive_lib.make_drive_fn({"embedder": None, "generator": card},
                                   args)
    batch = torch.from_numpy(np.resize(frames, (DRIVE_BATCH,)
                                       + frames.shape[1:])).to(device)
    dstate = {convert.IDENTITY_IMAGES: images.to(device)}
    ms = cuda_ms(lambda: step(dstate, batch), 5)
    return gap, fault, DRIVE_BATCH / ms * 1e3


def _ffhq_gate(prep, workdir, device):
    """``cli.preprocess_dataset --do_crop_ffhq`` on the card over the raw
    tree (frames/s), then one video's FFHQ crops by the same cropper on
    the CPU (FAN there too): crops within FFHQ_LEVELS with FFHQ_EQUAL of
    the values equal, landmarks within FFHQ_LM_TOL px; the planted fault
    (the CPU's landmarks FFHQ_FAULT_PX off) must fail the crops' gate."""
    root, raw, wdir = Path(prep["data_root"]), Path(prep["raw"]), \
        prep["weights"]
    n = PREP["identities"] * PREP["videos"] * PREP["frames"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prep_cli.main(["--data_root", str(root), "--do_crop_ffhq",
                   "--weights_dir", str(wdir), "--batch_size",
                   str(PREP_BATCH), "--device", str(device)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    video = Path("id00000") / "video0"
    card = np.stack([native_loader.decode(p) for p in sorted(
        (root / "images-cropped-ffhq" / video).glob("*.png"))])
    card_lm = np.stack([np.load(p) for p in sorted(
        (root / "keypoints-cropped-ffhq" / video).glob("*.npy"))])
    files = sorted((root / "images-cropped-ffhq").rglob("*.png"))
    require(len(files) == n and card.shape == (PREP["frames"], 256, 256, 3),
            f"--do_crop_ffhq wrote {len(files)} crops, {card.shape}")
    frames = np.stack([native_loader.decode(p)
                       for p in sorted((raw / video).glob("*.png"))])
    # the CPU's crops: the CLI's cropper (FAN on the CPU) on the same frames
    cropper = croppers.make_cropper("ffhq", (256, 256), wdir, "cpu")
    landmarks = cropper.landmark_detector(frames)
    cpu, cpu_lm = croppers.FFHQFaceCropper(
        (256, 256), None, lambda imgs: landmarks, "cpu").crop_images(frames)
    faulty, _ = croppers.FFHQFaceCropper(
        (256, 256), None, lambda imgs: landmarks + np.float32(FFHQ_FAULT_PX),
        "cpu").crop_images(frames)

    def gaps(a, b):
        diff = np.abs(a.astype(int) - b.astype(int))
        return int(diff.max()), float((diff == 0).mean())

    levels, equal = gaps(card, cpu)
    f_levels, f_equal = gaps(faulty, cpu)
    lm_gap = float(np.abs(card_lm - cpu_lm).max())
    print(f"ablations ffhq: --do_crop_ffhq {n} frames of "
          f"{PREP_CANVAS[1]}x{PREP_CANVAS[0]} on the card in {seconds:.2f} s "
          f"({n / seconds:.1f} frames/s, FAN included); card vs CPU on "
          f"{len(cpu)} crops: {levels} levels at most, {equal:.4%} equal, "
          f"landmarks {lm_gap:.3g} px; planted fault ({FFHQ_FAULT_PX} px) "
          f"{f_levels} levels, {f_equal:.4%} equal", flush=True)
    require(levels <= FFHQ_LEVELS and equal >= FFHQ_EQUAL
            and lm_gap <= FFHQ_LM_TOL, "FFHQ crops: card and CPU differ")
    require(f_levels > FFHQ_LEVELS or f_equal < FFHQ_EQUAL,
            "the planted FFHQ fault passes the crops' gate")
    return n / seconds


def phase_ablations(prep, workdir, device):
    """The second half of the ablation families on the card, on the
    preprocessed tree (its bboxes dict, segmentations and raw frames), at
    the flagship's full widths, 256², batch 8, K=8, f32, through the
    entry points a user calls:

    - FAbNet+ (``--gan_type ragan``) and X2Face+ (``gan``): the flagship
      generator and discriminator, the six criteria, the mixed-crop
      dataloader; ``cli.train.main`` meta-trains ABLATION_META_STEPS steps
      from a seeded init (16 conv_bn and 17 AdaIN launches a step), then
      fine-tunes from that checkpoint (ê: 16 links a batch; then
      ABLATION_FT_STEPS steps of 17 AdaINs), then ``cli.drive.main``
      drives one video's PNG frames (17 AdaINs a batch); the frozen pose
      encoder's parameters (and FAb-Net's statistics) bit-equal to the
      seeded init in both checkpoints;
    - one FAbNet+ meta step at batch 2 with the kernels against the same
      step under ``_plain_kernels()`` under the step gate, and with the
      generator's frames FT_FAULT_SCALE off, which must read above it;
    - X2Face with ``voxceleb2_X2Face``, ``none`` and ``l1_rgb``: 2 meta
      steps, the identity-image "fine-tune", ``cli.drive.main`` (no
      kernel launches); its generator's forward card vs CPU within
      X2FACE_TOL with its planted fault, and frames/s at the drive's
      batch;
    - the FFHQ crop (:func:`_ffhq_gate`).

    Returns the kernels' launches and the numbers for the kernels line,
    with the three avatars (``avatars``) for :func:`phase_export`."""
    t_phase = time.perf_counter()
    workdir.mkdir(parents=True, exist_ok=True)
    root, videos, split = _fsth_tree(prep, workdir)
    data = ["--data_root", str(root), "--bboxes_dir", str(prep["bboxes"]),
            "--n_frames_for_encoder", "8", "--batch_size", "8",
            "--device", str(device), "--allow_random_vgg",
            "--save_frequency", "0", "--experiments_dir", str(workdir)]
    frames_dir = root / "images-cropped" / videos[0]
    total = {"bn_relu_conv1x1_stats": 0, "adain_fused": 0}
    per_meta = {"bn_relu_conv1x1_stats": 16, "adain_fused": ADAIN_PER_FORWARD}
    per_ft = {"bn_relu_conv1x1_stats": 0, "adain_fused": ADAIN_PER_FORWARD}
    times, metas, avatars = {}, {}, {}
    for embedder, crop, gan in ABLATION_POSE:
        meta_argv = ["--config_name", "default", "--embedder", embedder,
                     "--dataloader", "voxceleb2_segmentation_nolandmarks_"
                     "X2Face_FAbNet_crops", "--voxceleb1_crop_type", crop,
                     "--gan_type", gan, *data, "--train_split_path",
                     str(split), "--num_epochs", str(ABLATION_META_STEPS),
                     "--experiment_name", f"{embedder}_meta"]
        steps, ft_steps = [], []
        with _counted_steps(steps):
            (_, meta), used = _counted(lambda: train_cli.main(meta_argv))
        _require_steps(f"{embedder} meta-train", steps, per_meta,
                       ABLATION_META_STEPS)
        with _counted_steps(ft_steps):
            (_, ft_path), ft_used = _counted(lambda: train_cli.main([
                "--config_name", "finetuning-base", "--finetune",
                "--checkpoint_path", str(meta), *data, "--train_split_path",
                videos[0], "--num_epochs", str(ABLATION_FT_STEPS),
                "--experiment_name", f"{embedder}_ft"]))
        _require_steps(f"{embedder} fine-tune", ft_steps, per_ft,
                       ABLATION_FT_STEPS)
        require(ft_used["bn_relu_conv1x1_stats"] == 16,
                f"{embedder}: ê launched {ft_used} (16 links, one batch)")
        videos_out, drive_used = _counted(lambda: cli.main([
            str(ft_path), "--images_paths", str(frames_dir),
            "--destination", str(workdir / f"{embedder}_drive"),
            "--device", str(device)]))
        require(len(videos_out) == 1 and _written(videos_out[0])
                and drive_used == per_ft,
                f"{embedder} drive: {videos_out}, launched {drive_used}")
        for k in total:
            total[k] += used[k] + ft_used[k] + drive_used[k]
        init_args = train_cli.resolve_args(meta_argv[:-2] + [
            "--device", "cpu"])
        init = convert.export_train_state(train_cli.init_state(
            init_args, types.SimpleNamespace(num_labels=len(videos) * 2),
            torch.device("cpu")))
        want = {k: init[k] for k in _frozen_keys(init, embedder)}
        require(want, f"{embedder}: no frozen leaves")
        for path in (meta, ft_path):
            with ckpt_lib.open_arrays(path) as arrays:
                got = {k: arrays[k]
                       for k in _frozen_keys(arrays.files, embedder)}
            require(set(got) == set(want) and all(
                np.array_equal(got[k], want[k]) for k in want),
                f"{embedder}: the frozen pose encoder moved in {path}")
        meta_ms = float(np.median([s["ms"] for s in steps[1:]]))
        ft_ms = float(np.median([s["ms"] for s in ft_steps[1:]]))
        times[embedder] = (meta_ms, ft_ms)
        metas[embedder] = meta
        avatars[ABLATION_NAMES[embedder]] = ft_path
        print(f"ablations {embedder} ({gan}, {crop} crop): meta-train "
              f"{ABLATION_META_STEPS} steps through cli.train, batch 8 K=8 "
              f"256² f32, step_ms each "
              f"{', '.join(f'{s['ms']:.1f}' for s in steps)}; losses "
              f"{steps[-1]['losses']}; fine-tune (ê + "
              f"{ABLATION_FT_STEPS} steps) step_ms each "
              f"{', '.join(f'{s['ms']:.1f}' for s in ft_steps)}; drive "
              f"through cli.drive launched {drive_used}; the frozen "
              f"encoder's {len(want)} leaves bit-equal to the seeded init "
              f"after both", flush=True)

    # FAbNet+: the meta step with the kernels against the plain versions
    embedder = ABLATION_POSE[0][0]
    args = train_cli.resolve_args(["--checkpoint_path",
                                   str(metas[embedder]), *data,
                                   "--train_split_path", str(split)])
    state = train_cli.load_checkpoint(args, torch.device("cpu"))
    batches = iter(train_cli.build_dataloader(args, "train", "train"))
    data_dict, target = next(batches)
    batches.close()
    host = ({k: v[:2] for k, v in data_dict.items()},
            {k: v[:2] for k, v in target.items()})
    keys = holycow.META_STEP_KEYS
    generator = type(state.models["generator"])
    plain = _run_step(args, state, host, keys, device, _plain_kernels)
    runs = {"kernels": _run_step(args, state, host, keys, device),
            "planted fault": _run_step(
                args, state, host, keys, device,
                lambda: _planted_frame_fault(generator))}
    gaps = {way: _gaps(plain, run) for way, run in runs.items()}
    for way, gap in gaps.items():
        _print_gaps(f"ablations {embedder} meta step {way} vs plain "
                    f"kernels, batch 2 256² f32 (TF32 off)", *gap)
    _require_step(f"{embedder} meta step (kernels vs plain)",
                  *gaps["kernels"], GRAD_TOL)
    name, gap = _worst_loss(gaps["planted fault"][0])
    require(gap > STEP_TOL, f"the planted {embedder} fault passes the step "
            f"gate: {name} {gap}")
    del state, plain, runs
    torch.cuda.empty_cache()

    # X2Face: the none discriminator, l1_rgb, the identity images
    x2_steps = []
    with _counted_steps(x2_steps):
        _, x2_meta = train_cli.main([
            "--embedder", "X2Face", "--generator", "X2Face",
            "--discriminator", "none", "--criterions", "l1_rgb",
            "--dataloader", "voxceleb2_X2Face", "--optimizer", "Adam",
            *data, "--train_split_path", str(split), "--num_epochs", "2",
            "--experiment_name", "x2face_meta"])
    _require_steps("X2Face meta-train", x2_steps,
                   {"bn_relu_conv1x1_stats": 0, "adain_fused": 0}, 2)
    _, avatar = train_cli.main([
        "--finetune", "--checkpoint_path", str(x2_meta), *data,
        "--train_split_path", videos[0], "--X2Face_num_identity_images",
        "8", "--experiment_name", "x2face_avatar"])
    with ckpt_lib.open_arrays(avatar) as arrays:
        held, images = arrays.files, arrays[
            f"params::{convert.IDENTITY_IMAGES}"]
    require(images.shape == (1, 8, 256, 256, 3)
            and not train_cli.checkpoint_is_finetuned(avatar)
            and not any(k.startswith("opt_state_d") for k in held),
            f"X2Face avatar: identity images {images.shape}")
    x2_videos, x2_used = _counted(lambda: cli.main([
        str(avatar), "--images_paths", str(frames_dir), "--destination",
        str(workdir / "x2face_drive"), "--device", str(device)]))
    require(len(x2_videos) == 1 and _written(x2_videos[0])
            and not any(x2_used.values()),
            f"X2Face drive: {x2_videos}, launched {x2_used}")
    drive_frames = np.stack([native_loader.decode(p)
                             for p in sorted(frames_dir.glob("*.png"))])
    x2_gap, x2_fault, x2_fps = _x2face_forward_gate(avatar, drive_frames,
                                                    device)
    x2_ms = float(np.median([s["ms"] for s in x2_steps[1:]]))
    print(f"ablations X2Face: meta-train 2 steps (voxceleb2_X2Face, none, "
          f"l1_rgb) step_ms each {', '.join(f'{s['ms']:.1f}' for s in x2_steps)}"
          f"; losses {x2_steps[-1]['losses']}; identity images "
          f"{images.shape}; drive through cli.drive, no kernel; the "
          f"generator card vs CPU {x2_gap:.3g} of the max (gate "
          f"{X2FACE_TOL}), planted fault {x2_fault:.3g}; drive batch "
          f"{DRIVE_BATCH} f32 {x2_fps:.1f} frames/s", flush=True)
    require(x2_gap <= X2FACE_TOL, f"X2Face forward: card and CPU differ by "
            f"{x2_gap}")
    require(x2_fault > X2FACE_TOL, f"the planted X2Face fault passes: "
            f"{x2_fault}")
    ffhq_fps = _ffhq_gate(prep, workdir, device)
    seconds = time.perf_counter() - t_phase
    print(f"ablations phase: {seconds:.1f} s; launches {total}", flush=True)
    return total, {"meta_step_ms": {k: v[0] for k, v in times.items()},
                   "finetune_step_ms": {k: v[1] for k, v in times.items()},
                   "x2face_meta_step_ms": x2_ms,
                   "x2face_card_vs_cpu": x2_gap,
                   "x2face_drive_fps": x2_fps, "ffhq_fps": ffhq_fps,
                   "seconds": seconds, "avatars": {**avatars,
                                                   "X2Face": avatar}}


CHILD_SITE = '''
import atexit, sys, time
for _name in {blocked!r}:
    sys.modules[_name] = None
import torch
import latentpose_tpu_torch.cli.drive, latentpose_tpu_torch.cli.train
from latentpose_tpu_torch.ops import adain, conv_bn
if torch.cuda.is_available():
    adain.kernel_entry()
    conv_bn.kernel_entry()
    torch.cuda.init()
print("smoke child: started", file=sys.stderr, flush=True)


def _report():
    peak = torch.cuda.max_memory_allocated() / 2**20 \
        if torch.cuda.is_available() else 0.0
    print(f"smoke child: launches adain_fused {{adain.adain.launches}} "
          f"bn_relu_conv1x1_stats "
          f"{{conv_bn.bn_relu_conv1x1_stats.launches}} peak_mib {{peak:.0f}}",
          file=sys.stderr, flush=True)


atexit.register(_report)
'''


class _Children:
    """Stands in for ``subprocess`` in the batched CLIs: each child runs
    with ``env`` (the blocked imports), its output read line by line;
    records each child's wall time, its start-up (until the site's
    "started" line: interpreter, imports, the kernels' load, the card's
    context), its kernel launches and its peak device memory.  A child
    that fails fails the smoke."""

    def __init__(self, env):
        self.env = env
        self.runs = []

    def run(self, command, check=True):
        t0 = time.perf_counter()
        proc = subprocess.Popen(command, env=self.env, cwd=ROOT,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        startup, launches, lines = None, None, []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("smoke child: started"):
                startup = time.perf_counter() - t0
            elif line.startswith("smoke child: launches"):
                words = line.split()[3:]
                launches = {k: int(v) for k, v in zip(words[::2],
                                                      words[1::2])}
        rc = proc.wait()
        wall = time.perf_counter() - t0
        if rc or startup is None or launches is None:
            print("".join(lines[-40:]), flush=True)
        require(rc == 0, f"child {command[2]} exited with {rc}")
        require(startup is not None and launches is not None,
                f"child {command[2]} did not run with the smoke's site")
        cli_name = command[2].rsplit(".", 1)[1]
        name = (command[command.index("--experiment_name") + 1]
                if cli_name == "train"
                else Path(command[3]).parent.parent.name)
        self.runs.append({"cli": cli_name, "name": name, "wall": wall,
                          "startup": startup, "launches": launches})
        return subprocess.CompletedProcess(command, rc)


@contextlib.contextmanager
def _children_of(module, children):
    saved = module.subprocess
    module.subprocess = children
    try:
        yield
    finally:
        module.subprocess = saved


_CHILD_ENV = {}


def child_env(root):
    """The environment of the smoke's children: CHILD_SITE's directory and
    the repository on PYTHONPATH; the first call checks that a child cannot
    import cv2 there (the site is written once, under that call's
    ``root``, which stays for the run)."""
    if _CHILD_ENV:
        return dict(_CHILD_ENV)
    site = root / "child_site"
    site.mkdir(parents=True, exist_ok=True)
    (site / "sitecustomize.py").write_text(CHILD_SITE.format(
        blocked=BLOCKED))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(site), str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    probe = subprocess.run(
        [sys.executable, "-c", "import cv2"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    require(probe.returncode != 0 and "smoke child: started" in probe.stderr,
            f"a child imports cv2 or skips the site: {probe.stderr[-500:]}")
    _CHILD_ENV.update(env)
    return env


def write_eval_tree(root):
    """EVAL's identities, each ``id<i>/vid0/{identity,driver}`` with
    EVAL["frames"] rendered EVAL["size"]² PNG frames (driver frames later in
    the head's motion than the identity's) and their head masks under
    ``segmentation-cropped`` (grey PNGs), as the eval harness reads them."""
    size = EVAL["size"]
    identities = []
    for i in range(EVAL["identities"]):
        ident = f"id{i:05d}/vid0"
        for sub, offset in (("identity", 0), ("driver", 40)):
            img_dir = root / "images-cropped" / ident / sub
            segm_dir = root / "segmentation-cropped" / ident / sub
            img_dir.mkdir(parents=True)
            segm_dir.mkdir(parents=True)
            for f in range(EVAL["frames"]):
                img, segm = render_face(i, f + offset, size)
                write_png(img_dir / f"{f:05d}.png",
                          (img * 255 + 0.5).astype(np.uint8), level=1)
                write_png(segm_dir / f"{f:05d}.png",
                          (segm[..., 0] * 255 + 0.5).astype(np.uint8),
                          level=1)
        identities.append(ident)
    return identities


def write_eval_weights(wdir):
    """Seeded ArcFace-r100 (the published (3, 13, 30, 3) stages of 64..512
    features) and FAN (4 hourglasses) in the JAX package's flat-npz layout
    (``arcface_r100.npz``, ``fan_2d.npz``), read back bit-equal."""
    wdir.mkdir(parents=True, exist_ok=True)
    empty = weights.empty_module      # _seeded sets every drawn value
    for name, net in (("arcface_r100.npz",
                       _seeded(empty(arcface.ArcFaceR100), 21)),
                      ("fan_2d.npz", _seeded(empty(fan_mod.FAN), 22))):
        np.savez(wdir / name, **weights.flax_from_state_dict(net))
        back = weights.state_dict_from_flax(
            net, weights.load_flat_npz_variables(str(wdir / name)))
        own = net.state_dict()
        require(all(torch.equal(back[k], own[k]) for k in back)
                and len(back) == len([k for k in own
                                      if "num_batches" not in k]),
                f"{name} does not round-trip bit-equal")
        print(f"eval weights: {name} {len(back)} arrays, "
              f"{(wdir / name).stat().st_size / 2**20:.1f} MiB, round-trip "
              f"bit-equal", flush=True)
    return wdir


def _flops(net, x):
    """Multiply-adds x 2 of the convolutions and products of ``net(x)``."""
    total, hooks = [0], []

    def count(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            total[0] += out.numel() * mod.weight[0].numel()
        else:
            total[0] += out.numel() * mod.in_features
    for mod in net.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            hooks.append(mod.register_forward_hook(count))
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in hooks:
            h.remove()
    return 2.0 * total[0]


def _gate(what, runs, faulty, tol):
    print(f"eval card vs cpu, {what}: {runs:.3g}, planted fault "
          f"{faulty:.3g} (gate {tol})", flush=True)
    require(runs <= tol, f"card and CPU {what} differ: {runs}")
    require(faulty > tol, f"the planted fault passes the {what} gate: "
            f"{faulty}")


def phase_eval_nets(wdir, frames, device):
    """The eval harness's pieces on the card against the CPU: the crop
    resizes (INTER_CUBIC both forms, INTER_AREA at a non-integer and two
    integer factors) bit-equal, ArcFace-r100's embeddings of 8 crops within
    EVAL_NET_TOL of their max, LPIPS (the unarmed AlexNet tower, 4 pairs at
    256²) within EVAL_NET_TOL relative; each with a planted fault above its
    gate; ArcFace's ms per batch of 64 crops with the flip beside its FLOP
    bound, LPIPS's per batch."""
    cpu = torch.device("cpu")
    bbox = backends.get_default_bbox("latentpose")
    x = torch.from_numpy(frames)
    small = resize_linear(x, (64, 64))
    cases = [("cubic 256² frames' crops -> 112²", x, 112, resize_cubic),
             ("cubic 64² frames' crops -> 112² (up)", small, 112,
              resize_cubic),
             ("area 256² frames' crops -> 16²", x, 16, resize_area),
             ("area 64² -> 16² (integer x4)", small, 16, None),
             ("area 32² -> 16² (integer 2x2)", resize_linear(x, (32, 32)), 16,
              None)]
    for what, batch, side, resize in cases:
        if resize is None:      # the whole frame
            def fn(b, dev, side=side):
                return resize_area(b.to(dev), (side, side))
        else:
            def fn(b, dev, side=side, resize=resize):
                return backends.face_crops(list(b.numpy()), bbox,
                                           (side, side), resize, dev)
        want = fn(batch, cpu)
        differ = int((fn(batch, device).cpu() != want).sum())
        planted = batch.clone()
        planted[0, batch.shape[1] // 2, batch.shape[2] // 2] ^= 0x40
        fault = int((fn(planted, device).cpu() != want).sum())
        print(f"eval resize {what}, {len(batch)} frames: {differ} values "
              f"differ card vs cpu; planted one-pixel fault {fault}",
              flush=True)
        require(differ == 0 and fault > 0, f"resize {what}: {differ} "
                f"differ, the fault moved {fault}")

    crops = backends.face_crops(list(frames[:8]), bbox, (112, 112),
                                resize_cubic, cpu)
    net = weights.load_flax_weights(weights.empty_module(
        arcface.ArcFaceR100), str(wdir / "arcface_r100.npz")).eval()
    with torch.no_grad():
        want = net(crops)
        card = net.to(device)
        runs = _rel_gap(card(crops.to(device)), want)
        card.stage3_unit1.bn2.eps = 0.01
        faulty = _rel_gap(card(crops.to(device)), want)
    _gate("ArcFace-r100 embeddings of 8 crops, TF32 off, max_rel_diff "
          "(fault: stage 3 unit 1 bn2 eps 2e-5 -> 1e-2)", runs, faulty,
          EVAL_NET_TOL)
    backend = backends.ArcFaceBackend(wdir / "arcface_r100.npz",
                                      device=device)
    batch = backends.face_crops(list(np.concatenate(
        [frames] * -(-64 // len(frames)))[:64]),
                                bbox, (112, 112), resize_cubic,
                                device)
    emb = backend.embed(batch)
    require(torch.isfinite(emb).all() and float(
        (emb.norm(dim=-1) - 1).abs().max()) < 1e-5,
        "ArcFace descriptors are not finite unit vectors")
    ms = cuda_ms(lambda: backend.embed(batch), 3)
    flops = _flops(backend.model, torch.cat([batch, batch]))
    bounds = {k: flops / PEAK_FLOPS[k] * 1e3 for k in PEAK_FLOPS}
    print(f"eval ArcFace-r100, 64 crops at 112² with the flip (128 tower "
          f"forwards), f32, TF32 off: {ms:.3f} ms; {flops / 1e12:.3f} TFLOP: "
          f"bound {bounds[torch.float32]:.3f} ms at 495 TFLOP/s (TF32), "
          f"{bounds[torch.bfloat16]:.3f} ms at 989 TFLOP/s (bf16); "
          f"{ms / 64:.3f} ms a crop", flush=True)
    del net, card, backend
    torch.cuda.empty_cache()

    g = torch.Generator().manual_seed(23)
    a = torch.rand(4, 256, 256, 3, generator=g)
    b = (a + 0.1 * torch.randn(a.shape, generator=g)).clamp(0, 1)
    want = lpips.lpips_fn("", allow_random=True, device=cpu)[0](a, b)
    card_fn = lpips.lpips_fn("", allow_random=True, device=device)[0]
    runs = _rel_gap(card_fn(a, b), want)
    params, _ = lpips.load_lpips_params("", allow_random=True, device=device)
    for i in range(len(lpips.ALEX_CHANNELS)):
        params[f"lin{i}"] *= 1.01
    faulty = _rel_gap(lpips.lpips(params, a.to(device), b.to(device)), want)
    _gate("LPIPS (unarmed AlexNet tower) of 4 pairs at 256², TF32 off, "
          "max_rel_diff (fault: every lin head x1.01)", runs, faulty,
          EVAL_NET_TOL)
    a, b = a.to(device), b.to(device)
    ms = cuda_ms(lambda: card_fn(a, b), 5)
    print(f"eval LPIPS, 4 pairs at 256²: {ms:.3f} ms; distances "
          f"{[round(float(v), 4) for v in want]}", flush=True)


# Run with cv2 importable: each PNG frame of a tree written again as JPEG at
# quality 95 (as the reference's and the JAX package's crops are written), and
# cv2's decode of that JPEG written as a lossless PNG with the port's encoder.
JPEG_CHILD = '''
import sys
from pathlib import Path
import cv2
from latentpose_tpu_torch.utils.png import write_png
src, jpeg, png = (Path(p) for p in sys.argv[1:4])
count = 0
for f in sorted(src.rglob("*.png")):
    rel = f.relative_to(src)
    j, p = jpeg / rel.with_suffix(".jpg"), png / rel
    j.parent.mkdir(parents=True, exist_ok=True)
    p.parent.mkdir(parents=True, exist_ok=True)
    assert cv2.imwrite(str(j), cv2.imread(str(f)),
                       [cv2.IMWRITE_JPEG_QUALITY, 95])
    write_png(p, cv2.imread(str(j))[..., ::-1], level=1)
    count += 1
print("jpeg child: " + str(count) + " frames, cv2 " + cv2.__version__)
'''


def _cli_numbers(stdout):
    """The eval CLI's three printed numbers."""
    keys = {"Identity error: ": "identity_error",
            "Pose reconstruction error: ": "pose_reconstruction_error",
            "Pose reconstruction error (with optimal alignment): ":
            "pose_reconstruction_error_aligned"}
    out = {}
    for line in stdout.splitlines():
        for prefix, key in keys.items():
            if line.startswith(prefix):
                out[key] = float(line[len(prefix):])
    require(len(out) == 3, f"the eval CLI printed {out}")
    return out


def phase_eval_tf32(data_root, results, identities, wdir, frames, cpu,
                    device):
    """ROADMAP C.6 (the gate itself is :func:`phase_eval`'s card run, the
    CLI's ``main`` with its own defaults under torch's TF32 defaults).  In
    this process, on the
    tree's real rendered frames: how far cuDNN's TF32 moves ArcFace's
    embeddings and FAN's heatmaps from f32, as a share of each max, and
    each net's forward time both ways (CUDA events); and the CLI's
    ``main`` once with TF32 in the nets (``backends.full_f32`` made a
    no-op), its numbers against the CPU run's and its time, not gated."""
    bgr = np.ascontiguousarray(frames[..., ::-1])
    bbox = backends.get_default_bbox("latentpose")
    crops = backends.face_crops(list(bgr), bbox, (112, 112), resize_cubic,
                                device)
    crops = torch.cat([crops, torch.flip(crops, [2])])
    arc = backends.ArcFaceBackend(wdir / "arcface_r100.npz", device=device)
    fan = backends.FANBackend(wdir / "fan_2d.npz", device=device)
    x = resize_linear(torch.from_numpy(bgr).to(device), (256, 256))
    x = (x.float() / 255.0).permute(0, 3, 1, 2).contiguous()
    n = len(bgr)

    def embeddings():       # as ArcFaceBackend.embed, the nets' flags aside
        e = arc.model(crops)
        return arcface.normalize_embeddings(e[:n] + e[n:])

    nets = {"ArcFace embeddings": embeddings,
            "FAN heatmaps": lambda: fan.model(x)[-1]}
    shift, ms = {}, {}
    saved = torch.backends.cudnn.allow_tf32
    try:
        with torch.no_grad():
            for name, fn in nets.items():
                out = {}
                for on in (False, True):
                    torch.backends.cudnn.allow_tf32 = on
                    out[on] = fn()
                    ms[name, on] = cuda_ms(fn, 5)
                shift[name] = _rel_gap(out[True], out[False].cpu())
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    del arc, fan
    torch.cuda.empty_cache()
    full_f32 = backends.full_f32
    backends.full_f32 = contextlib.nullcontext
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32, tf32_wall, _, _ = _eval_run(
            data_root, results("c6_tf32"), identities, device,
            "--eval_weights_dir", str(wdir))
    finally:
        backends.full_f32 = full_f32
        torch.backends.cudnn.allow_tf32 = saved
    tf32_gaps = _eval_gaps(tf32, cpu)
    print(f"eval TF32 against f32 on the tree's {n} rendered identity "
          f"frames, max |diff| / max |f32|: " + ", ".join(
              f"{k} {v:.3g}" for k, v in shift.items())
          + " (ArcFace's card-vs-CPU gate: 1e-3 of its max); forward ms "
          f"f32 / TF32: " + ", ".join(
              f"{k.split()[0]} {ms[k, False]:.3f} / {ms[k, True]:.3f}"
              for k in nets), flush=True)
    print(f"eval C.6, the CLI's main in this process with cuDNN's TF32 in "
          f"the nets: {tf32}; {tf32_wall:.2f} s; against the CPU run: "
          f"identity error {tf32_gaps[0]:.3g} absolute, pose errors "
          f"{tf32_gaps[1]:.3g} relative (not gated)", flush=True)



def phase_eval_jpeg(root, data_root, results, identities, seeded, device):
    """ROADMAP C.7: the tree written as JPEG (quality 95, cv2, in a child
    that may import cv2) and cv2's decode of those JPEGs written as PNG; the
    port scores both on the card, the JPEG tree through nvJPEG, so the two
    runs differ only in the decoder.  A planted fault (avatar 0's
    reenactments swapped for identity 1's frames) on the JPEG tree against
    the cv2 run: the gap within JPEG_BOUND, the fault 3x above it."""
    trees = {"jpeg": root / "data_jpeg", "cv2": root / "data_cv2png"}
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    _, wall, proc = _run_child(
        [sys.executable, "-c", JPEG_CHILD,
         str(data_root / "images-cropped"),
         str(trees["jpeg"] / "images-cropped"),
         str(trees["cv2"] / "images-cropped")], env)
    print(f"eval C.7: {proc.stdout.strip()}; {wall:.1f} s", flush=True)
    for tree in trees.values():
        (tree / "segmentation-cropped").symlink_to(
            data_root / "segmentation-cropped")
    scores = {}
    for name, tree in trees.items():
        scores[name], wall, _, _ = _eval_run(
            tree, results(f"c7_{name}"), identities, device, *seeded)
        print(f"eval C.7, {name} tree on the card: {scores[name]}; "
              f"{wall:.2f} s", flush=True)
    fault, _, _, _ = _eval_run(
        trees["jpeg"], results("c7_fault", data_root / "images-cropped"),
        identities, device, *seeded)
    gap, faulty = _eval_gaps(scores["jpeg"], scores["cv2"]), \
        _eval_gaps(fault, scores["cv2"])
    print(f"eval C.7: nvJPEG against cv2's decode of the same JPEGs: "
          f"identity error {gap[0]:.3g} absolute, pose errors {gap[1]:.3g} "
          f"relative (bound {JPEG_BOUND}); the fault {faulty[0]:.3g} and "
          f"{faulty[1]:.3g} ({faulty[0] / JPEG_BOUND[0]:.3g}x and "
          f"{faulty[1] / JPEG_BOUND[1]:.3g}x the bound)", flush=True)
    require(all(g <= b for g, b in zip(gap, JPEG_BOUND)),
            f"the decoders' gap {gap} is above the protocol's bound on JPEG "
            f"trees {JPEG_BOUND}")
    require(all(f >= 3 * b for f, b in zip(faulty, JPEG_BOUND)),
            f"the planted fault {faulty} does not read 3x above the bound "
            f"{JPEG_BOUND}")


def _results_root(root, sweep, identities, swap_from=None):
    """A results root whose avatars' ``driving-results`` are the sweep's
    (links), so that each eval run writes its own caches.  ``swap_from``
    (the tree's ``images-cropped``): avatar 0's reenactment frames are
    identity 1's own driver frames instead (driver | frame PNGs, as drive
    writes them)."""
    def name(i):
        return identities[i].replace("/", "_")

    for i in range(len(identities)):
        avatar = root / (name(i) + "_identity") / "driving-results"
        avatar.parent.mkdir(parents=True)
        if swap_from is None or i != 0:
            avatar.symlink_to(sweep / (name(i) + "_identity")
                              / "driving-results")
            continue
        other = sorted((swap_from / identities[1] / "driver").glob("*.png"))
        for j in range(len(identities)):
            out = avatar / f"{name(j)}_driver.mp4.frames"
            out.mkdir(parents=True)
            drivers = sorted((swap_from / identities[j] / "driver")
                             .glob("*.png"))
            for k, (a, b) in enumerate(zip(drivers, other)):
                write_png(out / f"{k:06d}.png", np.concatenate(
                    [native_loader.decode(a), native_loader.decode(b)], 1),
                    level=1)
    return root


def _eval_run(data_root, results, identities, device, *flags):
    """``cli.compute_pose_identity_error.main`` once: (its dict, wall s,
    {stage: (s, calls)}, peak MiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = backends.StageTimer()
    t0 = time.perf_counter()
    out = eval_cli.main([
        "--results_root", str(results), "--data_root", str(data_root),
        "--identities", *identities, "--num_frames", str(EVAL["frames"]),
        "--image_size", str(EVAL["size"]), "--device", str(device), *flags],
        timer)
    wall = time.perf_counter() - t0
    stages = {k: (v, timer.calls[k]) for k, v in timer.seconds.items()}
    return out, wall, stages, torch.cuda.max_memory_allocated() / 2**20


def _eval_gaps(got, want):
    """(identity error's absolute gap, the pose errors' largest relative
    gap)."""
    pose = max(abs(got[k] - want[k]) / abs(want[k]) for k in
               ("pose_reconstruction_error",
                "pose_reconstruction_error_aligned"))
    return abs(got["identity_error"] - want["identity_error"]), pose


def phase_eval(meta_ckpt, root, device, child_device="cuda"):
    """The paper's protocol through the port's CLIs' ``main``: EVAL's
    identities written as the dataset lays them out; ``batched_finetune``
    from the meta checkpoint (EVAL_FT_ITERATIONS steps on each identity's
    frames) and ``batched_drive`` (every avatar with every identity's
    driver) as children with the smoke's imports blocked; then
    ``compute_pose_identity_error`` with the seeded ArcFace and FAN on the
    card (again, from its caches), on the CPU (the gate, and a run with one
    identity's reenactments swapped for another's that must read above it),
    and with the proxies.  Returns each kernel's launches in the
    children."""
    t_phase = time.perf_counter()
    data_root = root / "data"
    identities = write_eval_tree(data_root)
    wdir = write_eval_weights(root / "weights")
    frames = np.stack([native_loader.decode(p) for p in sorted(
        (data_root / "images-cropped" / identities[0] / "identity")
        .glob("*.png"))])
    phase_eval_nets(wdir, frames, device)
    print(f"eval tree, weights and nets: {time.perf_counter() - t_phase:.1f} "
          f"s", flush=True)

    children = _Children(child_env(root))
    torch.cuda.empty_cache()
    with _children_of(batched_finetune, children):
        batched_finetune.main([
            "--model", str(meta_ckpt), "--data_root", str(data_root),
            "--identities", *[f"{i}/identity" for i in identities],
            "--output_dir", str(root / "puppeteering"),
            "--target_iterations", str(EVAL_FT_ITERATIONS),
            "--extra_args", "--dataloader",
            "voxceleb2_segmentation_nolandmarks", "--allow_random_vgg",
            "--device", child_device])
    sweep = root / "puppeteering" / (
        meta_ckpt.parent.parent.name + "_" + meta_ckpt.name)
    with _children_of(batched_drive, children):
        batched_drive.main([
            "--puppeteering_dir", str(sweep), "--data_root", str(data_root),
            "--drivers", *[f"{i}/driver" for i in identities],
            "--extra_args", "--device", child_device])
    n, f = len(identities), EVAL["frames"]
    for ident in identities:
        out = sweep / (ident.replace("/", "_") + "_identity") \
            / "driving-results"
        written = sorted(out.iterdir())
        require([p.name for p in written] == [
            i.replace("/", "_") + "_driver.mp4.frames" for i in identities]
            and all(len(list(p.glob("*.png"))) == f for p in written),
            f"{out}: {[p.name for p in written]}")
    # from the code: ê is one ResNeXt-50 forward (16 links) a batch of
    # batched_finetune's batch (min(frames, 8)); a step one generator
    # forward (17 AdaINs), and the loop's two image probes at iteration 0
    # (the visuals and the fixed ids: finetuning-base logs them every
    # 9999999 and 15 steps) two more; drive one generator forward a batch
    # of DRIVE_BATCH frames
    ft_batch = min(f, 8)
    reckoned = {"train": {"bn_relu_conv1x1_stats": 16 * (f // ft_batch),
                          "adain_fused": 17 * (EVAL_FT_ITERATIONS + 2)},
                "drive": {"bn_relu_conv1x1_stats": 0,
                          "adain_fused": 17 * n * -(-f // DRIVE_BATCH)}}
    child_launches = {"bn_relu_conv1x1_stats": 0, "adain_fused": 0}
    for run in children.runs:
        want = reckoned[run["cli"]]
        print(f"eval child {run['cli']} {run['name']}: wall "
              f"{run['wall']:.1f} s = start-up {run['startup']:.1f} s "
              f"(interpreter, imports, kernels' load, the card's context) + "
              f"work {run['wall'] - run['startup']:.1f} s; peak "
              f"{run['launches'].pop('peak_mib')} MiB; launches "
              f"{run['launches']} (reckoned {want})", flush=True)
        for k in child_launches:
            child_launches[k] += run["launches"][k]
        require(child_device != "cuda" or run["launches"] == want,
                f"child {run['cli']} {run['name']} launched "
                f"{run['launches']}, reckoned {want}")
    print(f"eval batched_finetune + batched_drive: {len(children.runs)} "
          f"children, launches {child_launches}", flush=True)

    def results(name, swap_from=None):
        return _results_root(root / name, sweep, identities, swap_from)

    seeded = ["--eval_weights_dir", str(wdir)]
    # ROADMAP C.6: the CLI as a user's process runs it, under torch's own
    # backend defaults (cuDNN's TF32 on, matmul's off, no autotuning, no
    # deterministic algorithms): the backends' nets run in full f32
    # whatever the process sets, so it meets the CPU run's gate.  A fresh
    # process would add only a clean interpreter, CUDA context and cuDNN
    # handle.
    backend = torch.backends
    flags = (backend.cudnn.allow_tf32, backend.cuda.matmul.allow_tf32,
             backend.cudnn.benchmark, backend.cudnn.deterministic)
    (backend.cudnn.allow_tf32, backend.cuda.matmul.allow_tf32,
     backend.cudnn.benchmark, backend.cudnn.deterministic) = (
        True, False, False, False)
    try:
        card, wall, stages, peak = _eval_run(data_root, results("card"),
                                             identities, device, *seeded)
    finally:
        (backend.cudnn.allow_tf32, backend.cuda.matmul.allow_tf32,
         backend.cudnn.benchmark, backend.cudnn.deterministic) = flags
    scored = n * n * f
    print(f"eval compute_pose_identity_error, seeded ArcFace + FAN, card, "
          f"its own defaults under torch's TF32 defaults (C.6): "
          f"{card}; {wall:.2f} s end to end, {scored} reenactment frames "
          f"({scored / wall:.1f} frames/s); peak {peak:.0f} MiB", flush=True)
    per_call = {k: 1e3 * s / c for k, (s, c) in stages.items()}
    print("  stages: " + ", ".join(
        f"{k} {s:.3f} s ({c} calls)" for k, (s, c) in sorted(stages.items()))
        + f"; FAN {per_call['fan']:.2f} ms a batch of {f}; ArcFace "
        f"{per_call['arcface']:.2f} ms a batch of {f} with the flip",
        flush=True)
    again, wall2, stages2, _ = _eval_run(data_root, root / "card", identities,
                                         device, *seeded)
    require(again == card and set(stages2) == {"metrics"},
            f"the second run did not come from its caches: {stages2}")
    print(f"eval from the caches: the same numbers in {wall2:.2f} s",
          flush=True)
    for k, v in card.items():
        require(np.isfinite(v), f"{k} is {v}")
    for ident in identities:
        desc = np.load(root / "card" / (ident.replace("/", "_") + "_identity")
                       / "our_identity_descriptors"
                       / (ident.replace("/", "_") + ".npy"))
        require(desc.shape == (n, f, 512) and np.isfinite(desc).all()
                and np.abs(np.linalg.norm(desc, axis=-1) - 1).max() < 1e-5,
                f"{ident}'s descriptors are not finite unit vectors")

    t0 = time.perf_counter()
    cpu, _, _, _ = _eval_run(data_root, results("cpu"), identities,
                             torch.device("cpu"), *seeded)
    cpu_wall = time.perf_counter() - t0
    fault, _, _, _ = _eval_run(
        data_root, results("fault", data_root / "images-cropped"),
        identities, device, *seeded)
    runs, faulty = _eval_gaps(card, cpu), _eval_gaps(fault, cpu)
    print(f"eval compute_pose_identity_error card vs cpu ({cpu_wall:.1f} s "
          f"on the CPU, {f} frames): identity error {runs[0]:.3g} absolute "
          f"({runs[0] / EVAL_ID_TOL:.3g} of its gate), pose errors "
          f"{runs[1]:.3g} relative ({runs[1] / EVAL_POSE_TOL:.3g} of its "
          f"gate); the fault (avatar 0's reenactments swapped for identity "
          f"1's driver frames) {faulty[0]:.3g} and {faulty[1]:.3g} (gates "
          f"{EVAL_ID_TOL}, {EVAL_POSE_TOL})", flush=True)
    require(runs[0] <= EVAL_ID_TOL and runs[1] <= EVAL_POSE_TOL,
            f"card and CPU protocols differ: {runs}")
    require(faulty[0] > EVAL_ID_TOL and faulty[1] > EVAL_POSE_TOL,
            f"the swapped reenactments pass the gate: {faulty}")
    phase_eval_tf32(data_root, results, identities, wdir, frames, cpu,
                    device)
    phase_eval_jpeg(root, data_root, results, identities, seeded, device)

    proxy, wall, stages, _ = _eval_run(
        data_root, results("proxy"), identities, device,
        "--eval_weights_dir", str(root / "no_weights"), "--allow_proxy_eval")
    require(all(np.isfinite(v) for v in proxy.values()), f"proxy {proxy}")
    print(f"eval compute_pose_identity_error, proxies, card: {proxy}; "
          f"{wall:.2f} s", flush=True)
    print(f"eval phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return child_launches


@contextlib.contextmanager
def _rank_env(port, rank=0, world=1):
    """torchrun's environment for a rank of a local group, for the block."""
    values = {"RANK": str(rank), "LOCAL_RANK": str(rank),
              "WORLD_SIZE": str(world), "MASTER_ADDR": "localhost",
              "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def _dist_argv(meta_ckpt, workdir, device):
    return ["--checkpoint_path", str(meta_ckpt), "--dataloader", "synthetic",
            "--device", str(device), "--allow_random_vgg", "--batch_size",
            "8", "--num_epochs", str(DIST_EPOCHS), "--save_frequency", "0",
            "--log_frequency_images", "1000000000",
            "--log_frequency_fixed_images", "1000000000",
            "--experiments_dir", str(workdir)]


def _unreduced_backward(ctx, g_mean, g_var):
    """``parallel._GlobalMeanVar``'s backward without its all-reduce (part
    (ii)'s planted fault): each rank keeps only its own loss's gradient of
    the global statistics."""
    mean, var = ctx.saved_tensors
    g_var = torch.where(var > 0, g_var, torch.zeros_like(g_var))
    g_mean, g_var = g_mean / ctx.count, g_var / ctx.count
    return torch.stack([g_mean - 2.0 * mean * g_var, g_var]), None


@contextlib.contextmanager
def _unreduced_moment_gradients():
    saved = parallel._GlobalMeanVar.backward
    parallel._GlobalMeanVar.backward = staticmethod(_unreduced_backward)
    try:
        yield
    finally:
        parallel._GlobalMeanVar.backward = saved


def _own_slice(grads, dtype=None, on_wire=None):
    """``parallel.reduce_scatter_grads`` without its reduce-scatter (part
    (ii)'s FSDP fault): this rank's slice of its own gradients."""
    bucket = parallel.Bucket(grads)
    return [bucket.shard(bucket.flatten(grads))]


@contextlib.contextmanager
def _unreduced_shard_gradients():
    saved = parallel.reduce_scatter_grads
    parallel.reduce_scatter_grads = _own_slice
    try:
        yield
    finally:
        parallel.reduce_scatter_grads = saved


DIST_FAULTS = {"moments": _unreduced_moment_gradients,
               "shard": _unreduced_shard_gradients}
FSDP = ["--param_sharding", "fsdp"]
# part (ii)'s steps: (mode, flags, the planted fault); the default and
# FSDP ranks also save their state
DIST_MODES = (("default", [], None),
              ("explicit", ["--explicit_grad_reduce"], None),
              ("unreduced", [], "moments"),
              ("fsdp", FSDP, None),
              ("fsdp_unreduced", FSDP, "shard"))
DIST_SAVED = ("default", "fsdp")


def dist_child(meta_ckpt, out, rank, port, device="cuda:0"):
    """One of :func:`phase_distributed`'s two ranks in part (ii): a gloo
    group of two processes on the one card.  NCCL refuses two ranks on one
    device and the CLI refuses more ranks than cards; only this harness
    places two ranks on one card, through ``torch.distributed`` directly.
    From the seeded meta checkpoint, one step on the rank's 4 rows of the
    global batch 0 in each of DIST_MODES: the default regime, the explicit
    regime (``--explicit_grad_reduce``), the default regime with the
    global moments' backward left unreduced (a planted fault), FSDP
    (``--param_sharding fsdp``) and FSDP with each rank's slice updated
    from its own unreduced gradient (a planted fault), all under cuDNN's
    deterministic algorithms (ROADMAP C.8); rank 0 saves each state's
    groups (:func:`_leaves`, gathered whole on every rank) and the losses,
    the default and FSDP ranks their checkpoints, every rank its kernel
    launches, the bytes its state holds after the step and its peak
    memory.  ``device``: the card (``cpu`` only to rehearse the phase)."""
    out, rank, device = Path(out), int(rank), torch.device(device)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.set_device(device)
    launches, memory = {}, {}
    cuda = device.type == "cuda"
    with _rank_env(port, rank, 2):
        torch.distributed.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", world_size=2,
            rank=rank)
        try:
            # one loaded state (copied), batch and set of criteria serve
            # every mode
            args = train_cli.resolve_args(_dist_argv(meta_ckpt, out, device))
            loaded = train_cli.load_checkpoint(args, device)
            criteria = train_cli.build_criteria(args, device)
            batch = holycow.to_device(
                train_cli.build_dataloader(args).get_batch(0), device,
                holycow.META_STEP_KEYS)
            require(batch["label"].shape[0] == 4,
                    f"rank {rank} holds {batch['label'].shape[0]} rows")
            for mode, flags, fault in DIST_MODES:
                args = train_cli.resolve_args(
                    _dist_argv(meta_ckpt, out / mode, device) + flags)
                state = train_cli.place_state(args, copy.deepcopy(loaded))
                step_fn = train_cli.make_step(args, criteria)
                with parallel.gathered(state, whole=True):
                    before = _leaves(state, ("stats",))
                _zero_launches()
                if cuda:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with DIST_FAULTS.get(fault, contextlib.nullcontext)():
                    scalars = step_fn(state, batch)
                if cuda:
                    torch.cuda.synchronize()
                launches[mode] = _launches()
                memory[mode] = {
                    "step_ms": (time.perf_counter() - t0) * 1e3,
                    "resident": parallel.resident_bytes(state),
                    "allocated": torch.cuda.memory_allocated() if cuda
                    else None,
                    "peak": torch.cuda.max_memory_allocated() if cuda
                    else None}
                with parallel.gathered(state, whole=True):
                    after = _leaves(state)
                if rank == 0:
                    torch.save({"losses": {k: float(v)
                                           for k, v in scalars.items()},
                                "before": before, "after": after},
                               out / f"{mode}.pt")
                if mode in DIST_SAVED:
                    args.experiment_dir = str(out / mode)
                    train_cli.save(args, state)
                del state, step_fn, before, after
                if cuda:
                    torch.cuda.empty_cache()
        finally:
            torch.distributed.destroy_process_group()
    (out / f"launches{rank}.json").write_text(json.dumps(launches))
    (out / f"memory{rank}.json").write_text(json.dumps(memory))


def _reduce_ms(grads, dtype):
    """Mean ms of one :func:`parallel.reduce_grads` of ``grads`` with
    ``dtype`` on the wire (None: f32), by CUDA events."""
    return cuda_ms(lambda: parallel.reduce_grads(grads, dtype), 10)


def phase_distributed(meta_ckpt, workdir, device):
    """Data-parallel meta-training on the card (ROADMAP A.17.1).

    (i) ``cli.train.main`` as the one rank of a torchrun world of 1 (NCCL):
    DIST_EPOCHS epochs of 2 steps at batch 8, K=8, f32, 256², both kernels
    launched every step, one checkpoint; then, in this process, the staged
    step in that group (its gradient buckets all-reduced by NCCL) against
    the plain step (no group), in turns, and one step's gradient bytes with
    the reduce's ms in f32 and in bf16.  One card: no scaling is measured.

    (ii) two ranks over gloo on the card (:func:`dist_child`), each with 4
    rows of batch 0, against one process on the whole batch, all under
    cuDNN's deterministic algorithms, with the card-vs-CPU meta gate
    (:func:`_require_step`): the losses, the statistics' update and the
    generator's and discriminator's gradients within STEP_TOL, each
    tower's gradient within GRAD_TOL, of each group's L2 (:func:`_gaps`).
    Two witnesses: the explicit regime's identity-tower statistics read
    above STEP_TOL, and the default regime with its moments' gradient left
    unreduced (the planted fault) fails the gate on a tower's gradient.
    Returns (launches of (i)'s CLI run, the children's launches)."""
    t_phase = time.perf_counter()
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    argv = _dist_argv(meta_ckpt, workdir / "nccl", device)
    _zero_launches()
    t0 = time.perf_counter()
    with _rank_env(launch.free_port()):
        state, path = train_cli.main(argv)
    torch.cuda.synchronize()
    cli_launches = _launches()
    steps = 2 * DIST_EPOCHS
    require(state.step == steps and path is not None and path.exists(),
            f"world-1 run: step {state.step}, checkpoint {path}")
    per_step = {"bn_relu_conv1x1_stats": 16,
                "adain_fused": len(state.models["generator"].adain_features)}
    # each step's forward, and the visual grid's at step 0
    require(cli_launches == {k: v * (steps + 1) for k, v in per_step.items()},
            f"world-1 run launched {cli_launches}, {per_step} a forward")
    require(not parallel.initialized(), "the CLI left its group up")
    batch_ms = [1e3 * v for v in _scalars(path.parent.parent)[
        "Metrics/train/Batch_time"]]
    print(f"distributed (i): cli.train.main, NCCL world 1, {steps} steps in "
          f"{time.perf_counter() - t0:.1f} s; Batch_time_ms "
          f"{', '.join(f'{t:.1f}' for t in batch_ms)}; launches "
          f"{cli_launches}; saved {path.name}", flush=True)
    del state
    torch.cuda.empty_cache()

    args = train_cli.resolve_args(argv)
    loader = train_cli.build_dataloader(args)
    state = train_cli.load_checkpoint(args, device)
    criteria = train_cli.build_criteria(args, device)
    plain = train_cli.make_step(args, criteria)
    batches = [holycow.to_device(loader.get_batch(i), device,
                                 holycow.META_STEP_KEYS) for i in range(2)]
    with _rank_env(launch.free_port()):
        parallel.init_process_group(device)
        try:
            grouped = train_cli.make_step(args, criteria)
            times = {"plain": [], "group": []}
            for turn in ("plain", "group", "group", "plain") * (
                    DIST_TIMED // 2):
                fn = plain if turn == "plain" else grouped
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(state, batches[len(times[turn]) % 2])
                torch.cuda.synchronize()
                times[turn].append((time.perf_counter() - t0) * 1e3)
            grads_g, grads_d = list(state.opt_g.mu), list(state.opt_d.mu)
            nbytes = 4 * sum(g.numel() for g in grads_g + grads_d)
            reduce = {name: sum(_reduce_ms(g, dtype)
                                for g in (grads_g, grads_d))
                      for name, dtype in (("f32", None),
                                          ("bf16", torch.bfloat16))}
            # FSDP's collectives (world 1: each slice is its whole bucket):
            # a step's gathers of the parameters and reduce-scatters of the
            # gradients
            buckets = [parallel.Bucket(list(t)) for t in
                       train_cli.shard_groups(state).values()]
            slices = [b.flatten([p.detach() for p in t]) for b, t in zip(
                buckets, train_cli.shard_groups(state).values())]
            gather_ms = sum(cuda_ms(lambda b=b, s=s: b.gather(s), 10)
                            for b, s in zip(buckets, slices))
            scatter = {name: sum(cuda_ms(
                lambda g=g, d=dtype: parallel.reduce_scatter_grads(g, d), 10)
                for g in (grads_g, grads_d))
                for name, dtype in (("f32", None), ("bf16", torch.bfloat16))}
            del slices
        finally:
            parallel.destroy_process_group()
    plain_ms, group_ms = (float(np.median(times[k][1:]))
                          for k in ("plain", "group"))
    print(f"distributed (i): staged meta step, batch 8 K=8 f32, median of "
          f"{DIST_TIMED - 1} after one: plain {plain_ms:.2f} ms, in the NCCL "
          f"world-1 group {group_ms:.2f} ms ({group_ms / plain_ms:.3f}x); "
          f"each {times}", flush=True)
    print(f"distributed (i): gradient bytes a step f32 {nbytes} (bf16 "
          f"{nbytes // 2}), 2 buckets; reduce_ms f32 {reduce['f32']:.3f} "
          f"bf16 {reduce['bf16']:.3f} (NCCL, world 1: the cast and the "
          f"launch, no wire)", flush=True)
    print(f"distributed (i): FSDP's collectives a step (NCCL, world 1: the "
          f"buckets' copies and the launches, no wire): gather_ms "
          f"{gather_ms:.3f} ({len(buckets)} buckets, "
          f"{sum(4 * b.numel for b in buckets)} bytes), reduce_scatter_ms "
          f"f32 {scatter['f32']:.3f} bf16 {scatter['bf16']:.3f}", flush=True)
    del state, plain, grouped, criteria, batches
    torch.cuda.empty_cache()
    children = _distributed_gloo(meta_ckpt, workdir, device, per_step)
    print(f"distributed phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return cli_launches, children


def _distributed_gloo(meta_ckpt, workdir, device, per_step):
    """:func:`phase_distributed`'s part (ii): the two gloo ranks
    (:func:`dist_child`) against one process and against each other, their
    memory and their checkpoints; returns the children's launches.
    ``per_step``: each kernel's launches a step."""
    t0 = time.perf_counter()
    port = launch.free_port()
    out = workdir / "gloo"
    out.mkdir()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-child",
         str(meta_ckpt), str(out), str(rank), str(port), str(device)],
        cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        if proc.returncode:
            print(f"rank {rank}:\n{log[-3000:]}", flush=True)
        require(proc.returncode == 0, f"gloo rank {rank} exited "
                f"{proc.returncode}")
    children = {"bn_relu_conv1x1_stats": 0, "adain_fused": 0}
    for rank in range(2):
        for mode, count in json.loads(
                (out / f"launches{rank}.json").read_text()).items():
            require(count == per_step,
                    f"gloo rank {rank} {mode} step launched {count}")
            children = {k: children[k] + count[k] for k in children}
    print(f"distributed (ii): two gloo ranks, a default, an explicit, an "
          f"FSDP and two faulted steps each, {time.perf_counter() - t0:.1f} "
          f"s; launches {children}", flush=True)
    memory = [json.loads((out / f"memory{rank}.json").read_text())
              for rank in range(2)]
    for rank, mem in enumerate(memory):
        print(f"distributed (ii) rank {rank} after its step: resident state "
              f"bytes " + ", ".join(f"{m} {mem[m]['resident']}"
                                    for m in ("default", "fsdp"))
              + "; allocated " + ", ".join(f"{m} {mem[m]['allocated']}"
                                           for m in ("default", "fsdp"))
              + "; peak " + ", ".join(f"{m} {mem[m]['peak']}"
                                      for m in ("default", "fsdp"))
              + "; step_ms (gloo through the host) " + ", ".join(
                  f"{m} {mem[m]['step_ms']:.1f}" for m in ("default", "fsdp")),
              flush=True)
        require(mem["fsdp"]["resident"] <= FSDP_RESIDENT
                * mem["default"]["resident"],
                f"rank {rank}'s FSDP state holds {mem['fsdp']['resident']} "
                f"bytes, the replicated {mem['default']['resident']}")

    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        args = train_cli.resolve_args(_dist_argv(meta_ckpt, out / "one",
                                                 device))
        host = train_cli.build_dataloader(args).get_batch(0)
        state = train_cli.load_checkpoint(args, device)
        ref = _run_step(args, state, host, holycow.META_STEP_KEYS, device)
    finally:
        torch.backends.cudnn.deterministic = cudnn
    del state
    torch.cuda.empty_cache()
    identity, limits, runs = {}, {"generator.gradient": STEP_TOL}, {}
    for mode, _, _ in DIST_MODES:
        saved = torch.load(out / f"{mode}.pt")
        runs[mode] = run = (saved["losses"], saved["before"],
                            saved["after"], 0.0)
        loss, rel = _gaps(ref, run)
        _print_gaps(f"distributed (ii) {mode} step, two gloo ranks vs one "
                    f"process", loss, rel)
        identity[mode] = _identity_stats_gap(ref, run)
        if mode in ("default", "fsdp"):
            _require_step(f"two-rank ({mode}) and one-process meta step",
                          loss, rel, GRAD_TOL, limits)
        elif mode == "unreduced":
            caught = [k for k, limit in _step_limits(rel, GRAD_TOL,
                                                     limits).items()
                      if k.startswith("embedder.") and k.endswith("gradient")
                      and rel[k] > limit]
            print(f"distributed (ii): the planted fault (the moments' "
                  f"gradient unreduced) above the gate on {caught}",
                  flush=True)
            require(caught, f"the unreduced moments' gradient passes the "
                    f"two-rank gate: {rel}")
    # FSDP against the replicated two ranks: the gate above, each group
    # read; the slice updated from its own gradient must fail it
    for mode in ("fsdp", "fsdp_unreduced"):
        loss, rel = _gaps(runs["default"], runs[mode])
        _print_gaps(f"distributed (ii) {mode} step vs the default regime's "
                    f"two ranks", loss, rel)
        if mode == "fsdp":
            _require_step("FSDP and replicated two-rank meta step", loss,
                          rel, GRAD_TOL, limits)
        else:
            caught = [k for k, limit in _step_limits(rel, GRAD_TOL,
                                                     limits).items()
                      if rel[k] > limit]
            print(f"distributed (ii): the planted fault (each slice from its "
                  f"own gradient) above the gate on {caught}", flush=True)
            require(caught, f"FSDP's unreduced slices pass the gate: {rel}")
    _require_same_checkpoints(*(next((out / m).glob("*/*.ckpt"))
                                for m in DIST_SAVED))
    print(f"distributed (ii): the identity tower's statistics' update, L2 "
          f"relative to one process's: default {identity['default']:.3g}, "
          f"explicit {identity['explicit']:.3g} (the witness, above "
          f"{STEP_TOL})", flush=True)
    require(identity["default"] <= STEP_TOL < identity["explicit"],
            f"the identity tower's statistics read {identity}: the default "
            f"regime's must lie within {STEP_TOL}, the explicit one's above")
    return children


def _require_same_checkpoints(want, got):
    """The FSDP ranks' checkpoint against the replicated ranks': the same
    keys, shapes and dtypes; each group (a collection's module, an
    optimizer moment's module) within part (ii)'s gate of its L2: the
    parameters, EMA and statistics STEP_TOL, the moments GRAD_TOL; how
    many arrays are bit-equal."""
    want, got = (ckpt_lib.load_arrays(p) for p in (want, got))
    require(set(want) == set(got), "the FSDP checkpoint's keys differ: "
            f"{sorted(set(want) ^ set(got))[:6]}")
    def group(key):
        return "::".join(key.split("::")[:4 if key.startswith("opt_state")
                                        else 2])

    same = {}
    for key, value in want.items():
        require(got[key].shape == value.shape
                and got[key].dtype == value.dtype, f"{key} differs in kind")
        same[key] = np.array_equal(got[key], value)
    equal = sum(same.values())
    differ = {group(k) for k, v in same.items() if not v}
    sums = {}
    for key, value in want.items():     # only the groups that differ
        if group(key) in differ:
            num, den = sums.get(group(key), (0.0, 0.0))
            value = value.astype(np.float64)
            sums[group(key)] = (num + float(np.square(got[key] - value).sum()),
                                den + float(np.square(value).sum()))
    gaps = {g: (n / d) ** 0.5 for g, (n, d) in sums.items() if d}
    print(f"distributed (ii): the FSDP ranks' checkpoint against the "
          f"replicated ranks': {equal} of {len(want)} arrays bit-equal; "
          f"the groups that differ, L2 relative: " + (", ".join(
              f"{g} {v:.3g}" for g, v in sorted(gaps.items())) or "none"),
          flush=True)
    for group, gap in gaps.items():
        tol = GRAD_TOL if group.startswith("opt_state") else STEP_TOL
        require(gap <= tol, f"FSDP checkpoint {group} {gap} > {tol}")


def _identity_stats_gap(ref, other):
    """L2 of the identity tower's running statistics' update in ``other``
    less ``ref``'s, relative to ``ref``'s update (runs of
    :func:`_run_step`)."""
    (_, before, after, _), (_, _, o_after, _) = ref, other
    group = ("embedder", "stats")
    keys = [k for k in after[group] if k.startswith("identity_encoder.")]
    num = sum(float((o_after[group][k] - after[group][k]).square().sum())
              for k in keys)
    den = sum(float((after[group][k] - before[group][k]).square().sum())
              for k in keys)
    return (num / den) ** 0.5


def _named_leaves(state):
    """{name: CPU copy} of a meta-train state: every parameter, BatchNorm
    statistic and gradient (Adam's first moment, beta1 = 0), gradients
    named by their parameter."""
    models = state.models
    g_names = [f"{part}.{n}" for part in ("generator", "embedder")
               for n, _ in models[part].named_parameters()]
    d_names = [f"discriminator.{n}"
               for n, _ in models["discriminator"].named_parameters()]
    out = {}
    for part, m in models.items():
        out.update({f"param {part}.{k}": v for k, v in m.named_parameters()})
        out.update({f"stat {part}.{k}": v for k, v in m.named_buffers()
                    if "running" in k})
    for names, opt in ((g_names, state.opt_g), (d_names, state.opt_d)):
        require(len(names) == len(opt.mu), "gradients and names differ")
        out.update({f"grad {n}": mu for n, mu in zip(names, opt.mu)})
    return {k: v.detach().cpu().clone() for k, v in out.items()}


def _digests(leaves):
    return {k: hashlib.sha1(v.numpy().tobytes()).hexdigest()
            for k, v in leaves.items()}


def meta_repro_child(meta_ckpt, workdir, mode):
    """One process of :func:`meta_repro`: from the seeded meta checkpoint,
    META_STEPS meta steps on phase_meta_train's staged batches, each
    step's leaves digested (the first step's kept whole), then
    :func:`phase_meta_train` itself (its final state digested); in mode
    ``deterministic``, PyTorch's deterministic algorithms (cuDNN's and
    cuBLAS's included) with a warning for each op that has none; in mode
    ``cudnn``, cuDNN's deterministic algorithms alone; in mode ``default``,
    then :func:`phase_meta_step_card_vs_cpu` (C.3's gates)."""
    workdir = Path(workdir)
    if mode == "deterministic":
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = mode == "cudnn"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    argv = ["--dataloader", "synthetic", "--device", str(device),
            "--allow_random_vgg", "--batch_size", "8", "--num_epochs", "1",
            "--experiments_dir", str(workdir / "train"),
            "--checkpoint_path", str(meta_ckpt)]
    args = train_cli.resolve_args(argv)
    args.experiment_dir = str(workdir / "train")
    loader = train_cli.build_dataloader(args)
    state = train_cli.load_checkpoint(args, device)
    step_fn = train_cli.make_step(args, train_cli.build_criteria(args,
                                                                 device))
    steps = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(META_STEPS):
            batch = holycow.to_device(loader.get_batch(i), device,
                                      holycow.META_STEP_KEYS)
            step_fn(state, batch)
            torch.cuda.synchronize()
            leaves = _named_leaves(state)
            steps.append(_digests(leaves))
            if i == 0:
                torch.save({k: v for k, v in leaves.items()
                            if not k.startswith("param")},
                           workdir / "step1.pt")
        warned = sorted({str(w.message).split(" does not have a "
                                              "deterministic")[0]
                         for w in caught if "does not have a deterministic"
                         in str(w.message)})
        (workdir / "digests.json").write_text(json.dumps(
            {"steps": steps, "warned": warned}))
        del state, step_fn
        torch.cuda.empty_cache()
        _, trained, *_ = phase_meta_train(meta_ckpt, workdir / "smoke",
                                          device)
        (workdir / "final.json").write_text(json.dumps(
            _digests(_named_leaves(trained))))
        del trained
    if mode == "default":
        phase_meta_step_card_vs_cpu(args, meta_ckpt, loader, device)


def meta_repro(modes=("default", "deterministic")):
    """``python3 chip_smoke.py --meta-repro [MODE ...]`` (ROADMAP C.8): is
    the card's meta-training the same in two processes?  Writes the seeded
    meta checkpoint, then runs :func:`meta_repro_child` in two processes
    for each mode (``default``: PyTorch's defaults; ``deterministic``: its
    deterministic algorithms; ``cudnn``: cuDNN's alone), and compares each
    pair leaf by leaf: how many leaves differ after each step, the first
    step's gradients and statistics that differ (relative L2 of each, in
    the order of the state), the final states of :func:`phase_meta_train`,
    and the ops that have no deterministic implementation."""
    require(torch.cuda.is_available(), "--meta-repro needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    for mod in (adain_op, conv_bn):
        mod.kernel_entry()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as workdir:
        workdir = Path(workdir)
        meta_ckpt = phase_meta_checkpoint(workdir / "meta")
        runs = {}
        for mode in modes:
            for rep in range(2):
                out = workdir / f"{mode}{rep}"
                out.mkdir()
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--meta-repro-child", str(meta_ckpt), str(out), mode],
                    cwd=ROOT, capture_output=True, text=True, timeout=900)
                lines = [line for line in proc.stdout.splitlines()
                         if line.startswith(("meta step", "meta-train ("))]
                print(f"{mode} process {rep}: exit {proc.returncode}, "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
                print("\n".join(lines), flush=True)
                if proc.returncode:
                    print(proc.stderr[-3000:], flush=True)
                require((out / "digests.json").exists(),
                        f"{mode} process {rep} took no step")
                runs[mode, rep] = out
            a, b = (json.loads((runs[mode, r] / "digests.json").read_text())
                    for r in range(2))
            print(f"{mode}: ops with no deterministic implementation: "
                  f"{a['warned'] or 'none'}", flush=True)
            for i, (da, db) in enumerate(zip(a["steps"], b["steps"])):
                differ = [k for k in da if da[k] != db[k]]
                kinds = {kind: sum(k.startswith(kind) for k in differ)
                         for kind in ("param", "stat", "grad")}
                print(f"{mode}: after step {i + 1}, {len(differ)} of "
                      f"{len(da)} leaves differ between the processes "
                      f"{kinds}", flush=True)
            finals = [runs[mode, r] / "final.json" for r in range(2)]
            if all(f.exists() for f in finals):
                fa, fb = (json.loads(f.read_text()) for f in finals)
                differ = [k for k in fa if fa[k] != fb[k]]
                print(f"{mode}: phase_meta_train's final states: "
                      f"{len(differ)} of {len(fa)} leaves differ", flush=True)
            la, lb = (torch.load(runs[mode, r] / "step1.pt")
                      for r in range(2))
            gaps = {k: float((la[k].double() - lb[k].double()).norm()
                             / la[k].double().norm().clamp_min(1e-300))
                    for k in la if not torch.equal(la[k], lb[k])}
            print(f"{mode}: step 1, {len(gaps)} of {len(la)} gradients and "
                  f"statistics differ; in the order of the state: "
                  + "; ".join(f"{k} {v:.3g}" for k, v in gaps.items()),
                  flush=True)


BLOCK_VARIANTS = (("ResBlockShuffle", dict(upsample=True), 2),
                  ("ResBlockV2", dict(resize_layer="nearest"), 2),
                  ("ResBlockV2Shuffle", dict(resize_layer="nearest"), 2),
                  ("ResBlockNoSpectralNorm", dict(upsample=True), 2),
                  ("GatedResBlock", dict(upsample=True), 2),
                  ("MobileNetBlock", dict(upsample=True), 3))
BLOCK_SHAPE = (8, 128, 64, 32)      # batch, in and out channels, side


def phase_blocks(device):
    """The ``nn/blocks.py`` variants with ``norm_layer='adain'`` on the
    card, each once at (batch, channels in, out, side) BLOCK_SHAPE from a
    seeded init with seeded per-sample affines: the forward through the
    AdaIN kernel (its launches counted: 2 a residual variant, 3 a
    MobileNetBlock, whose first two norms are instance norms with shared
    affines through the same kernel) against the same forward with the
    plain version, within TOL of the output's max.  Returns {variant:
    (launches, max_rel_err)}."""
    b, cin, cout, side = BLOCK_SHAPE
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(b, cin, side, side, generator=gen).to(device)
    ada = [tuple(torch.randn(b, c, generator=gen).to(device)
                 for _ in range(2)) for c in (cin, cout)]
    out = {}
    for name, kw, per_forward in BLOCK_VARIANTS:
        cls = getattr(blocks, name)
        if name == "MobileNetBlock":
            block, args = cls(cin, cout, "adain", **kw), (ada[1],)
        else:
            extra = {} if name == "ResBlockNoSpectralNorm" else \
                dict(generator=gen)
            block, args = cls(cin, cout, norm_layer="adain", **kw,
                              **extra), tuple(ada)
        block = block.to(device)
        with torch.no_grad():
            _zero_launches()
            got = block(x, *args)
            torch.cuda.synchronize()
            launches = _launches()["adain_fused"]
            with _plain_kernels():
                want = block(x, *args)
        err = float((got - want).abs().max() / want.abs().max())
        out[name] = (launches, err)
        require(launches == per_forward and err <= TOL[torch.float32],
                f"block {name}: {launches} AdaIN launches (reckoned "
                f"{per_forward}), kernel vs plain {err:.3g} of the max")
    print("blocks (adain, batch {}, {}->{} channels, {}² up): ".format(
        b, cin, cout, side) + ", ".join(
            f"{k} {n} launches, kernel vs plain {e:.3g}"
            for k, (n, e) in out.items()) + f" (gate {TOL[torch.float32]})",
          flush=True)
    return out


def phase_config(workdir, device):
    """``cli.train.main`` with ``--config_name synthetic`` (read from
    ``configs/synthetic.yaml`` without yaml) on the card: one meta step
    at the config's 64² and batch 4 through both kernels (the config's
    flagship models at full width; one epoch of the 4 synthetic
    identities), its args as the config gives them."""
    _zero_launches()
    state, path = train_cli.main([
        "--config_name", "synthetic", "--synthetic_num_labels", "4",
        "--experiments_dir", str(workdir), "--device", str(device)])
    torch.cuda.synchronize()
    launches = _launches()
    saved = ckpt_lib.peek_args(path)
    per_forward = {"bn_relu_conv1x1_stats": 16, "adain_fused": len(
        state.models["generator"].adain_features)}
    # the step's forward and the visual grid's at step 0
    require(state.step == 1 and saved["image_size"] == 64
            and saved["batch_size"] == 4 and saved["allow_random_vgg"]
            and saved["experiment_name"] == "synthetic"
            and launches == {k: 2 * v for k, v in per_forward.items()},
            f"--config_name synthetic: step {state.step}, args "
            f"{ {k: saved[k] for k in ('image_size', 'batch_size')} }, "
            f"launches {launches}")
    print(f"config: cli.train --config_name synthetic, 1 step at "
          f"{saved['image_size']}² batch {saved['batch_size']}; launches "
          f"{launches}; saved {path.name}", flush=True)
    return launches


PHASE_SECONDS = {}


def timed(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds kept in PHASE_SECONDS and
    printed."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        _CRITERIA.clear()
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) \
            + time.perf_counter() - t0
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def main():
    started = time.perf_counter()
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
    kernels = {"adain_fused": adain_op, "conv_bn_fused": conv_bn}
    with concurrent.futures.ThreadPoolExecutor(len(kernels) + 1) as pool:
        built = [pool.submit(mod.kernel_entry) for mod in kernels.values()]
        built.append(pool.submit(native_loader.library))   # g++, the loader
        for future in built:
            future.result()
    print(f"build: {', '.join(kernels)} and the image loader (JPEG through "
          f"{native_loader.jpeg_decoder()}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for mod in kernels.values():
        print(build_log(load_library(*mod.LIBRARY)), flush=True)

    (adain_err, adain_ms, adain_plain_ms, adain_bound,
     adain_device_ms) = timed("kernels", phase_kernels, device)
    (conv_err, conv_ms, conv_plain_ms, conv_bound, conv_bound_by,
     conv_library_ms, conv_device_ms) = timed("conv_bn", phase_conv_bn,
                                              device)
    timed("int8_convs", phase_int8_convs, device)
    conv_train = timed("conv_bn_train", phase_conv_bn_train, device)
    conv_train16 = timed("conv_bn_train_bf16", phase_conv_bn_train, device,
                         torch.bfloat16)
    adain_train16 = timed("adain_train", phase_adain_train, device)
    block_variants = timed("blocks", phase_blocks, device)

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as workdir:
        ckpt = timed("checkpoint", phase_checkpoint, workdir)
        size = FLAGSHIP["image_size"]
        frames = cli.load_driver_frames("synthetic://3", size)
        require(frames.shape == (32, size, size, 3), f"frames {frames.shape}")
        args, models, state, _ = timed("drive", drive_once, ckpt, [], frames)
        timed("drive_f32", drive_once, ckpt, ["--compute_dtype", "float32"],
              frames)
        timed("throughput", phase_throughput, models, args, state, frames)
        timed("card_vs_cpu", phase_card_vs_cpu, ckpt, models, state,
              frames[:4])
        del models, state

        meta_ckpt = timed("meta_checkpoint", phase_meta_checkpoint,
                          Path(workdir) / "meta")
        (meta_args, meta_state, meta_loader, trained_ckpt, meta_launches,
         staged_ms) = timed("meta_train", phase_meta_train, meta_ckpt,
                            Path(workdir) / "metatrain", device)
        timed("meta_step_card_vs_cpu", phase_meta_step_card_vs_cpu,
              meta_args, meta_ckpt, meta_loader, device)
        timed("bf16_step_card", phase_bf16_step_card, meta_args, meta_state,
              meta_loader, device)
        del meta_state, meta_loader
        torch.cuda.empty_cache()
        (_, _, _, _, meta16_launches, staged16_ms) = timed(
            "meta_train_bf16", phase_meta_train, meta_ckpt,
            Path(workdir) / "metatrain_bf16", device, BF16_MODES)
        print(f"meta step, staged batches, batch 8 K=8: bf16 + uint8 wire "
              f"{staged16_ms:.2f} ms against f32 {staged_ms:.2f} ms (same "
              f"run): {staged16_ms / staged_ms:.3f} of the f32 step",
              flush=True)
        torch.cuda.empty_cache()
        config_launches = timed("config", phase_config,
                                Path(workdir) / "config", device)
        torch.cuda.empty_cache()
        dist_launches, dist_children = timed(
            "distributed", phase_distributed, meta_ckpt,
            Path(workdir) / "distributed", device)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tree, rows = write_tree(Path(workdir) / "tree")
        print(f"real data: tree of {len(rows)} videos x {TREE['frames']} "
              f"{SOURCE}² PNG frames and masks in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        real_launches, real_times = timed(
            "real_data", phase_real_data, meta_ckpt, tree, rows,
            Path(workdir) / "real", device, staged_ms)
        real16_launches, real16_times = timed(
            "real_data_bf16", phase_real_data, meta_ckpt, tree, rows,
            Path(workdir) / "real", device, staged16_ms, BF16_MODES)
        for regime in ("meta", "finetune"):
            (a, b) = real_times[regime], real16_times[regime]
            print(f"real data, {regime} through the CLI: f32 step_ms "
                  f"{a[0]:.2f} Data_time_ms {a[1]:.2f} Batch_time_ms "
                  f"{a[2]:.2f} ({a[1] / a[2]:.1%}); bf16 + uint8 step_ms "
                  f"{b[0]:.2f} Data_time_ms {b[1]:.2f} Batch_time_ms "
                  f"{b[2]:.2f} ({b[1] / b[2]:.1%})", flush=True)
        (ft_args, ft_state, ft_seeded, loader, ft_ckpt,
         ft_launches) = timed(
            "finetune", phase_finetune, trained_ckpt,
            Path(workdir) / "finetune", device)
        timed("drive_finetuned", drive_once, ft_ckpt, [], frames)
        int8_adains = timed("int8_drive", phase_int8_drive, ft_ckpt,
                            Path(workdir) / "int8", frames, device)
        prep = timed("preprocess", phase_preprocess, Path(workdir) / "prep",
                     device)
        crop_adains = timed("drive_crop", phase_drive_crop, ft_ckpt, prep,
                            Path(workdir) / "drive_crop", device)
        torch.cuda.empty_cache()
        fsth_launches, fsth_kernel, fsth_times, stick_ms = timed(
            "fsth", phase_fsth, prep, Path(workdir) / "fsth", device)
        torch.cuda.empty_cache()
        abl_launches, abl = timed("ablations", phase_ablations, prep,
                                  Path(workdir) / "ablations", device)
        torch.cuda.empty_cache()
        timed("ehat_card_vs_cpu", phase_ehat_card_vs_cpu, ft_state, loader,
              device)
        timed("step_card_vs_cpu", phase_step_card_vs_cpu, ft_args,
              {"seeded": ft_seeded, "trained": ft_state}, loader, device)
        del ft_args, ft_state, ft_seeded, loader
        torch.cuda.empty_cache()
        export_launches = timed("export", phase_export, ft_ckpt,
                                abl["avatars"], Path(workdir) / "export",
                                frames, device)
        reference_launches = timed(
            "reference_checkpoint", phase_reference_checkpoint,
            Path(workdir) / "reference", device)
        torch.cuda.empty_cache()
        protocol_launches = timed("eval", phase_eval, meta_ckpt,
                                  Path(workdir) / "eval", device)
    bf16_launches = {k: meta16_launches[k] + real16_launches[k]
                     for k in ft_launches}
    launches = {k: meta_launches[k] + ft_launches[k] + real_launches[k]
                + bf16_launches[k] + dist_launches[k] + config_launches[k]
                for k in ft_launches}
    launches["adain_fused"] += int8_adains + crop_adains + reference_launches \
        + fsth_launches
    for k in launches:
        launches[k] += abl_launches[k]

    print("phases by seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(PHASE_SECONDS.items(),
                                           key=lambda kv: -kv[1])),
          flush=True)
    print(f"smoke total: {time.perf_counter() - started:.1f} s", flush=True)
    print(json.dumps({"kernels": [{
        "name": "adain_fused", "route": "cuda",
        "source": "latentpose_tpu_torch/csrc/adain_fused.cu",
        "replaces": "latentpose_tpu/ops/pallas/adain_fused.py:78",
        "launches": launches["adain_fused"], "max_abs_err": adain_err,
        "ms": adain_ms, "plain_ms": adain_plain_ms, "bound_ms": adain_bound,
        "bound_by": "bytes", "device_ms": adain_device_ms, "library_ms": None,
        "library_call": "none: no single PyTorch call computes instance "
                        "norm with a per-sample affine and ReLU",
        "bf16_train_launches": bf16_launches["adain_fused"],
        "bf16_train": adain_train16,
        "distributed_child_launches": dist_children["adain_fused"],
        "eval_child_launches": protocol_launches["adain_fused"],
        "export_child_launches": export_launches,
        "config_launches": config_launches["adain_fused"],
        "block_variants": {k: {"launches": n, "max_rel_err": e}
                           for k, (n, e) in block_variants.items()},
        "reference_drive_launches": reference_launches,
        "fsth_launches": fsth_launches,
        "fsth": {"max_rel_err": fsth_kernel[0], "ms": fsth_kernel[1],
                 "plain_ms": fsth_kernel[2], "bound_ms": fsth_kernel[3],
                 "device_ms": fsth_kernel[4],
                 "calls_a_forward": FSTH_PER_FORWARD,
                 "meta_step_ms": fsth_times["f32"][0],
                 "finetune_step_ms": fsth_times["f32"][1],
                 "bf16_meta_step_ms": fsth_times["bf16 + uint8"][0],
                 "bf16_finetune_step_ms": fsth_times["bf16 + uint8"][1],
                 "stickman_host_ms": stick_ms},
        "ablations_launches": abl_launches["adain_fused"],
        "ablations": {k: abl[k] for k in ("meta_step_ms",
                                          "finetune_step_ms")}}, {
        "name": "bn_relu_conv1x1_stats", "route": "cuda",
        "source": "latentpose_tpu_torch/csrc/conv_bn_fused.cu",
        "replaces": "latentpose_tpu/ops/pallas/conv_bn_fused.py:58",
        "launches": launches["bn_relu_conv1x1_stats"],
        "max_abs_err": conv_err, "ms": conv_ms,
        "plain_ms": conv_plain_ms, "bound_ms": conv_bound,
        "bound_by": conv_bound_by, "device_ms": conv_device_ms,
        "library_ms": conv_library_ms,
        "library_call": "torch.matmul(h, w), the product alone on the "
                        "already-normalised activation, f32, TF32 off",
        "train_backward_ms": conv_train["backward_ms"],
        "train_backward_device_ms": conv_train["backward_device_ms"],
        "bf16_train_launches": bf16_launches["bn_relu_conv1x1_stats"],
        "bf16_train": conv_train16,
        "distributed_child_launches": dist_children["bn_relu_conv1x1_stats"],
        "eval_child_launches": protocol_launches["bn_relu_conv1x1_stats"],
        "config_launches": config_launches["bn_relu_conv1x1_stats"],
        "ablations_launches": abl_launches["bn_relu_conv1x1_stats"],
        "ablations": {k: abl[k] for k in (
            "x2face_meta_step_ms", "x2face_card_vs_cpu", "x2face_drive_fps",
            "ffhq_fps", "seconds")}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--meta-repro"]:
        meta_repro(*[sys.argv[2:]] if sys.argv[2:] else [])
    elif sys.argv[1:2] == ["--meta-repro-child"]:
        meta_repro_child(*sys.argv[2:5])
    elif sys.argv[1:2] == ["--dist-child"]:
        dist_child(*sys.argv[2:7])
    else:
        main()
