"""Training entry point of the PyTorch port (port of
``latentpose_tpu/cli/train.py``), meta-training and fine-tuning:

    python -m latentpose_tpu_torch.cli.train \
        --dataloader voxceleb2_segmentation_nolandmarks --data_root ROOT \
        [--checkpoint_path META_CKPT] [--device cuda] ...
    python -m latentpose_tpu_torch.cli.train --finetune \
        --checkpoint_path CKPT --dataloader voxceleb2_segmentation_nolandmarks \
        --data_root ROOT --train_split_path IDENTITY/VIDEO [--device cuda] ...

Dataloaders: ``voxceleb2_segmentation_nolandmarks`` (the preprocessed
VoxCeleb2 tree: frames, segmentation masks, bboxes, split CSVs; fine-tuning
reads one directory of a person's images) and ``synthetic`` (procedural
faces).

Meta-training (no ``--finetune``) starts from a seeded init of the flagship
models, or resumes a meta-trained checkpoint of either package: the
identity tower (ResNeXt-50 in train form, its 16 BN->ReLU->1x1-conv links
through the fused kernel under autograd) and the pose tower train with the
generator under Adam, the six criteria of ``configs/default.yaml`` (with
``dis_embed``), the three augmentations and an EMA of 0.999.

Fine-tuning (``--finetune``) from a meta-trained checkpoint computes ê (the
mean identity embedding over the avatar's frames), re-parameterises and
trains the generator and ê with RAdam and an EMA of 0.972; from a
fine-tuned checkpoint it resumes.

``--compute_dtype bfloat16`` trains with bf16 activations where the JAX
package casts (``runners/holycow.py`` has the dtype map), and
``--transfer_dtype uint8`` sends the images to the device as bytes, which
the step divides by 255 there; both are saved with the checkpoint's args.

The loop (``runners/loop.py``) logs scalars and visual grids to the
experiment's directory, runs the fixed-id probes, validation with
``--no-skip_eval`` and the ``--saver``, and saves in the JAX layout,
optimizer state included, which both packages read.  SIGINT or SIGTERM
saves at the next step boundary and ends the run (exit 0); a second one
ends it without saving.

``--num_devices N`` trains on N devices, one process (rank) each (0, the
default, takes every visible card, as the JAX CLI takes every device, and
one process on the CPU): without torchrun the CLI starts the N local
ranks itself (``parallel/launch.py``); under torchrun each process joins
the group it is given, on one host or many.  ``--batch_size`` is the
global batch: each rank loads ``batch_size / N`` rows.  Three regimes, as
in the JAX step (``runners/holycow.py``): by default BatchNorm and dice
take the global batch's statistics and the gradient mean is reduced in
f32; ``--explicit_grad_reduce`` keeps each rank's own statistics and
averages the running statistics after the step; ``--grad_dtype bfloat16``
(which implies it) reduces the gradients in bf16.  Rank 0 alone writes
the logs, visuals, probes, validation and checkpoints; every rank resumes
from the same checkpoint, and a signal stops every rank at the same step.
``--param_sharding fsdp`` shards the parameters, the EMA and both
optimizers' moments over the ranks, each keeping 1/N (the JAX CLI's
ZeRO-3 placement; ``parallel/mesh.py`` ``shard_state``): each step gathers
the parameters and reduce-scatters the gradients, and every rank joins
the gathers of rank 0's visuals, probes, validation and saves.  The
checkpoint is the replicated run's, whole; a resume at any world, with or
without the flag, reads it whole and keeps its slice.  With one rank the
flag does nothing, as with the JAX CLI.

Arguments resolve as the JAX package's ``config/resolution.py`` resolves
them, lowest to highest: the JAX core defaults (:data:`DEFAULTS`), the
checkpoint's saved args, the config that ``--config_name`` names (read only
when it is given), then the flags given here (``--fixed_val_ids`` appends, as
argparse's append does).  An experiment without ``--experiment_name`` is
named after the config.  The port carries two configs as dicts, since yaml
is not imported: ``default`` (``configs/default.yaml``, :data:`META_CONFIG`,
the flagship's meta-training) and ``finetuning-base``
(``configs/finetuning-base.yaml``, :data:`FINETUNE_CONFIG`); another name is
refused (ROADMAP.md A.21).  So a fresh meta-training run passes
``--config_name default`` and a fine-tune ``--config_name finetuning-base``,
as with the JAX CLI.  What the port does not run yet is refused with the
ROADMAP.md item that will bring it.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import threading
import types
from pathlib import Path

import numpy as np
import torch

from latentpose_tpu_torch import checkpoint as ckpt_lib
from latentpose_tpu_torch import convert, registry
from latentpose_tpu_torch.data.dataloader import \
    get_dataloader as build_dataloader
from latentpose_tpu_torch.ops.spectral_norm import SNEmbed
from latentpose_tpu_torch.parallel import launch
from latentpose_tpu_torch.parallel import mesh as parallel
from latentpose_tpu_torch.runners import finetune as ft
from latentpose_tpu_torch.runners import holycow, loop
from latentpose_tpu_torch.runners.state import (TrainState, ema_of,
                                                shard_groups)
from latentpose_tpu_torch.utils.logging_writer import setup_logging
from latentpose_tpu_torch.utils.saver import Saver

logger = logging.getLogger("latentpose_tpu_torch.train")

# The JAX package's defaults for the args this path reads (config/core_args.py
# and the plugins' get_args), below the checkpoint's saved args.
DEFAULTS = dict(
    in_channels=3, out_channels=3, num_channels=64, max_num_channels=512,
    embed_channels=512, pose_embedding_size=136, image_size=256,
    optimizer="Adam", lr_gen=5e-5, lr_dis=2e-4, beta1=0.0, batch_size=8,
    num_labels=0, num_devices=0, compute_dtype="float32", random_seed=123,
    experiments_dir="data/experiments", experiment_name="",
    vgg_weights_dir="data/weights", allow_random_vgg=False, num_epochs=10 ** 9,
    set_eval_mode_in_train=False, save_frequency=1, skip_eval=True,
    weights_running_average=True, finetune=False,
    average_function="sum", gen_padding="zero", gen_constant_input_size=4,
    gen_num_residual_blocks=2, dis_padding="zero", dis_num_blocks=7,
    gan_type="gan", fm_weight=10.0, perc_weight=1e-2, idt_embed_weight=2e-3,
    dis_embed_weight=1e-2, dice_weight=1.0, num_enc_frames=8,
    synthetic_num_labels=16, synthetic_frames_per_video=32,
    transfer_dtype="float32", grad_accum_steps=1, grad_dtype="float32",
    explicit_grad_reduce=False, use_pixelwise_augs=False,
    use_affine_scale=False, use_affine_shift=False, log_frequency_loss=1,
    iteration=0, dataloader="", criterions="", metrics="", data_root="",
    generator="", embedder="", discriminator="", runner="",
    img_dir="images-cropped", kp_dir="keypoints-cropped",
    segm_dir="segmentation-cropped", bboxes_dir="/non/existent/file",
    train_split_path="data/splits/train.csv",
    val_split_path="data/splits/val.csv", num_workers=4, prefetch_size=16,
    n_frames_for_encoder=8, draw_oval=True, inference=False, logging=True,
    saver="", detailed_metrics=True, log_frequency_images=100,
    log_frequency_fixed_images=2500, fixed_val_ids=[50, 100, 200, 250, 300],
    batch_size_inference=5, num_visuals_per_img=2, set_eval_mode_in_test=True,
    args_to_ignore="checkpoint,splits_dir,experiments_dir,extension,"
                   "experiment_name,rank,local_rank,world_size",
    profile_dir="", profile_steps=5, config_name="",
    param_sharding="replicated")

# configs/default.yaml, the flagship meta-training config.
META_CONFIG = dict(
    generator="vector_pose_unsupervised_segmentation_noBottleneck",
    embedder="unsupervised_pose_separate_embResNeXt_segmentation",
    discriminator="no_landmarks",
    criterions="idt_embed, perceptual, adversarial, featmat, dis_embed, dice",
    dataloader="voxceleb2_segmentation_nolandmarks", runner="holycow",
    train_split_path="./data/splits/train.csv",
    val_split_path="./data/splits/val.csv", img_dir="images-cropped",
    kp_dir="keypoints-cropped", segm_dir="segmentation-cropped",
    experiments_dir="experiments/", data_root="",
    bboxes_dir="/non/existent/file", num_devices=0, batch_size=8,
    num_workers=4, prefetch_size=16, perc_weight=3e-2, idt_embed_weight=0.6e-2,
    pose_embedding_size=256, log_frequency_images=500,
    log_frequency_fixed_images=2500, use_pixelwise_augs=True,
    use_affine_scale=True, use_affine_shift=True)

# configs/finetuning-base.yaml.
FINETUNE_CONFIG = dict(
    use_pixelwise_augs=True, use_affine_scale=True, use_affine_shift=True,
    finetune=True, optimizer="RAdam", lr_gen=5e-4, lr_dis=8e-4,
    criterions="adversarial, featmat, idt_embed, perceptual, dice",
    img_dir="images-cropped", kp_dir="keypoints-cropped",
    segm_dir="segmentation-cropped", bboxes_dir="/non/existent/file",
    num_devices=1, num_workers=1, log_frequency_images=9999999,
    log_frequency_fixed_images=15, fixed_val_ids=[0], num_epochs=140,
    save_frequency=0)

# --config_name: the configs the port carries
CONFIGS = {"default": META_CONFIG, "finetuning-base": FINETUNE_CONFIG}

# --param_sharding (latentpose_tpu/config/core_args.py)
PARAM_SHARDING = ("replicated", "fsdp")

# the criteria that run a VGG tower and take the device to build it on
_VGG_CRITERIA = ("idt_embed", "perceptual")


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    flag = argparse.BooleanOptionalAction
    parser.add_argument("--config_name", "--config", default=None)
    parser.add_argument("--checkpoint_path", default=None)
    parser.add_argument("--finetune", action=flag, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on")
    for name in ("dataloader", "generator", "embedder", "discriminator",
                 "criterions", "metrics", "experiments_dir",
                 "experiment_name", "vgg_weights_dir", "compute_dtype",
                 "transfer_dtype", "grad_dtype", "optimizer", "data_root",
                 "img_dir", "segm_dir", "kp_dir", "bboxes_dir",
                 "train_split_path", "val_split_path", "saver",
                 "profile_dir"):
        parser.add_argument(f"--{name}", default=None)
    parser.add_argument("--param_sharding", choices=PARAM_SHARDING,
                        default=None)
    parser.add_argument("--args_to_ignore", "--args-to-ignore", default=None)
    for name in ("batch_size", "num_epochs", "random_seed", "save_frequency",
                 "num_devices", "grad_accum_steps", "synthetic_num_labels",
                 "num_enc_frames", "log_frequency_loss",
                 "log_frequency_images", "log_frequency_fixed_images",
                 "image_size", "num_channels", "max_num_channels",
                 "embed_channels", "pose_embedding_size", "dis_num_blocks",
                 "gen_num_residual_blocks", "num_workers", "prefetch_size",
                 "n_frames_for_encoder", "batch_size_inference",
                 "num_visuals_per_img", "profile_steps"):
        parser.add_argument(f"--{name}", type=int, default=None)
    parser.add_argument("--fixed_val_ids", type=int, action="append",
                        default=None)
    for name in ("lr_gen", "lr_dis", "beta1"):
        parser.add_argument(f"--{name}", type=float, default=None)
    for name in ("allow_random_vgg", "set_eval_mode_in_train", "skip_eval",
                 "explicit_grad_reduce", "weights_running_average",
                 "use_pixelwise_augs", "use_affine_scale",
                 "use_affine_shift", "draw_oval", "logging",
                 "detailed_metrics", "set_eval_mode_in_test"):
        parser.add_argument(f"--{name}", action=flag, default=None)
    return parser


def _refuse(what, item):
    raise NotImplementedError(f"{what} is not ported to PyTorch yet "
                              f"(ROADMAP.md {item})")


def checkpoint_is_finetuned(path) -> bool:
    meta_path = Path(path) / "meta.json"
    if not meta_path.exists():
        raise FileNotFoundError(f"Checkpoint `{path}` not found")
    return bool(json.loads(meta_path.read_text()).get("finetune", False))


def _resolve(argv):
    """(args, default args): every level, and every level but the flags
    (the JAX CLI's parse of an empty command line, which names the
    experiment)."""
    cli = build_parser().parse_args(argv)
    config = {}
    if cli.config_name:
        if cli.config_name not in CONFIGS:
            _refuse(f"--config_name {cli.config_name} (the port carries "
                    f"{sorted(CONFIGS)})", "A.21")
        config = CONFIGS[cli.config_name]
    base = dict(DEFAULTS)
    if cli.checkpoint_path:
        base.update(ckpt_lib.peek_args(cli.checkpoint_path))
    base.update(config)
    args = dict(base)
    args.update({k: v for k, v in vars(cli).items() if v is not None})
    if cli.fixed_val_ids:
        args["fixed_val_ids"] = list(base["fixed_val_ids"]) \
            + cli.fixed_val_ids
    for level in (args, base):
        level.update(finetune=bool(level["finetune"]),
                     checkpoint_path=cli.checkpoint_path or "")
    if not args["experiment_name"]:
        args["experiment_name"] = args["config_name"]
    if args["finetune"] and not cli.checkpoint_path:
        raise ValueError("--finetune needs --checkpoint_path, a meta-trained "
                         "or fine-tuned checkpoint")
    if cli.checkpoint_path and checkpoint_is_finetuned(cli.checkpoint_path) \
            and not args["finetune"]:
        raise ValueError(f"{cli.checkpoint_path} is a fine-tuned checkpoint: "
                         "it resumes with --finetune")
    return types.SimpleNamespace(**args), types.SimpleNamespace(**base)


def resolve_args(argv=None):
    """The args namespace of a run (see the module docstring), with
    everything the port does not run refused."""
    args, _ = _resolve(argv)
    for flag in ("generator", "embedder", "discriminator", "dataloader"):
        if not getattr(args, flag):
            raise ValueError(f"no --{flag}: name it, resume a checkpoint "
                             "that carries it, or take a config "
                             f"(--config_name, one of {sorted(CONFIGS)})")

    for flag, values in (("compute_dtype", holycow.DTYPES),
                         ("transfer_dtype", ("float32", "uint8"))):
        if getattr(args, flag) not in values:
            raise ValueError(f"--{flag} {getattr(args, flag)!r}: one of "
                             f"{sorted(values)}")
    if args.grad_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"--grad_dtype {args.grad_dtype!r}: one of "
                         "['bfloat16', 'float32']")
    if args.param_sharding not in PARAM_SHARDING:     # a saved value
        raise ValueError(f"--param_sharding {args.param_sharding!r}: one "
                         f"of {list(PARAM_SHARDING)}")
    world = parallel.requested_world(args.num_devices,
                                     torch.device(args.device).type)
    if world > 1 and not parallel.launched():
        parallel.check_devices(torch.device(args.device).type, world)
    if parallel.launched():
        args.num_devices = world        # saved with the checkpoint
    if parallel.explicit_regime(args) and world < 2 \
            and not parallel.launched():
        raise ValueError("--grad_dtype bfloat16 / --explicit_grad_reduce "
                         "need a device mesh (--num_devices > 1)")
    for kind, names in (("dataloaders", [args.dataloader]),
                        ("metrics", _names(args.metrics)),
                        ("criterions", _names(args.criterions))):
        for name in names:
            if name not in registry.names(kind):
                _refuse(f"{kind[:-1]} {name!r} (the port has "
                        f"{list(registry.names(kind))})", "A.19")
    for kind, name in (("embedders", args.embedder),
                       ("generators", args.generator),
                       ("discriminators", args.discriminator)):
        registry.load_wrapper(kind, name)      # raises for other families
    if args.optimizer not in ft.OPTIMIZERS:
        raise ValueError(f"--optimizer {args.optimizer!r}: the JAX package "
                         f"has {sorted(ft.OPTIMIZERS)}")
    if args.batch_size % world:
        raise ValueError(f"--batch_size {args.batch_size} does not split "
                         f"over {world} ranks")
    if args.batch_size // world % max(args.grad_accum_steps, 1):
        raise ValueError(
            f"--grad_accum_steps {args.grad_accum_steps} must divide "
            f"--batch_size {args.batch_size}"
            + (f" / {world} ranks" if world > 1 else ""))
    return args


def _names(csv_names):
    return [n.strip() for n in csv_names.split(",") if n.strip()]


def build_models(args, generator=None):
    return {
        "embedder": registry.load_wrapper("embedders", args.embedder)
        .get_net(args, generator=generator),
        "generator": registry.load_wrapper("generators", args.generator)
        .get_net(args, generator=generator),
        "discriminator": registry.load_wrapper(
            "discriminators", args.discriminator)
        .get_net(args, generator=generator),
    }


def init_state(args, dataloader, device) -> TrainState:
    """A fresh meta-train state from ``args.random_seed``: the flagship
    models' init, the EMA equal to it, fresh optimizers; the discriminator
    has a row for each of the loader's identities."""
    if not args.num_labels:
        args.num_labels = dataloader.num_labels
    generator = torch.Generator().manual_seed(args.random_seed)
    models = {k: m.to(device)
              for k, m in build_models(args, generator=generator).items()}
    state = TrainState(models=models, ema_params={
        part: ema_of(models[part]) for part in ("embedder", "generator")})
    state.opt_g, state.opt_d = ft.optimizers(state, args)
    logger.info("Meta-training from a seeded init (seed %d)",
                args.random_seed)
    return state


def load_checkpoint(args, device) -> TrainState:
    """The train state of ``args.checkpoint_path`` on ``device``, optimizers
    included: a meta-trained one (the discriminator with the checkpoint's
    ``num_labels``) or a fine-tuned one (its one-row discriminator and
    identity embedding)."""
    flat = ckpt_lib.load_arrays(args.checkpoint_path)
    finetuned = checkpoint_is_finetuned(args.checkpoint_path)
    embed = flat[ckpt_lib.SEP.join(("params", "discriminator", "embed",
                                    "embedding"))]
    args.num_labels = int(embed.shape[0])
    models = build_models(args)
    finetune_embedding = None
    if finetuned:
        models["discriminator"].embed = SNEmbed(1, embed.shape[1],
                                                sn_eps=1e-12)
        finetune_embedding = torch.zeros(1, embed.shape[1], device=device)
    models = {k: m.to(device) for k, m in models.items()}
    state = TrainState(models=models, ema_params={},
                       finetune_embedding=finetune_embedding)
    if finetuned:
        state.finetune_embedding.requires_grad_()
        state.ema_params["finetune_embedding"] = torch.zeros_like(
            finetune_embedding)
    state.opt_g, state.opt_d = ft.optimizers(state, args)
    convert.load_train_state(flat, state)
    logger.info("Loaded %s checkpoint %s (iteration %d, optimizer count "
                "%d)", "fine-tuned" if finetuned else "meta-trained",
                args.checkpoint_path, state.step, state.opt_g.count)
    return state


def build_criteria(args, device):
    out = []
    for name in (n.strip() for n in args.criterions.split(",")):
        if not name:
            continue
        wrapper = registry.load_wrapper("criterions", name)
        out.append(wrapper.get_net(args, device=device)
                   if name in _VGG_CRITERIA else wrapper.get_net(args))
    return out


def start_finetuning(args, state, dataloader, device):
    """ê over one pass of ``dataloader``, then the fine-tune state.  Under
    N ranks rank 0 computes ê over a loader of the whole avatar (one
    process's), and broadcasts it; ``dataloader`` is then not read."""
    logger.info("Fine-tuning: computing averaged identity embedding from the "
                "avatar's frames")
    if parallel.initialized():
        e_hat = torch.zeros(1, args.embed_channels, device=device)
        if parallel.is_main():
            with parallel.local_view():
                whole = build_dataloader(args, "train", "train")
            e_hat = ft.compute_averaged_identity_embedding(
                state, whole, device, holycow.compute_dtype(args))
        parallel.broadcast_tensor(e_hat)
    else:
        e_hat = ft.compute_averaged_identity_embedding(
            state, dataloader, device, holycow.compute_dtype(args))
    generator = torch.Generator().manual_seed(args.random_seed)
    state = ft.enable_finetuning(state, args, e_hat, generator=generator)
    args.num_labels = 1
    return state


def make_step(args, criteria):
    """The train step of ``args``."""
    return holycow.make_train_step(criteria, args)


def place_state(args, state):
    """Rank 0's state on every rank (``parallel.replicate``), then, under
    ``--param_sharding fsdp``, sharded over the ranks; returns it."""
    parallel.replicate(state)
    if args.param_sharding == "fsdp":
        parallel.shard_state(state, shard_groups(state))
    return state


def save(args, state):
    """Save ``state``; under N ranks rank 0 writes, every rank meets it at
    a barrier after the write and returns its path.  A sharded state is
    gathered whole on every rank for the write: the checkpoint is the
    replicated run's."""
    path = None
    with parallel.gathered(state, whole=True):
        if parallel.is_main():
            meta = {k: (str(v) if isinstance(v, Path) else v)
                    for k, v in vars(args).items()}
            path = ckpt_lib.save_checkpoint(
                args.experiment_dir, convert.export_train_state(state),
                meta, iteration=state.step, finetune=state.finetune)
    parallel.barrier()
    return parallel.broadcast_object(path)


class StopFlag:
    """SIGINT / SIGTERM while training: the first sets the flag, which the
    loop reads at the next step boundary, where the state is whole (an
    optimizer update is many in-place ops); the run then saves and ends.  A
    second signal ends the run at once, without saving."""

    SIGNALS = (signal.SIGINT, signal.SIGTERM)

    def __init__(self):
        self.event = threading.Event()
        self.agreed = False
        self._previous = {}

    def is_set(self):
        """Under N ranks: the flag they agreed on at the last
        :meth:`agree`."""
        return self.agreed if parallel.initialized() \
            else self.event.is_set()

    def agree(self, device) -> bool:
        """At a step boundary: whether any rank was signalled (one
        all-reduce under N ranks), so that every rank stops at one step."""
        self.agreed = parallel.any_rank(self.event.is_set(), device)
        return self.agreed

    def _handle(self, signum, _frame):
        if self.event.is_set():
            raise SystemExit(128 + signum)
        logger.info("Signal %d: saving at the next step boundary (again to "
                    "stop without saving)", signum)
        self.event.set()

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for sig in self.SIGNALS:
                self._previous[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc):
        for sig, handler in self._previous.items():
            signal.signal(sig, handler)


def parent_result(result):
    """What a ``--num_devices N`` launch returns from rank 0: (None, path
    of the last checkpoint saved)."""
    return None, result[1]


def main(argv=None):
    """Train as the flags say; returns (state, path of the last checkpoint
    saved); a ``--num_devices N`` launch returns (None, path)."""
    logging.basicConfig(level=logging.INFO)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = resolve_args(argv)
    world = parallel.requested_world(args.num_devices,
                                     torch.device(args.device).type)
    if world > 1 and not parallel.launched():
        return launch.run("latentpose_tpu_torch.cli.train", argv, world)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    joined = parallel.launched() and not parallel.initialized()
    if joined:
        device = parallel.init_process_group(device)
    try:
        return _train(args, argv, device)
    finally:
        if joined:
            parallel.destroy_process_group()


def _train(args, argv, device):
    main_rank = parallel.is_main()
    np.random.seed(args.random_seed)
    # a checkpoint pins num_labels, which truncates the identity list
    state = load_checkpoint(args, device) if args.checkpoint_path else None
    train_loader = build_dataloader(args, "train", "train")
    val_loader = None
    if main_rank and not args.skip_eval:
        with parallel.local_view():     # rank 0 validates the whole part
            val_loader = build_dataloader(args, "val", "val")
    if state is None:
        state = init_state(args, train_loader, device)
    criteria = build_criteria(args, device)
    if args.finetune and not state.finetune:
        # ê on the whole state, before it is sharded
        state = start_finetuning(args, state, train_loader, device)
    place_state(args, state)
    args.iteration = state.step
    metrics = [registry.load_wrapper("metrics", name).get_net(args)
               for name in _names(args.metrics)]

    writer = None
    if args.logging and main_rank:
        args.experiment_dir, writer = setup_logging(
            args, _resolve(argv)[1], args.args_to_ignore.split(","))
    elif not args.logging:
        args.experiment_dir = str(args.experiments_dir)
    args.experiment_dir = parallel.broadcast_object(
        getattr(args, "experiment_dir", None))
    saver = Saver(Path(args.experiment_dir) / "validation_results",
                  args.saver) if args.saver and main_rank else None
    step_fn = make_step(args, criteria)
    eval_forward = loop.make_eval_forward(args)
    keys = holycow.STEP_KEYS if state.finetune else holycow.META_STEP_KEYS

    path, saved_step = None, None
    try:
        with StopFlag() as stop:
            for epoch in range(args.num_epochs):
                loop.run_epoch(train_loader, step_fn, state, args, epoch,
                               device, keys, writer=writer,
                               eval_forward=eval_forward, metrics=metrics,
                               saver=saver, stop=stop)
                if stop.is_set():
                    break
                if not args.skip_eval:      # every rank joins the gather
                    with parallel.gathered(state, whole=True):
                        if val_loader is not None:
                            loop.run_validation(
                                val_loader, eval_forward, state, args, epoch,
                                writer=writer, metrics=metrics, saver=saver)
                if stop.agree(device):
                    break
                will_save = epoch == args.num_epochs - 1
                if args.save_frequency != 0:
                    will_save |= epoch % args.save_frequency == 0
                if will_save:
                    path, saved_step = save(args, state), state.step
            if stop.is_set() and saved_step != state.step:
                logger.info("Interrupted: saving the model at step %d",
                            state.step)
                path = save(args, state)
    finally:
        if writer is not None:
            writer.close()
    return state, path


if __name__ == "__main__":
    main()
