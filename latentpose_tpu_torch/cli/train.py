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
reads one directory of a person's images), the landmark datasets
``voxceleb2``, ``voxceleb2_segm`` and ``voxceleb2_FSTH_crop`` (frames,
``keypoints-cropped`` and their stickmen), the VoxCeleb1-crop datasets
``voxceleb2_X2Face`` and ``voxceleb2_segmentation_nolandmarks_X2Face_
FAbNet_crops`` (``--voxceleb1_crop_type x2face|fabnet``) and ``synthetic``
(procedural faces; ``--synthetic_stickmen`` adds keypoints and stickmen).

Model families: the flagship (the defaults of ``--config_name default``),
the few-shot-talking-heads baseline (``--embedder FSTH|no_pose_encoder
--generator FSTH|FSTH_plus --discriminator FSTH`` on a landmark dataset,
with the criterion ``l1_rgb`` beside the others; ``idt_embed`` takes its
face box from the keypoints), X2Face (``--embedder X2Face --generator
X2Face --discriminator none --criterions l1_rgb``), the pretrained-pose
ablations (``--embedder X2Face_pretrained_embResNeXt|FAbNet_pretrained_
embResNeXt`` with the flagship's generator and discriminator: a frozen
pose encoder beside ResNeXt-50) and ``--embedder simple_conv``;
``--gan_type gan|rgan|ragan``.  An FSTH fine-tune trains the generator's
packed AdaIN parameters (``finetune_affine``) where the flagship and the
others train ê; X2Face's "fine-tune" takes no step: it stores the
avatar's first ``--X2Face_num_identity_images`` images
(:func:`store_identity_images`).

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
them (``latentpose_tpu_torch/config/``), lowest to highest: the parser's
defaults (the JAX core parser's and each selected plugin's), the
checkpoint's saved args, the config that ``--config_name`` names (any
``configs/<name>.yaml`` under the working directory, read without yaml),
then the flags given here; an experiment without ``--experiment_name`` is
named after the config.  The parser accepts every flag the JAX train CLI's
does, and ``--device``; an arg that no parser level holds (a key the
selected plugins do not register) takes the default of the first plugin
that registers it (``config.plugin_defaults``).  So a fresh
meta-training run passes ``--config_name default`` and a fine-tune
``--config_name finetuning-base``, as with the JAX CLI.
"""

from __future__ import annotations

import copy
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
from latentpose_tpu_torch import config, convert, registry
from latentpose_tpu_torch.data.dataloader import \
    get_dataloader as build_dataloader
from latentpose_tpu_torch.losses.adversarial import GAN_TYPES
from latentpose_tpu_torch.ops.spectral_norm import SNEmbed
from latentpose_tpu_torch.parallel import launch
from latentpose_tpu_torch.parallel import mesh as parallel
from latentpose_tpu_torch.runners import build, finetune as ft
from latentpose_tpu_torch.runners import holycow, loop
from latentpose_tpu_torch.runners.state import (FINETUNE_LEAVES, TrainState,
                                                ema_of, shard_groups)
from latentpose_tpu_torch.utils.logging_writer import setup_logging
from latentpose_tpu_torch.utils.saver import Saver

logger = logging.getLogger("latentpose_tpu_torch.train")

# --param_sharding (latentpose_tpu/config/core_args.py)
PARAM_SHARDING = ("replicated", "fsdp")

# the criteria that run a VGG tower and take the device to build it on
_VGG_CRITERIA = ("idt_embed", "perceptual")


def build_parser():
    """The JAX train CLI's core parser, ``--device`` and the flags of the
    port's one runner, ``holycow`` (the loop's and the wire's: a resumed
    checkpoint that names no runner still takes ``--transfer_dtype``);
    each selected plugin adds its own flags while the args resolve."""
    parser = config.build_core_parser()
    parser.add("--device", type=str, default="cuda",
               help="torch device to train on")
    parser.add("--args-to-ignore", "--args_to_ignore", type=str,
               default=parser.get_default("args_to_ignore"))
    config.add_plugin_args(parser, "runners", "holycow")
    return parser


def checkpoint_is_finetuned(path) -> bool:
    meta_path = Path(path) / "meta.json"
    if not meta_path.exists():
        raise FileNotFoundError(f"Checkpoint `{path}` not found")
    return bool(json.loads(meta_path.read_text()).get("finetune", False))


def _resolve(argv, custom_args=None):
    """(args, default args): every level, and every level but the flags
    (the JAX CLI's parse of an empty command line, which names the
    experiment).  ``custom_args``: a caller's level above the config."""
    args, default, _, _ = config.get_args_and_modules(
        build_parser(), custom_args=custom_args, argv=argv)
    defaults = config.plugin_defaults()
    for level in (args, default):
        for key, value in defaults.items():
            if not hasattr(level, key):
                setattr(level, key, copy.deepcopy(value))
        level.finetune = bool(level.finetune)
    if args.finetune and not args.checkpoint_path:
        raise ValueError("--finetune needs --checkpoint_path, a meta-trained "
                         "or fine-tuned checkpoint")
    if args.checkpoint_path and checkpoint_is_finetuned(args.checkpoint_path) \
            and not args.finetune:
        raise ValueError(f"{args.checkpoint_path} is a fine-tuned checkpoint: "
                         "it resumes with --finetune")
    return args, default


def resolve_args(argv=None, custom_args=None):
    """The args namespace of a run (see the module docstring), with
    everything the port does not run refused.  ``custom_args``: the JAX
    resolver's level 4, {arg: value} above the config and below the
    flags."""
    args, _ = _resolve(argv, custom_args)
    for flag in ("generator", "embedder", "discriminator", "dataloader"):
        if not getattr(args, flag):
            raise ValueError(f"no --{flag}: name it, resume a checkpoint "
                             "that carries it, or take a config "
                             "(--config_name NAME for configs/NAME.yaml)")

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
                        ("criterions", _names(args.criterions)),
                        ("embedders", [args.embedder]),
                        ("generators", [args.generator]),
                        ("discriminators", [args.discriminator])):
        for name in names:
            registry.load_wrapper(kind, name)   # raises for unknown names
    if args.gan_type not in GAN_TYPES:
        raise ValueError(f"--gan_type {args.gan_type!r}: one of "
                         f"{list(GAN_TYPES)}")
    if args.voxceleb1_crop_type not in ("x2face", "fabnet"):
        raise ValueError(f"--voxceleb1_crop_type "
                         f"{args.voxceleb1_crop_type!r}: x2face or fabnet")
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
    """A fresh meta-train state from ``args.random_seed``: the models' init
    (with the converted weights of a frozen dependency where found,
    ``runners/build.py``), the EMA equal to it, fresh optimizers; the
    discriminator has a row for each of the loader's identities."""
    if not args.num_labels:
        args.num_labels = dataloader.num_labels
    generator = torch.Generator().manual_seed(args.random_seed)
    models = build_models(args, generator=generator)
    build.overlay_pretrained(models)
    models = {k: m.to(device) for k, m in models.items()}
    state = TrainState(models=models, ema_params={
        part: ema_of(models[part]) for part in ("embedder", "generator")})
    state.opt_g, state.opt_d = ft.optimizers(state, args)
    logger.info("Meta-training from a seeded init (seed %d)",
                args.random_seed)
    return state


def load_checkpoint(args, device) -> TrainState:
    """The train state of ``args.checkpoint_path`` on ``device``, optimizers
    included: a meta-trained one (the discriminator with the checkpoint's
    ``num_labels``; X2Face's identity images where its "fine-tune" stored
    them) or a fine-tuned one (its one-row discriminator and per-avatar
    leaves)."""
    flat = ckpt_lib.load_arrays(args.checkpoint_path)
    finetuned = checkpoint_is_finetuned(args.checkpoint_path)
    embed = flat.get(ckpt_lib.SEP.join(("params", "discriminator", "embed",
                                        "embedding")))
    if embed is not None:       # the none discriminator has no rows
        args.num_labels = int(embed.shape[0])
    models = {part: registry.empty_net(kind, getattr(args, part), args,
                                       device)
              for part, kind in (("embedder", "embedders"),
                                 ("generator", "generators"),
                                 ("discriminator", "discriminators"))}
    leaves = {}
    if finetuned:
        models["discriminator"].embed = SNEmbed(1, embed.shape[1],
                                                sn_eps=1e-12).to(device)
        # the checkpoint's per-avatar leaves (finetune_embedding, or
        # FSTH's finetune_affine), filled by load_train_state
        leaves = {name: torch.zeros(flat[f"params{ckpt_lib.SEP}{name}"]
                                    .shape, device=device)
                  for name in FINETUNE_LEAVES
                  if f"params{ckpt_lib.SEP}{name}" in flat}
    images = flat.get(f"params{ckpt_lib.SEP}{convert.IDENTITY_IMAGES}")
    state = TrainState(models=models, ema_params={},
                       **{k: v.requires_grad_() for k, v in leaves.items()})
    if images is not None:
        state.finetune_identity_images = torch.zeros(images.shape,
                                                     device=device)
    state.ema_params.update({k: torch.zeros_like(v)
                             for k, v in leaves.items()})
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
    state = ft.enable_finetuning(
        state, args, e_hat, generator=generator,
        gen_wrapper=registry.load_wrapper("generators", args.generator))
    args.num_labels = 1
    return state


def store_identity_images(args, state, dataloader, device):
    """X2Face's "fine-tune" (its generator's ``FINETUNE_PARAM`` is 'none'):
    no step; the avatar is its first ``--X2Face_num_identity_images``
    images (``pose_input_rgbs`` of frame 0, f32, the uint8 wire divided),
    stored as ``finetune_identity_images`` (1, N, H, W, 3) in the state,
    which stays a meta-train one, and saved.  Under N ranks rank 0 reads a
    loader of the whole avatar (one process's).  Returns the path saved."""
    if parallel.initialized() and parallel.is_main():
        with parallel.local_view():
            dataloader = build_dataloader(args, "train", "train")
    wanted = int(args.X2Face_num_identity_images or 8)
    images = np.zeros((0, args.image_size, args.image_size, 3), np.float32)
    if parallel.is_main():
        collected = []
        for data_dict, _ in dataloader:
            data_dict = loop.dequantize_batch_host(data_dict)
            collected.append(np.asarray(data_dict["pose_input_rgbs"][:, 0]))
            if sum(len(c) for c in collected) >= wanted:
                break
        images = np.concatenate(collected)[:wanted]
        logger.info("Saving X2Face model with %d identity images",
                    len(images))
    state.finetune_identity_images = torch.from_numpy(
        np.ascontiguousarray(images[None], np.float32)).to(device)
    args.experiment_dir = str(Path(args.experiments_dir)
                              / (args.experiment_name or "x2face"))
    return save(args, state)


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
            path = ckpt_lib.save_checkpoint(
                args.experiment_dir, convert.export_train_state(state),
                vars(args), iteration=state.step, finetune=state.finetune)
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
    if args.finetune and getattr(state.models["generator"], "FINETUNE_PARAM",
                                 "embedding") == "none":
        return state, store_identity_images(args, state, train_loader, device)
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
