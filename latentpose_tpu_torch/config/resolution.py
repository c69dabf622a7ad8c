"""Five-level argument resolution (port of ``latentpose_tpu/config/
resolution.py``), lowest to highest priority:

    1. argparse defaults (the core parser's and each selected plugin's)
    2. the args saved inside ``--checkpoint_path``
    3. ``configs/<config_name>.yaml`` (``${VAR}`` expanded)
    4. ``custom_args`` passed by a caller
    5. the command line

as the same multi-pass parse: the first passes learn ``--config_name`` and
``--checkpoint_path`` (which the config may name), the levels are folded in
through ``parser.set_defaults``, the selected plugins register their own
args (:data:`PLUGIN_ARGS`, the JAX plugins' ``get_args``), and a final
parse puts the command line on top.  argparse converts a string default
through its option's ``type``, so the config's ``lr_gen: 5e-4``, which YAML
1.1 reads as the string ``'5e-4'``, becomes a float where an option owns
``lr_gen`` and stays a string where none does, as in the JAX package.

The configs are read by :mod:`yaml_subset`, not yaml, which the card's
path must not import.
"""

from __future__ import annotations

import copy
import logging
import os
from pathlib import Path

from latentpose_tpu_torch import checkpoint as ckpt_lib
from latentpose_tpu_torch import registry
from latentpose_tpu_torch.config import yaml_subset
from latentpose_tpu_torch.config.argparse_utils import MyArgumentParser

logger = logging.getLogger("latentpose_tpu_torch.config")

# (kind, the flag that names it), in the JAX package's order
MODULE_KINDS = (("embedders", "embedder"), ("generators", "generator"),
                ("discriminators", "discriminator"),
                ("criterions", "criterions"), ("metrics", "metrics"),
                ("dataloaders", "dataloader"), ("runners", "runner"))
LISTS = ("criterions", "metrics")


def _augmentation(parser):
    parser.add("--use_pixelwise_augs", action="store_bool", default=False)
    parser.add("--use_affine_scale", action="store_bool", default=False)
    parser.add("--use_affine_shift", action="store_bool", default=False)


def _voxceleb(crop_type=False):
    def get_args(parser):
        parser.add("--draw_oval", default=True, action="store_bool")
        parser.add("--n_frames_for_encoder", default=8, type=int)
        if crop_type:
            parser.add("--voxceleb1_crop_type", default="x2face",
                       help="x2face|fabnet")
        _augmentation(parser)
    return get_args


def _synthetic(parser):
    parser.add("--num_enc_frames", type=int, default=8)
    parser.add("--synthetic_num_labels", type=int, default=16)
    parser.add("--synthetic_frames_per_video", type=int, default=32)
    parser.add("--synthetic_stickmen", action="store_bool", default=False)
    _augmentation(parser)


def _holycow(parser):
    parser.add("--iteration", type=int, default=0)
    parser.add("--log_frequency_loss", type=int, default=1)
    parser.add("--log_frequency_images", type=int, default=100)
    parser.add("--log_frequency_fixed_images", type=int, default=2500)
    parser.add("--detailed_metrics", action="store_bool", default=True)
    parser.add("--num_visuals_per_img", default=2, type=int)
    parser.add("--fixed_val_ids", action="append", type=int,
               default=[50, 100, 200, 250, 300])
    parser.add("--batch_size_inference", default=5, type=int)
    parser.add("--grad_accum_steps", default=1, type=int)
    parser.add("--transfer_dtype", type=str, default="float32",
               help="float32|uint8")
    parser.add("--grad_dtype", type=str, default="float32",
               help="float32|bfloat16")
    parser.add("--explicit_grad_reduce", action="store_bool", default=False)


def _args(*specs):
    """A ``get_args`` adding (flag, kwargs) pairs."""
    def get_args(parser):
        for flag, kwargs in specs:
            parser.add(flag, **kwargs)
    return get_args


_SUM = ("--average_function", dict(type=str, default="sum"))
_EMBED = (("--embed_padding", dict(type=str, default="zero")),
          ("--embed_num_blocks", dict(type=int, default=6)), _SUM)
_DIS = (("--dis_padding", dict(type=str, default="zero")),
        ("--dis_num_blocks", dict(type=int, default=7)),
        ("--lr_dis", dict(type=float, default=2e-4)))
_GEN = (("--gen_constant_input_size", dict(type=int, default=4)),
        ("--gen_num_residual_blocks", dict(type=int, default=2)),
        ("--gen_padding", dict(type=str, default="zero")),
        ("--norm_layer", dict(type=str, default="in")))

# every plugin's own args, as the JAX plugin's Wrapper.get_args adds them
PLUGIN_ARGS = {
    "embedders": {
        "unsupervised_pose_separate_embResNeXt_segmentation": _args(_SUM),
        "FSTH": _args(*_EMBED), "no_pose_encoder": _args(*_EMBED),
        "simple_conv": _args(_SUM, ("--simple_embedder_width",
                                    dict(type=int, default=32))),
        "X2Face": _args(),
        "X2Face_pretrained_embResNeXt": _args(_SUM),
        "FAbNet_pretrained_embResNeXt": _args(_SUM)},
    "generators": {
        "vector_pose_unsupervised_segmentation_noBottleneck": _args(*_GEN),
        "FSTH_plus": _args(*_GEN),
        "FSTH": _args(("--gen_padding", dict(type=str, default="zero")),
                      ("--gen_num_downsample_blocks",
                       dict(type=int, default=4)),
                      ("--gen_num_residual_blocks",
                       dict(type=int, default=4)),
                      ("--norm_layer", dict(type=str, default="in"))),
        "X2Face": _args(("--X2Face_num_identity_images",
                         dict(type=int, default=1)))},
    "discriminators": {"no_landmarks": _args(*_DIS), "FSTH": _args(*_DIS),
                       "none": _args()},
    "criterions": {
        "adversarial": _args(("--gan_type", dict(type=str, default="gan",
                                                 help="gan|rgan|ragan"))),
        "featmat": _args(("--fm_weight", dict(type=float, default=10.0))),
        "idt_embed": _args(("--idt_embed_weight",
                            dict(type=float, default=2e-3))),
        "perceptual": _args(("--perc_weight",
                             dict(type=float, default=1e-2))),
        "dice": _args(("--dice_weight", dict(type=float, default=1))),
        "dis_embed": _args(("--dis_embed_weight",
                            dict(type=float, default=1e-2))),
        "l1_rgb": _args(("--l1_weight", dict(type=float, default=30.0)))},
    "metrics": {"psnr": _args(), "segmentation_iou": _args()},
    "dataloaders": {
        "synthetic": _synthetic,
        "voxceleb2_segmentation_nolandmarks": _voxceleb(),
        "voxceleb2": _voxceleb(), "voxceleb2_segm": _voxceleb(),
        "voxceleb2_FSTH_crop": _voxceleb(),
        "voxceleb2_X2Face": _voxceleb(crop_type=True),
        "voxceleb2_segmentation_nolandmarks_X2Face_FAbNet_crops":
            _voxceleb(crop_type=True)},
    "runners": {"holycow": _holycow},
}


def plugin_defaults() -> dict:
    """{arg: default} of every plugin's args, the first plugin of
    :data:`PLUGIN_ARGS` to register an arg giving its default: the value an
    entry point takes for an arg that the run's selection does not
    register."""
    defaults = {}
    for names in PLUGIN_ARGS.values():
        for get_args in names.values():
            scratch = MyArgumentParser(add_help=False)
            get_args(scratch)
            for action in scratch._actions:
                defaults.setdefault(action.dest, action.default)
    return defaults


def add_plugin_args(parser, kind: str, name: str):
    """Plugin ``name`` of ``kind`` registers its args on ``parser``, once:
    a plugin that an entry point registers itself is not registered
    again when the run selects it."""
    added = parser.__dict__.setdefault("plugins_added", set())
    if (kind, name) not in added:
        plugin_get_args(kind, name)(parser)
        added.add((kind, name))


def plugin_get_args(kind: str, name: str):
    """The ``get_args`` of plugin ``name`` of ``kind``."""
    names = PLUGIN_ARGS[kind]
    if name not in names:
        known = registry.names(kind) if kind != "runners" else list(names)
        raise ValueError(f"Unknown {kind[:-1]} {name!r}: the registry has "
                         f"{list(known)}")
    return names[name]


def _expand_env(value):
    if isinstance(value, str):
        return os.path.expandvars(value)
    if isinstance(value, dict):
        return {k: _expand_env(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_expand_env(v) for v in value]
    return value


def load_yaml_config(config_name: str, configs_dir="configs"):
    """``configs_dir/<config_name>.yaml`` as ``yaml.safe_load`` reads it,
    with ``${VAR}`` expanded."""
    text = (Path(configs_dir) / f"{config_name}.yaml").read_text()
    return _expand_env(yaml_subset.safe_load(text) or {})


def get_args_and_modules(parser, use_checkpoint_args=True, custom_args=None,
                         configs_dir="configs", argv=None):
    """The JAX package's multi-pass parse over ``parser`` (the core parser
    and the entry point's own flags).  Returns ``(args, default_args,
    plugins, checkpoint_args)``: ``plugins`` maps each kind to the selected
    name (a list for criterions and metrics; None or [] where none is
    named), ``default_args`` is the parse of an empty command line (what
    an experiment's automatic name is made from)."""
    custom_args = dict(custom_args or {})
    if custom_args:
        parser.set_defaults(**custom_args)

    args, _ = parser.parse_known_args(argv)
    yaml_cfg = {}
    if getattr(args, "config_name", ""):
        try:
            yaml_cfg = load_yaml_config(args.config_name, configs_dir)
        except FileNotFoundError:
            logger.warning("Could not load config %s", args.config_name)
    parser.set_defaults(**yaml_cfg)
    if custom_args:
        parser.set_defaults(**custom_args)

    args, _ = parser.parse_known_args(argv)
    checkpoint_args = None
    if use_checkpoint_args and getattr(args, "checkpoint_path", ""):
        try:
            checkpoint_args = ckpt_lib.peek_args(args.checkpoint_path)
        except FileNotFoundError:
            logger.warning("Checkpoint %s not found; ignoring its args",
                           args.checkpoint_path)
    if checkpoint_args:
        parser.set_defaults(**checkpoint_args)
    parser.set_defaults(**yaml_cfg)
    if custom_args:
        parser.set_defaults(**custom_args)

    args, _ = parser.parse_known_args(argv)
    plugins = {}
    for kind, flag in MODULE_KINDS:
        value = getattr(args, flag, "") or ""
        names = [n.strip() for n in value.split(",") if n.strip()] \
            if kind in LISTS else [value] if value else []
        for name in names:
            add_plugin_args(parser, kind, name)
        plugins[kind] = names if kind in LISTS else (names or [None])[0]

    # levels 2-4 again, over the plugins' own defaults
    if checkpoint_args:
        parser.set_defaults(**checkpoint_args)
    parser.set_defaults(**yaml_cfg)
    if custom_args:
        parser.set_defaults(**custom_args)

    default_args = copy.deepcopy(parser.parse_args([]))
    args = parser.parse_args(argv)
    if not getattr(args, "experiment_name", ""):
        args.experiment_name = args.config_name
    return args, default_args, plugins, checkpoint_args
