"""PyTorch port, argument resolution and the configs' reader
(``latentpose_tpu_torch/config/``) held against the JAX package's
``config/`` on the same command lines, checkpoints and files: the reader
against ``yaml.safe_load`` value for value, types included; the train
CLI's resolved args against ``get_args_and_modules`` (defaults < the
checkpoint's saved args < the ``--config_name`` config < custom args <
flags; an unnamed experiment named after the config; ``${VAR}``; a config
that names the checkpoint), types included; the flags each registry name
brings; the drive and export CLIs' levels; and ``--config_name synthetic``
training a step on the CPU."""

import functools
import shutil
from pathlib import Path

import numpy as np
import pytest
import yaml

from latentpose_tpu.config import build_core_parser, get_args_and_modules
from latentpose_tpu.config import resolution as jresolution
from latentpose_tpu_torch import checkpoint as tckpt
from latentpose_tpu_torch import config as tconfig
from latentpose_tpu_torch import registry
from latentpose_tpu_torch.cli import drive as tdrive
from latentpose_tpu_torch.cli import export as texport
from latentpose_tpu_torch.cli import train as tcli
from latentpose_tpu_torch.config import yaml_subset
from latentpose_tpu_torch.models.embedders import \
    unsupervised_pose_separate_embResNeXt_segmentation as tflagship
from latentpose_tpu_torch.nn import backbones as tbackbones

REPO = Path(__file__).resolve().parent.parent
NAMES = ["--generator", "vector_pose_unsupervised_segmentation_noBottleneck",
         "--embedder", "unsupervised_pose_separate_embResNeXt_segmentation",
         "--discriminator", "no_landmarks"]
# a run's saved args that differ from both configs and the defaults
SAVED = dict(
    generator=NAMES[1], embedder=NAMES[3], discriminator=NAMES[5],
    criterions="adversarial, featmat, dice", dataloader="synthetic",
    batch_size=4, image_size=32, num_channels=4, max_num_channels=16,
    embed_channels=16, pose_embedding_size=8, use_pixelwise_augs=False,
    use_affine_scale=True, lr_gen=1e-4, lr_dis=3e-4, num_labels=4,
    random_seed=7, num_workers=2, experiment_name="saved_run",
    config_name="default", fixed_val_ids=[1, 2], optimizer="Adam",
    runner="holycow")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")
    arrays = {"step": np.zeros((), np.int32)}
    meta = tckpt.save_checkpoint(root / "meta", arrays, SAVED, iteration=3,
                                 finetune=False)
    finetuned = tckpt.save_checkpoint(
        root / "ft", arrays, dict(SAVED, finetune=True, optimizer="RAdam",
                                  num_labels=1, experiment_name=""),
        iteration=5, finetune=True)
    return {"meta": str(meta), "finetuned": str(finetuned)}


CASES = {
    "fresh": [*NAMES, "--dataloader", "synthetic"],
    "fresh_default": ["--config_name", "default", "--dataloader",
                      "synthetic"],
    "fresh_default_flags": ["--config", "default", "--dataloader",
                            "synthetic", "--batch_size", "2",
                            "--no-use_affine_scale", "--lr_gen", "1e-3",
                            "--experiment_name", "mine",
                            "--fixed_val_ids", "7"],
    "resume_meta": ["--checkpoint_path", "meta"],
    "resume_meta_flags": ["--checkpoint_path", "meta", "--batch_size", "2",
                          "--use_pixelwise_augs"],
    "resume_meta_default": ["--checkpoint_path", "meta", "--config_name",
                            "default"],
    "resume_meta_default_flags": ["--checkpoint_path", "meta",
                                  "--config_name", "default",
                                  "--pose_embedding_size", "8",
                                  "--criterions", "adversarial, dice",
                                  "--no-use_affine_shift"],
    "finetune": ["--checkpoint_path", "meta", "--finetune"],
    "finetune_base": ["--checkpoint_path", "meta", "--finetune",
                      "--config_name", "finetuning-base"],
    "finetune_base_flags": ["--checkpoint_path", "meta", "--config_name",
                            "finetuning-base", "--lr_gen", "1e-3",
                            "--num_epochs", "3", "--no-use_pixelwise_augs",
                            "--dataloader", "synthetic"],
    "resume_finetuned": ["--checkpoint_path", "finetuned"],
    "resume_finetuned_base_flags": ["--checkpoint_path", "finetuned",
                                    "--config_name", "finetuning-base",
                                    "--batch_size", "2", "--fixed_val_ids",
                                    "3"],
    "fresh_synthetic": ["--config_name", "synthetic"],
    "fresh_synthetic_flags": ["--config_name", "synthetic", "--image_size",
                              "32", "--perc_weight", "0.05",
                              "--criterions", "adversarial, perceptual",
                              "--no_allow_random_vgg"],
    "resume_meta_synthetic": ["--checkpoint_path", "meta", "--config_name",
                              "synthetic", "--norm_layer", "in"],
    "missing_config": [*NAMES, "--dataloader", "synthetic",
                       "--config_name", "absent"],
    "module_flags": [*NAMES, "--dataloader", "synthetic", "--criterions",
                     "perceptual, idt_embed, dis_embed", "--runner",
                     "holycow", "--perc_weight", "0.05",
                     "--idt_embed_weight", "0.01", "--dis_embed_weight",
                     "0.2", "--norm_layer", "in", "--iteration", "7",
                     "--inference", "--in_channels", "3", "--num_labels",
                     "5"],
}


def _same(got, want):
    """The port's value is the JAX package's, of the same type (a number
    the JAX package holds as the YAML 1.1 string it read, ``'3e-2'``, where
    no selected plugin registers the arg, is that string in the port)."""
    return type(got) is type(want) and got == want


def _diff(got, want, keys):
    return {k: (got[k], want[k]) for k in keys if not _same(got[k], want[k])}


@pytest.mark.parametrize("case", sorted(CASES))
def test_args_resolve_as_the_jax_cli(checkpoints, case):
    argv = [checkpoints.get(a, a) for a in CASES[case]]
    jargs, _, _, _ = get_args_and_modules(
        build_core_parser(), argv=list(argv), configs_dir=REPO / "configs")
    targs = tcli.resolve_args(list(argv))
    want, got = vars(jargs), vars(targs)
    common = sorted(set(want) & set(got))
    assert len(common) >= 60
    diff = _diff(got, want, common)
    assert not diff, diff
    assert set(want) <= set(got)
    # the levels this case exercises
    if case.startswith("fresh_default") and "--experiment_name" not in argv:
        assert targs.experiment_name == "default"


def test_the_default_args_name_the_experiment_as_the_jax_cli(checkpoints):
    """Every level but the flags: what the experiment's automatic name is
    built from."""
    argv = ["--checkpoint_path", checkpoints["meta"], "--config_name",
            "finetuning-base", "--finetune", "--batch_size", "2"]
    _, jdefault, _, _ = get_args_and_modules(
        build_core_parser(), argv=list(argv), configs_dir=REPO / "configs")
    _, tdefault = tcli._resolve(list(argv))
    want, got = vars(jdefault), vars(tdefault)
    common = sorted(set(want) & set(got) - {"finetune", "checkpoint_path"})
    diff = _diff(got, want, common)
    assert not diff, diff
    assert tdefault.batch_size == SAVED["batch_size"]
    assert tdefault.optimizer == "RAdam"


def test_a_fresh_run_without_a_config_names_what_it_lacks():
    with pytest.raises(ValueError, match="--generator"):
        tcli.resolve_args(["--dataloader", "synthetic"])


# --- the reader ---------------------------------------------------------------

# YAML 1.1's traps: a float needs a dot and its exponent a sign; booleans
# and nulls by word; octal, hex, sexagesimal and underscores; quotes;
# comments after values; flow sequences
TRAPS = """\
perc_weight: 3e-2
lr_gen: 5e-4
idt_embed_weight: 0.6e-2
signed: 1.0e+5
unsigned: 1.0e5
dot: .5
neg_dot: -.5
inf: -.Inf
int: 42
octal: 010
not_octal: 09
hex: 0x1f
sexagesimal: 1:30
underscore: 1_000
yes_word: yes
on_word: On
true_word: True
lower_true: true
odd_case: tRue
tilde: ~
null_word: Null
empty:
plain: images-cropped  # a comment
hash_inside: a#b
single: 'it''s # not a comment'
double: "tab\\there \\u00e9"
double_comment: "/non/existent/file"  # assume images are cropped
list: [0]
lists: [1, 2.5, yes, null, 'x', "y", [3]]
trailing: [1, ]
empty_list: []
env: ${LATENTPOSE_TEST_VAR}/sub
"""


@pytest.mark.parametrize("name", ["default", "finetuning-base", "synthetic",
                                  "traps"])
def test_reader_equals_yaml_safe_load(name):
    text = TRAPS if name == "traps" else \
        (REPO / "configs" / f"{name}.yaml").read_text()
    want, got = yaml.safe_load(text), yaml_subset.safe_load(text)
    assert list(got) == list(want)
    for key, value in want.items():
        assert type(got[key]) is type(value), key
        assert repr(got[key]) == repr(value), key
    if name == "traps":
        assert got["perc_weight"] == "3e-2" and got["signed"] == 1e5


@pytest.mark.parametrize("text", ["a:\n  b: 1", "- a", "a: {b: 1}",
                                  "a: &x 1", "a: 2001-12-14", "a: [1",
                                  "a: 'open", "a: b: c", "a: |\n  x"])
def test_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        yaml_subset.safe_load(text)


@pytest.mark.parametrize("name", ["default", "finetuning-base", "synthetic"])
def test_configs_load_as_the_jax_package(name, monkeypatch):
    monkeypatch.setenv("LATENTPOSE_TEST_VAR", "x")
    assert tconfig.load_yaml_config(name, REPO / "configs") == \
        jresolution.load_yaml_config(name, REPO / "configs")


# --- ${VAR}, a config that names the checkpoint, custom args -----------------

def _both(argv, configs, custom=None):
    jargs, _, _, _ = get_args_and_modules(
        build_core_parser(), argv=list(argv), configs_dir=configs,
        custom_args=custom)
    targs = tcli.resolve_args(list(argv), custom_args=custom)
    return vars(jargs), vars(targs)


@pytest.mark.parametrize("flags", [[], ["--batch_size", "2"]])
@pytest.mark.parametrize("custom", [None, {"lr_gen": "2e-3",
                                           "experiment_name": "custom"}])
def test_env_vars_and_a_config_that_names_the_checkpoint(
        checkpoints, tmp_path, monkeypatch, flags, custom):
    """A config under the working directory's ``configs/`` with ``${VAR}``
    values and a ``checkpoint_path`` (resolution's pass 2), with and
    without flags and custom args above it."""
    configs = tmp_path / "configs"
    configs.mkdir()
    (configs / "mine.yaml").write_text(
        "checkpoint_path: ${LATENTPOSE_CKPT}\n"
        "data_root: ${LATENTPOSE_TEST_VAR}/data  # expanded\n"
        "lr_dis: 8e-4\nnum_workers: 2\nfixed_val_ids: [3]\n")
    monkeypatch.setenv("LATENTPOSE_CKPT", checkpoints["meta"])
    monkeypatch.setenv("LATENTPOSE_TEST_VAR", "/srv")
    monkeypatch.chdir(tmp_path)
    want, got = _both(["--config_name", "mine", *flags], configs, custom)
    diff = _diff(got, want, sorted(want))
    assert not diff, diff
    assert got["checkpoint_path"] == checkpoints["meta"]
    assert got["data_root"] == "/srv/data" and got["lr_dis"] == 8e-4
    assert got["batch_size"] == (2 if flags else SAVED["batch_size"])
    if custom:
        assert got["lr_gen"] == 2e-3 and got["experiment_name"] == "custom"


# --- the flags ------------------------------------------------------------------

def _selecting(kind, name):
    flag = {"embedders": "--embedder", "generators": "--generator",
            "discriminators": "--discriminator", "criterions": "--criterions",
            "metrics": "--metrics", "dataloaders": "--dataloader"}[kind]
    base = dict(zip(NAMES[::2], NAMES[1::2]))
    base["--dataloader"] = "synthetic"
    base["--runner"] = "holycow"
    base[flag] = name
    return [a for kv in base.items() for a in kv]


@pytest.mark.parametrize("kind,name", [
    (kind, name) for kind in ("embedders", "generators", "discriminators",
                              "criterions", "metrics", "dataloaders")
    for name in registry.names(kind)])
def test_every_flag_of_the_jax_train_cli_is_accepted(kind, name):
    """The JAX train CLI's parser after resolution with ``name`` selected
    (its core flags and every selected plugin's) holds no flag that the
    port's lacks; each one parses in the port."""
    argv = _selecting(kind, name)
    jparser, tparser = build_core_parser(), tcli.build_parser()
    get_args_and_modules(jparser, argv=list(argv),
                         configs_dir=REPO / "configs")
    tconfig.get_args_and_modules(tparser, argv=list(argv))
    jflags, tflags = (set(p._option_string_actions) for p in (jparser,
                                                               tparser))
    assert jflags <= tflags, sorted(jflags - tflags)
    assert {"--device"} <= tflags - jflags


def test_a_flag_the_selection_does_not_register_is_refused_as_in_jax():
    argv = [*NAMES, "--dataloader", "synthetic", "--criterions",
            "adversarial", "--perc_weight", "0.05"]
    with pytest.raises(SystemExit):
        get_args_and_modules(build_core_parser(), argv=list(argv),
                             configs_dir=REPO / "configs")
    with pytest.raises(SystemExit):
        tcli.resolve_args(list(argv))


def test_the_runner_flags_need_no_runner_named():
    """The port's one runner registers its flags whatever the selection
    (a resumed checkpoint that names no runner takes ``--transfer_dtype``);
    an arg no selected plugin registers takes the first registering
    plugin's default."""
    args = tcli.resolve_args([*NAMES, "--dataloader", "synthetic",
                              "--criterions", "adversarial",
                              "--transfer_dtype", "uint8",
                              "--grad_accum_steps", "2"])
    assert (args.runner, args.transfer_dtype, args.grad_accum_steps) == \
        ("", "uint8", 2)
    defaults = tconfig.plugin_defaults()
    assert args.perc_weight == defaults["perc_weight"] == 1e-2
    assert args.l1_weight == defaults["l1_weight"] == 30.0
    assert defaults["gen_num_residual_blocks"] == 2


def test_module_flags_train_as_the_jax_cli_reads_them():
    args = tcli.resolve_args(CASES["module_flags"])
    assert (args.perc_weight, args.idt_embed_weight, args.dis_embed_weight,
            args.iteration, args.num_labels, args.inference) == \
        (0.05, 0.01, 0.2, 7, 5, True)


# --- drive and export -----------------------------------------------------------

def _jax_inference_parser(what):
    """The JAX drive or export CLI's parser, as its ``main`` builds it."""
    parser = build_core_parser()
    if what == "drive":
        parser.add("--images_paths", type=str, nargs="+", default=[])
        parser.add("--destination", type=str, default="driving_results")
        parser.add("--drive_batch_size", type=int, default=32)
        parser.add("--crop", action="store_bool", default=False)
        parser.add("--quantize", type=str, default="",
                   choices=["", "int8", "int8_static"])
        parser.add("--calibration_frames", type=int, default=64)
    else:
        parser.add("--destination", type=str, default="")
        parser.add("--export_batch_size", type=int, default=32)
        parser.add("--transfer_dtype", type=str, default="uint8",
                   choices=["uint8", "float32"])
        parser.add("--platforms", type=str, default="")
        parser.add("--quantize", type=str, default="",
                   choices=["", "int8", "int8_static"])
        parser.add("--calibration_source", type=str,
                   default="synthetic://0")
        parser.add("--calibration_frames", type=int, default=64)
    return parser


@pytest.mark.parametrize("config", [[], ["--config_name", "synthetic"]])
@pytest.mark.parametrize("what", ["drive", "export"])
def test_drive_and_export_resolve_as_the_jax_clis(checkpoints, what, config):
    """The checkpoint positional, the saved args, ``--config_name`` and the
    flags, as the JAX CLIs resolve them before their inference overrides
    (drive's data root positional too)."""
    extra = ["DATA"] if what == "drive" else []
    argv = [checkpoints["finetuned"], *extra, *config, "--batch_size", "3",
            "--compute_dtype", "float32"]
    jargv = ["--checkpoint_path", argv[0]] + (
        ["--data_root", "DATA"] if extra else []) + argv[1 + len(extra):]
    jargs, _, _, _ = get_args_and_modules(
        _jax_inference_parser(what), argv=jargv, configs_dir=REPO / "configs")
    module = tdrive if what == "drive" else texport
    targs = module.resolve_args([*argv, "--device", "cpu"])
    want = vars(jargs)
    for key in ("finetune", "inference", "num_devices", "platforms",
                "calibration_source"):
        want.pop(key, None)
    diff = _diff(vars(targs), want, sorted(want))
    assert not diff, diff
    assert targs.finetune and targs.inference
    assert targs.image_size == (64 if config else SAVED["image_size"])


# --- --config_name synthetic trains ---------------------------------------------

def test_synthetic_config_trains_a_step_on_the_cpu(tmp_path, monkeypatch):
    """``configs/synthetic.yaml``, read without yaml, trains: tiny widths,
    the identity tower cut to one bottleneck a stage, one step."""
    monkeypatch.setattr(tflagship, "ResNeXt50", functools.partial(
        tbackbones.ResNeXt50, layers=(1, 1, 1, 1)))
    monkeypatch.chdir(REPO)
    state, path = tcli.main([
        "--config_name", "synthetic", "--device", "cpu", "--image_size",
        "32", "--num_channels", "4", "--max_num_channels", "16",
        "--embed_channels", "16", "--pose_embedding_size", "8",
        "--dis_num_blocks", "3", "--gen_num_residual_blocks", "1",
        "--batch_size", "2", "--synthetic_num_labels", "2",
        "--num_enc_frames", "2", "--experiments_dir", str(tmp_path)])
    try:
        assert state.step == 1 and path.exists()
        args = tckpt.peek_args(path)
        assert args["config_name"] == "synthetic" and \
            args["experiment_name"] == "synthetic"
        assert args["criterions"] == "adversarial, featmat, dice"
        assert args["allow_random_vgg"] is True
        assert np.isfinite(tckpt.load_arrays(path)[
            "params::generator::projector_1::kernel"]).all()
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
