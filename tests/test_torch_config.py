"""PyTorch port, the train CLI's argument resolution held against the JAX
package's ``get_args_and_modules`` (``latentpose_tpu/config/resolution.py``)
on the same command lines and checkpoints: defaults < the checkpoint's
saved args < the ``--config_name`` config (read only when named) < flags,
and an unnamed experiment named after the config.  Fresh and resumed runs,
meta-trained and fine-tuned checkpoints, with and without a config, with
flags above both.  The port carries the two configs as dicts; another name
is refused."""

from pathlib import Path

import numpy as np
import pytest

from latentpose_tpu.config import build_core_parser, get_args_and_modules
from latentpose_tpu_torch import checkpoint as tckpt
from latentpose_tpu_torch.cli import train as tcli

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
}


def _same(got, want):
    """The port's value against the JAX package's: paths as paths (the JAX
    parser types them ``Path``, the port keeps strings); a number the JAX
    package holds as the YAML 1.1 string it read (``3e-2``) where no
    selected plugin registers the arg to convert it."""
    if isinstance(want, Path):
        return Path(got) == want
    if isinstance(want, str) and isinstance(got, float):
        return float(want) == got
    if isinstance(want, tuple):
        want = list(want)
    return got == want


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
    # the levels this case exercises
    if "--config_name" in argv or "--config" in argv:
        assert targs.perc_weight == (3e-2 if "default" in argv else 1e-2) \
            or "checkpoint_path" in argv
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


def test_other_configs_are_refused_naming_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="A.21"):
        tcli.resolve_args(["--config_name", "synthetic", "--dataloader",
                           "synthetic"])


def test_a_fresh_run_without_a_config_names_what_it_lacks():
    with pytest.raises(ValueError, match="--generator"):
        tcli.resolve_args(["--dataloader", "synthetic"])
