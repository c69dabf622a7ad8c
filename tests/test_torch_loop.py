"""PyTorch port, the training loop on a VoxCeleb2-layout tree held against
the JAX package: ``run_epoch``'s steps, the EMA eval forward, validation,
ê from a fine-tune directory, the meter, saver, visual grid, experiment
name and PNG writer; save-on-signal in a subprocess of the CLI; checkpoints
crossing between the two CLIs on the tree.  The JAX package's C++ loader
comes from a private build (``tests/test_torch_data.py``
:func:`private_jax_loader`).

Small sizes on the CPU, as ``tests/test_torch_metatrain.py`` has them: 32²
frames, K=2, a tiny generator and discriminator, both embedder towers cut to
one block a stage, dropout as the identity in both packages (their masks
cannot match across frameworks) and augmentation off.  Both loops read the
same batches: the JAX dataset's frame draw is seeded as the port's
per-sample ``random.Random`` (:func:`frame_key`), and its driver frame and
mask, which it crops with cv2, are taken from the port's C++ crop (the two
crops are held to each other in ``tests/test_torch_data.py``).  Bounds: the
first step's losses within 1e-4 relative (f32, sums in another order than
XLA's), the second step's within the meta-train drift bound of
``tests/test_torch_metatrain.py``; the eval forward within 1e-4; ê within
1e-5 of its largest entry.
"""

import functools
import json
import os
import random
import signal
import subprocess
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import jax
import flax.linen
import torch
from flax import serialization

from latentpose_tpu import checkpoint as jckpt
from latentpose_tpu.checkpoint import _flatten
from latentpose_tpu.cli import train as jtrain_cli
from latentpose_tpu.data import pipeline as jpipeline
from latentpose_tpu.data import voxceleb2_segmentation_nolandmarks as jds
from latentpose_tpu.losses import adversarial as jadv
from latentpose_tpu.losses import dice as jdice
from latentpose_tpu.losses import dis_embed as jdis_embed
from latentpose_tpu.losses import featmat as jfeatmat
from latentpose_tpu.losses import idt_embed as jidt
from latentpose_tpu.losses import perceptual as jperc
from latentpose_tpu.metrics import psnr as jpsnr
from latentpose_tpu.metrics import segmentation_iou as jiou
from latentpose_tpu.models.discriminators import no_landmarks as jdis_mod
from latentpose_tpu.models.embedders import (
    unsupervised_pose_separate_embResNeXt_segmentation as jemb_mod)
from latentpose_tpu.models.generators import (
    vector_pose_unsupervised_segmentation_noBottleneck as jgen_mod)
from latentpose_tpu.nn import backbones as jbackbones
from latentpose_tpu.runners import build
from latentpose_tpu.runners import finetune as jft
from latentpose_tpu.runners import holycow as jholycow
from latentpose_tpu.runners import loop as jloop
from latentpose_tpu.utils import logging_writer as jlog
from latentpose_tpu.utils import meter as jmeter
from latentpose_tpu.utils import saver as jsaver
from latentpose_tpu.utils import visualize as jvis
from latentpose_tpu_torch.cli import train as tcli
from latentpose_tpu_torch.data import native_loader as tnative
from latentpose_tpu_torch.data import voxceleb2_segmentation_nolandmarks as tds
from latentpose_tpu_torch.data.synthetic import render_face
from latentpose_tpu_torch.losses.common.perceptual_loss import (
    load_tower_arrays)
from latentpose_tpu_torch.models.embedders import (
    unsupervised_pose_separate_embResNeXt_segmentation as temb_mod)
from latentpose_tpu_torch.nn import backbones as tbackbones
from latentpose_tpu_torch.runners import finetune as tft
from latentpose_tpu_torch.runners import holycow as tholycow
from latentpose_tpu_torch.runners import loop as tloop
from latentpose_tpu_torch.utils import logging_writer as tlog
from latentpose_tpu_torch.utils import meter as tmeter
from latentpose_tpu_torch.utils import saver as tsaver
from latentpose_tpu_torch.utils import visualize as tvis
from latentpose_tpu_torch.utils.png import encode_png, write_png
from test_torch_data import private_jax_loader  # noqa: F401 (autouse)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
IMG = 32
K = 2
LAYERS = (1, 1, 1, 1)
CPU = torch.device("cpu")
IDENTITIES = 4
FRAMES = 6
LOSS_RTOL = 1e-4
DRIFT_LOSS_RTOL = 5e-3      # tests/test_torch_metatrain.py's, two steps on
# the loop's parity runs without the VGG criteria (held with them, step by
# step, in tests/test_torch_metatrain.py): XLA compiles it in a third of the
# time
LOOP_CRITERIA = "adversarial, featmat, dis_embed, dice"
JAX_CRITERIA = {"adversarial": jadv, "featmat": jfeatmat, "idt_embed": jidt,
                "perceptual": jperc, "dice": jdice, "dis_embed": jdis_embed}
MODULES = {"embedders": jemb_mod, "generators": jgen_mod,
           "discriminators": jdis_mod}
# the port's CLI with both towers cut as this module cuts them, in a
# subprocess (the cut is a monkeypatch of this process)
CLI_WITH_SHALLOW_TOWERS = f"""
import functools, sys
from latentpose_tpu_torch.cli import train
from latentpose_tpu_torch.models.embedders import (
    unsupervised_pose_separate_embResNeXt_segmentation as emb)
from latentpose_tpu_torch.nn import backbones
backbones.MobileNetV2.SETTINGS = tuple(
    (t, c, 1, s) for t, c, _, s in backbones.MobileNetV2.SETTINGS)
emb.ResNeXt50 = functools.partial(backbones.ResNeXt50, layers={LAYERS})
train.main(sys.argv[1:])
"""


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """4 identities x 1 video x 6 frames (rendered faces, 40² PNG, written
    with the port's PNG writer), masks, boxes for two of the videos,
    train.csv (4 videos) and val.csv (2)."""
    root = tmp_path_factory.mktemp("voxloop")
    bboxes, rows = {}, []
    for i in range(IDENTITIES):
        ident, video = f"id{i:05d}", "video0"
        for sub in ("images-cropped", "segmentation-cropped"):
            (root / sub / ident / video).mkdir(parents=True)
        boxes = []
        for f in range(FRAMES):
            img, segm = render_face(i, 5 * f, 40)
            write_png(root / "images-cropped" / ident / video
                      / f"{f:05d}.png", (img * 255 + 0.5).astype(np.uint8))
            write_png(root / "segmentation-cropped" / ident / video
                      / f"{f:05d}.png",
                      (segm[..., 0] * 255 + 0.5).astype(np.uint8))
            boxes.append([60 + 4 * f, 50, 190 + 4 * f, 186])
        if i % 2 == 0:
            bboxes[ident] = {video: np.array(boxes, np.float32)}
        rows.append(f"{ident}/{video}")
    np.save(root / "bboxes.npy", bboxes, allow_pickle=True)
    (root / "train.csv").write_text("path\n" + "\n".join(rows) + "\n")
    (root / "val.csv").write_text("path\n" + "\n".join(rows[1:3]) + "\n")
    return root


class _NoDropout:
    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x, *args, **kwargs):
        return x


@pytest.fixture(scope="module", autouse=True)
def _shallow_towers_no_dropout_same_batches():
    """Both packages' towers cut to one block a stage, dropout as the
    identity, and the JAX dataset reading the port's batches (module
    docstring), for this module's tests."""
    short = tuple((t, c, 1, s) for t, c, _, s in
                  jbackbones.MobileNetV2.SETTINGS)
    port_crops = {}
    lock = threading.Lock()
    getitem = jds.VoxCeleb2SegmDataset.__getitem__
    batch_iter = jpipeline.BatchLoader.__iter__

    def load_sample(self, path, i, imsize, load_image=False,
                    load_segmentation=False, **_):
        crops = port_crops.setdefault(
            id(self), tds.SegmSampleLoader(self.data_root, self.img_dir,
                                           self.segm_dir, self.bboxes_dir))
        return crops.load_sample(path, i, imsize, load_image,
                                 load_segmentation)

    def seeded_getitem(self, index):
        with lock:      # the frame draw reads the global random
            random.seed(tds.frame_key(self.seed, self.epoch, int(index)))
            return getitem(self, index)

    def iter_with_epoch(self):
        self.dataset.seed, self.dataset.epoch = self.seed, self.epoch
        return batch_iter(self)

    with pytest.MonkeyPatch.context() as mp:
        for cls in (jbackbones.MobileNetV2, tbackbones.MobileNetV2):
            mp.setattr(cls, "SETTINGS", short)
        mp.setattr(jemb_mod, "ResNeXt50", functools.partial(
            jbackbones.ResNeXt50, layers=LAYERS))
        mp.setattr(temb_mod, "ResNeXt50", functools.partial(
            tbackbones.ResNeXt50, layers=LAYERS))
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        mp.setattr(tbackbones, "_dropout", lambda x, rate, generator=None: x)
        mp.setattr(jds.SegmSampleLoader, "load_sample", load_sample)
        mp.setattr(jds.VoxCeleb2SegmDataset, "__getitem__", seeded_getitem)
        mp.setattr(jpipeline.BatchLoader, "__iter__", iter_with_epoch)
        init = jds.SegmSampleLoader.__init__

        def keep_bboxes_dir(self, *args, **kwargs):
            init(self, *args, **kwargs)
            self.bboxes_dir = kwargs.get("bboxes_dir")

        mp.setattr(jds.SegmSampleLoader, "__init__", keep_bboxes_dir)
        yield


def _meta_args(tree):
    return types.SimpleNamespace(
        generator="vector_pose_unsupervised_segmentation_noBottleneck",
        embedder="unsupervised_pose_separate_embResNeXt_segmentation",
        discriminator="no_landmarks",
        dataloader="voxceleb2_segmentation_nolandmarks",
        criterions="idt_embed, perceptual, adversarial, featmat, dis_embed, "
                   "dice",
        image_size=IMG, in_channels=3, out_channels=3, num_channels=4,
        max_num_channels=16, embed_channels=16, pose_embedding_size=8,
        gen_padding="zero", gen_constant_input_size=4,
        gen_num_residual_blocks=1, norm_layer="in", dis_padding="zero",
        dis_num_blocks=3, num_labels=IDENTITIES, optimizer="Adam",
        lr_gen=5e-5, lr_dis=2e-4, beta1=0.0, average_function="sum",
        finetune=False, iteration=0, set_eval_mode_in_train=False,
        batch_size=2, random_seed=0, compute_dtype="float32",
        num_devices=1, gan_type="gan", fm_weight=10.0, perc_weight=3e-2,
        idt_embed_weight=0.6e-2, dis_embed_weight=1e-2, dice_weight=1.0,
        vgg_weights_dir="/nonexistent", allow_random_vgg=True,
        weights_running_average=True, grad_accum_steps=1,
        use_pixelwise_augs=False, use_affine_scale=False,
        use_affine_shift=False, data_root=str(tree),
        img_dir="images-cropped", segm_dir="segmentation-cropped",
        kp_dir="keypoints-cropped", bboxes_dir=str(tree / "bboxes.npy"),
        train_split_path=str(tree / "train.csv"),
        val_split_path=str(tree / "val.csv"), n_frames_for_encoder=K,
        num_workers=1, prefetch_size=4)


class _JitInit:
    def __init__(self, module):
        self._module = module
        self.init = jax.jit(module.init)

    def __getattr__(self, name):
        return getattr(self._module, name)


def _jax_models(args):
    return {"embedder": jemb_mod.Wrapper.get_net(args),
            "generator": jgen_mod.Wrapper.get_net(args),
            "discriminator": jdis_mod.Wrapper.get_net(args)}


def _jax_flat(state):
    return _flatten(serialization.to_state_dict(jax.device_get(state)))


@pytest.fixture(scope="module")
def meta(tree, tmp_path_factory):
    """A JAX meta-trained state (weights, EMA and BatchNorm statistics off
    their init, the generator's constant drawn from a normal as
    ``tests/test_torch_metatrain.py`` does) and its checkpoint."""
    args = _meta_args(tree)
    opt_g, opt_d = build.build_optimizers(args, MODULES)
    state = build.init_train_state(
        args, {k: _JitInit(m) for k, m in _jax_models(args).items()}, opt_g,
        opt_d, jax.random.PRNGKey(0))
    rng = np.random.RandomState(7)

    def jitter(scale, low=None):
        def f(v):
            v = np.asarray(v)
            if low is not None:
                return rng.uniform(low, low + scale, v.shape).astype(v.dtype)
            return v + rng.uniform(-scale, scale, v.shape).astype(v.dtype)
        return f

    params = jax.tree_util.tree_map(jitter(0.02), state.params)
    params["generator"]["constant"] = rng.standard_normal(
        params["generator"]["constant"].shape).astype(np.float32)
    state = state.replace(
        params=params,
        ema_params=jax.tree_util.tree_map(jitter(0.05), state.ema_params),
        batch_stats=jax.tree_util.tree_map(jitter(1.0, 0.5),
                                           state.batch_stats))
    path = jckpt.save_checkpoint(tmp_path_factory.mktemp("jax_meta"), state,
                                 args)
    return state, path


def _data_flags(tree):
    return ["--dataloader", "voxceleb2_segmentation_nolandmarks",
            "--data_root", str(tree), "--train_split_path",
            str(tree / "train.csv"), "--val_split_path",
            str(tree / "val.csv"), "--bboxes_dir", str(tree / "bboxes.npy"),
            "--n_frames_for_encoder", str(K), "--num_workers", "1",
            "--device", "cpu", "--allow_random_vgg",
            "--no-use_pixelwise_augs", "--no-use_affine_scale",
            "--no-use_affine_shift"]


def _tower_arrays(jax_criterion):
    crit = getattr(jax_criterion, "perceptual_crit", None) \
        or jax_criterion.idt_embed_crit
    return {k.replace("::", "/"): v for k, v in
            _flatten(jax.device_get(crit.variables["params"])).items()}


@pytest.fixture(scope="module")
def runs(tree, meta, tmp_path_factory):
    """One epoch (2 steps) of each package's loop from the JAX meta state,
    each step's scalars through its saver; and the two args namespaces."""
    jmeta, path = meta
    work = tmp_path_factory.mktemp("loop")
    targs = tcli.resolve_args(["--checkpoint_path", str(path),
                               "--num_epochs", "1", "--experiments_dir",
                               str(work), "--criterions", LOOP_CRITERIA,
                               *_data_flags(tree)])
    jargs = types.SimpleNamespace(**vars(targs))
    jargs.num_labels = IDENTITIES

    opt_g, opt_d = build.build_optimizers(jargs, MODULES)
    jcriteria = build.build_criteria(jargs, {"criterions": [
        JAX_CRITERIA[n.strip()] for n in jargs.criterions.split(",")]})
    jmodels = _jax_models(jargs)
    jstep = jholycow.make_train_step(jmodels, jcriteria, jargs, opt_g, opt_d)
    jloader = jds.Wrapper.get_dataloader(jargs, "train")
    jstate = jloop.run_epoch(jloader, jstep, jmeta, jargs, 0,
                             jax.random.PRNGKey(0),
                             saver=jsaver.Saver(work / "jax"))

    tstate = tcli.load_checkpoint(targs, CPU)
    criteria = tcli.build_criteria(targs, CPU)
    for crit, jcrit in zip(criteria, jcriteria):
        tower = getattr(crit, "perceptual_crit", None) \
            or getattr(crit, "idt_embed_crit", None)
        if tower is not None:
            load_tower_arrays(tower.module, _tower_arrays(jcrit))
    tloader = tcli.build_dataloader(targs)
    tloop.run_epoch(tloader, tcli.make_step(targs, criteria), tstate, targs,
                    0, CPU, tholycow.META_STEP_KEYS,
                    saver=tsaver.Saver(work / "port"))
    return dict(jargs=jargs, targs=targs, jmodels=jmodels, jstate=jstate,
                tstate=tstate, work=work, path=path)


def _saved_scalars(directory):
    out = []
    for f in sorted(Path(directory).glob("*.npz")):
        with np.load(f) as z:
            out.append({k[len("scalar_"):]: float(z[k]) for k in z.files
                        if k.startswith("scalar_")})
    return out


def test_run_epoch_matches_jax(runs):
    """Both loops take the epoch's 2 steps on the same batches; the first
    step's losses agree within 1e-4, the second's within the drift bound;
    step counters agree."""
    want = _saved_scalars(runs["work"] / "jax")
    got = _saved_scalars(runs["work"] / "port")
    assert len(want) == len(got) == 2
    for step, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) and len(w) == 7
        for key in w:
            np.testing.assert_allclose(
                g[key], w[key], rtol=LOSS_RTOL if step == 0
                else DRIFT_LOSS_RTOL, atol=1e-7, err_msg=f"{step} {key}")
    assert runs["tstate"].step == int(runs["jstate"].step) == 2
    assert runs["targs"].iteration == runs["jargs"].iteration == 2


@pytest.fixture(scope="module")
def evals(runs, tree, meta):
    """Both packages' eval forwards on one state: the JAX meta state, and
    the port's loaded from its checkpoint."""
    jargs, targs = runs["jargs"], runs["targs"]
    jeval = jloop.make_eval_forward(runs["jmodels"], jargs)
    teval = tloop.make_eval_forward(targs)
    tstate = tcli.load_checkpoint(targs, CPU)
    return jeval, teval, meta[0], tstate


def test_eval_forward_matches_jax(evals, runs):
    jeval, teval, jstate, tstate = evals
    val = tcli.build_dataloader(runs["targs"], "val", "val")
    data, target = next(iter(val))
    batch = {**data, **target}
    want = jeval(jstate, batch)
    got = teval(tstate, batch)
    for key in ("fake_rgbs", "fake_segm"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, err_msg=key)
    assert not np.allclose(got["fake_rgbs"].numpy(), 0.5, atol=1e-3)


def test_eval_forward_in_train_mode_leaves_the_statistics(evals, runs):
    """--no-set_eval_mode_in_test: the embedder normalises with the batch's
    statistics, and its running statistics stay as they were."""
    _, teval, _, tstate = evals
    args = types.SimpleNamespace(**vars(runs["targs"]))
    args.set_eval_mode_in_test = False
    data, target = next(iter(tcli.build_dataloader(args, "val", "val")))
    before = {k: v.clone() for k, v in
              tstate.models["embedder"].named_buffers()}
    train = tloop.make_eval_forward(args)(tstate, {**data, **target})
    test = teval(tstate, {**data, **target})
    for k, v in tstate.models["embedder"].named_buffers():
        assert torch.equal(v, before[k]), k
    assert not torch.allclose(train["pose_embedding"],
                              test["pose_embedding"])


def test_cli_flags_resolve_as_the_jax_cli():
    """The loop's flags over the meta config: --fixed_val_ids appends to
    the defaults as argparse's append does, the JAX spelling of
    --args-to-ignore is taken, metrics the port has not refuse."""
    args = tcli.resolve_args([
        "--config_name", "default",
        "--dataloader", "voxceleb2_segmentation_nolandmarks",
        "--fixed_val_ids", "0", "--fixed_val_ids", "3", "--args-to-ignore",
        "a,b", "--metrics", "psnr"])
    assert args.fixed_val_ids == [50, 100, 200, 250, 300, 0, 3]
    assert args.args_to_ignore == "a,b" and args.metrics == "psnr"
    assert (args.num_workers, args.prefetch_size, args.log_frequency_images,
            args.set_eval_mode_in_test, args.skip_eval) == (4, 16, 500, True,
                                                            True)
    # a metric the JAX registry does not have either
    with pytest.raises(ValueError, match="Unknown metric 'lpips'"):
        tcli.resolve_args(["--config_name", "default", "--dataloader",
                           "synthetic", "--metrics", "lpips"])


def test_run_validation_matches_jax(evals, runs, tmp_path):
    jeval, teval, jstate, tstate = evals
    jargs, targs = runs["jargs"], runs["targs"]
    for args in (jargs, targs):
        args.num_visuals_per_img = 2
    jval = jds.Wrapper.get_dataloader(jargs, "val", "val")
    tval = tcli.build_dataloader(targs, "val", "val")
    want = jloop.run_validation(jval, jeval, jstate, jargs, 0,
                                metrics=[jpsnr.Metric(), jiou.Metric()],
                                saver=jsaver.Saver(tmp_path / "jax"))
    from latentpose_tpu_torch.metrics import psnr as tpsnr
    from latentpose_tpu_torch.metrics import segmentation_iou as tiou
    got = tloop.run_validation(tval, teval, tstate, targs, 0,
                               metrics=[tpsnr.Metric(), tiou.Metric()],
                               saver=tsaver.Saver(tmp_path / "port"))
    assert set(got) == set(want) == {"Data_time", "Batch_time", "PSNR",
                                     "segm_IoU"}
    np.testing.assert_allclose(got["PSNR"], want["PSNR"], rtol=1e-4)
    np.testing.assert_allclose(got["segm_IoU"], want["segm_IoU"], atol=1e-3)
    for name in ("jax", "port"):
        assert len(list((tmp_path / name).glob("*.npz"))) == 1


def test_identity_embedding_of_a_finetune_directory_matches_jax(runs, meta,
                                                                tree):
    """ê over a real fine-tune loader (one frame a sample, where the
    synthetic loader stacks K copies): the mean over every frame of one
    pass, within 1e-5 of its largest entry."""
    args = types.SimpleNamespace(**vars(runs["targs"]))
    args.finetune, args.train_split_path, args.batch_size = \
        True, "id00001/video0", 4
    jloader = jds.Wrapper.get_dataloader(args, "train")
    tloader = tcli.build_dataloader(args)
    assert next(iter(tloader))[0]["enc_rgbs"].shape == (4, 1, IMG, IMG, 3)
    want = np.asarray(jft.compute_averaged_identity_embedding(
        runs["jmodels"], meta[0], jloader, args))
    got = tft.compute_averaged_identity_embedding(
        tcli.load_checkpoint(runs["targs"], CPU), tloader, CPU).numpy()
    assert got.shape == want.shape == (1, 16)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# --- meter, saver, visuals, names, PNG -----------------------------------------

def test_meter_matches_jax():
    want, got = jmeter.Meter(), tmeter.Meter()
    other_w, other_g = jmeter.Meter(), tmeter.Meter()
    for m, o in ((want, other_w), (got, other_g)):
        for i, v in enumerate([1.0, float("nan"), 3.5, 2.0]):
            m.add("a", v, count=i + 1)
            o.add("b" if i % 2 else "a", v * 2)
        m += o
    assert list(got.keys()) == list(want.keys())
    for k in want.keys():
        assert got.get_average(k) == want.get_average(k)
        assert got.get_last(k) == want.get_last(k)
    assert np.isnan(got.get_average("missing"))


def test_saver_matches_jax(tmp_path):
    data = {"fake_rgbs": np.arange(12, dtype=np.float32).reshape(1, 2, 2, 3),
            "fake_segm": None, "label": np.array([3], np.int32)}
    for name, cls in (("jax", jsaver.Saver), ("port", tsaver.Saver)):
        saver = cls(tmp_path / name)
        saver.save(1, 5, scalars={"loss_G": 0.5}, data=data)
        saver.save(2, 6)
    for f in ("000000.npz", "000001.npz"):
        with np.load(tmp_path / "jax" / f) as w, \
                np.load(tmp_path / "port" / f) as g:
            assert w.files == g.files
            for k in w.files:
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("with_cross", [False, True])
def test_make_visual_matches_jax(with_cross):
    rng = np.random.RandomState(4)
    d = {"enc_rgbs": rng.rand(3, 2, 8, 8, 3).astype(np.float32),
         "pose_input_rgbs": rng.rand(3, 1, 8, 8, 3).astype(np.float32),
         "fake_rgbs": rng.rand(3, 8, 8, 3).astype(np.float32),
         "real_segm": rng.rand(3, 1, 8, 8, 1).astype(np.float32),
         "fake_segm": rng.rand(3, 8, 8, 1).astype(np.float32)}
    if with_cross:
        for s in ("_other_video", "_other_person"):
            d["pose_input_rgbs" + s] = rng.rand(3, 1, 8, 8, 3)
            d["fake_rgbs" + s] = rng.rand(3, 8, 8, 3)
    want, wcap = jvis.make_visual(d, n_samples=2)
    got, gcap = tvis.make_visual(d, n_samples=2)
    assert gcap == wcap
    np.testing.assert_array_equal(got, want)


def test_experiment_name_matches_jax():
    args = types.SimpleNamespace(a=1, b="x/y", c=3, experiment_name="")
    defaults = types.SimpleNamespace(a=1, b="z", c=4)
    ignore = ["c"]
    assert tlog.get_postfix(vars(args), vars(defaults), ignore) \
        == jlog.get_postfix(vars(args), vars(defaults), ignore) \
        == "b^x+y__experiment_name^"
    name = tlog.get_experiment_name(args, defaults, ignore)
    assert name.endswith("___b^x+y__experiment_name^")
    args.experiment_name = "run"
    assert tlog.get_experiment_name(args, defaults, ignore) == "run"
    long = types.SimpleNamespace(**{f"k{i}": "v" * 20 for i in range(30)},
                                 experiment_name="")
    assert len(tlog.get_experiment_name(long, None, [])) == 255


@pytest.mark.parametrize("shape", [(7, 5, 3), (4, 9), (1, 1, 3)])
def test_png_writer_round_trips(tmp_path, shape):
    """The port's PNG encoder: cv2 and the port's own decoder read back the
    array exactly."""
    cv2 = pytest.importorskip("cv2")
    img = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    path = tmp_path / "x.png"
    write_png(path, img)
    read = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(read if img.ndim == 2 else read[..., ::-1],
                                  img)
    decoded, failed = tnative.NativeBatchLoader(1).load([path], shape[0]) \
        if shape[0] == shape[1] else (None, 0)
    if decoded is not None:
        rgb = img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
        np.testing.assert_array_equal(np.rint(decoded[0] * 255), rgb)
    with pytest.raises(ValueError):
        encode_png(img.astype(np.float32))


def test_writer_images_decode_to_the_jax_writers(tmp_path):
    cv2 = pytest.importorskip("cv2")
    grid = np.random.RandomState(2).rand(10, 14, 3).astype(np.float32)
    for name, cls in (("jax", jlog.ExperimentWriter),
                      ("port", tlog.ExperimentWriter)):
        writer = cls(tmp_path / name)
        writer.add_image("Images/train/visual", grid, ["a | b"], 3)
        writer.add_scalar("Metrics/train/loss_G", 0.25, 3)
        writer.close()
    f = "images/Images_train_visual_00000003"
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "port" / f"{f}.png")),
        cv2.imread(str(tmp_path / "jax" / f"{f}.png")))
    for suffix in (".txt", ""):
        name = f + suffix if suffix else "scalars.jsonl"
        assert (tmp_path / "port" / name).read_text() \
            == (tmp_path / "jax" / name).read_text()


# --- the CLIs on the tree -------------------------------------------------------

def test_cli_saves_on_sigint_at_a_step_boundary(runs, tree, tmp_path):
    """SIGINT after the first logged step: the CLI finishes the step it is
    in, saves and exits 0; the checkpoint resumes with the step and the
    Adam counts continuing."""
    argv = ["--checkpoint_path", str(runs["path"]), "--num_epochs", "1000",
            "--save_frequency", "0", "--criterions", LOOP_CRITERIA,
            "--experiments_dir", str(tmp_path), "--experiment_name", "sig",
            *_data_flags(tree)]
    proc = subprocess.Popen(
        [sys.executable, "-c", CLI_WITH_SHALLOW_TOWERS, *argv], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONUNBUFFERED": "1"})
    log = []
    try:
        for line in proc.stdout:
            log.append(line)
            if "loop:iteration" in line:
                proc.send_signal(signal.SIGINT)
                break
        log += proc.stdout.readlines()
        rc = proc.wait(timeout=120)
    finally:
        proc.kill()
    assert rc == 0, "".join(log[-30:])
    ckpts = sorted((tmp_path / "sig" / "checkpoints").iterdir())
    assert len(ckpts) == 1, ckpts
    flat = tcli.ckpt_lib.load_arrays(ckpts[0])
    step = int(flat["step"])
    assert step >= 1 and ckpts[0].name == f"model_{step:08d}.ckpt"
    assert int(flat["opt_state_g::0::count"]) == step \
        == int(flat["opt_state_d::0::count"])
    state, path = tcli.main([
        "--checkpoint_path", str(ckpts[0]), "--num_epochs", "1",
        "--experiments_dir", str(tmp_path), "--experiment_name", "resumed",
        "--criterions", LOOP_CRITERIA, *_data_flags(tree)])
    assert state.step == step + 2
    assert state.opt_g.count == state.opt_d.count == step + 2


def test_jax_checkpoint_resumes_in_the_port_cli_and_back(runs, tree,
                                                         tmp_path,
                                                         monkeypatch):
    """The JAX meta checkpoint meta-trains an epoch in the port's CLI on the
    tree (validation, visuals and the fixed probe on), fine-tunes from one
    of its directories, and the port's fine-tuned checkpoint resumes in the
    JAX CLI on the same directory."""
    state, meta_path = tcli.main([
        "--checkpoint_path", str(runs["path"]), "--num_epochs", "1",
        "--no-skip_eval", "--metrics", "psnr, segmentation_iou",
        "--log_frequency_images", "1", "--log_frequency_fixed_images", "1",
        "--fixed_val_ids", "0", "--experiments_dir", str(tmp_path),
        "--experiment_name", "meta", "--criterions", LOOP_CRITERIA,
        *_data_flags(tree)])
    assert state.step == 2 and state.opt_g.count == 2
    scalars = [json.loads(l) for l in
               (tmp_path / "meta" / "scalars.jsonl").read_text().splitlines()]
    tags = {s["tag"] for s in scalars}
    assert {"Metrics/train/loss_G", "Metrics/val/PSNR",
            "Fixed_metrics/train/PSNR"} <= tags
    captions = (tmp_path / "meta" / "images"
                / "Images_train_visual_00000000.txt").read_text()
    assert "_other_video" in captions and "_other_person" in captions

    ft_flags = [*_data_flags(tree), "--train_split_path", "id00002/video0",
                "--skip_eval", "--num_epochs", "1", "--batch_size", "4",
                "--criterions", "adversarial, featmat, dice"]
    state, ft_path = tcli.main([
        "--finetune", "--config_name", "finetuning-base",
        "--checkpoint_path", str(meta_path),
        "--experiments_dir", str(tmp_path), "--experiment_name", "ft",
        *ft_flags])
    assert state.finetune and state.step == 3

    # the JAX CLI's models with a jitted init (eager init of the towers
    # takes a minute on the CPU)
    build_models = build.build_models
    monkeypatch.setattr(build, "build_models", lambda *a: {
        k: _JitInit(m) for k, m in build_models(*a).items()})
    finetune_dis = jft.make_finetune_discriminator
    monkeypatch.setattr(jft, "make_finetune_discriminator",
                        lambda *a: _JitInit(finetune_dis(*a)))
    jstate = jtrain_cli.main([
        "--finetune", "--checkpoint_path", str(ft_path),
        "--dataloader", "voxceleb2_segmentation_nolandmarks",
        "--data_root", str(tree), "--train_split_path", "id00002/video0",
        "--bboxes_dir", str(tree / "bboxes.npy"), "--num_devices", "1",
        "--num_workers", "1", "--batch_size", "4", "--num_epochs", "1",
        "--allow_random_vgg", "--no-logging", "--skip_eval",
        "--criterions", "adversarial, featmat, dice",
        "--no-use_pixelwise_augs", "--no-use_affine_scale",
        "--no-use_affine_shift", "--experiments_dir", str(tmp_path / "jax")])
    assert int(jstate.step) == 4
    assert int(jstate.opt_state_g[0].count) == 2


def _numbers_loader(n):
    """n batches of 2 samples, as a loader yields them."""
    return [({"x": np.full((2, 3), i, np.float32)},
             {"label": np.array([i, i], np.int32)}) for i in range(n)]


def _loop_args(**over):
    args = types.SimpleNamespace(
        profile_dir="", profile_steps=5, detailed_metrics=True,
        log_frequency_loss=1, log_frequency_images=100,
        log_frequency_fixed_images=100, iteration=0, random_seed=0,
        transfer_dtype="float32")
    for k, v in over.items():
        setattr(args, k, v)
    return args


def test_run_epoch_traces_steps_two_on_with_profile_dir(tmp_path):
    """--profile_dir: a torch.profiler trace of steps [2, 2 + profile_steps)
    of epoch 0, written as a Chrome trace; no trace in later epochs."""
    seen = []

    def step(state, batch):
        seen.append(int(batch["label"][0]))
        return {"loss_G": torch.exp(batch["x"]).sum()}

    for epoch, where in ((0, tmp_path / "e0"), (1, tmp_path / "e1")):
        args = _loop_args(profile_dir=str(where), profile_steps=2)
        meter = tloop.run_epoch(_numbers_loader(6), step, None, args, epoch,
                                CPU, ("x", "label"))
        assert meter.get_last("loss_G") > 0 and args.iteration == 6
    assert seen == list(range(6)) * 2
    trace = json.loads((tmp_path / "e0" / "trace.json").read_text())
    steps = [e for e in trace["traceEvents"] if e.get("name") == "aten::exp"]
    assert len(steps) == 2
    assert not (tmp_path / "e1").exists()


def test_run_epoch_stops_at_a_step_boundary_and_a_second_signal_exits():
    """The stop flag set during a step ends the epoch after that step; the
    CLI's handler sets it on the first signal and exits, without saving, on
    the second."""
    flag = tcli.StopFlag()
    seen = []

    def step(state, batch):
        seen.append(int(batch["label"][0]))
        if len(seen) == 2:
            flag._handle(signal.SIGINT, None)
        return {}

    tloop.run_epoch(_numbers_loader(6), step, None, _loop_args(), 0, CPU,
                    ("x", "label"), stop=flag)
    assert seen == [0, 1] and flag.is_set()
    with pytest.raises(SystemExit) as exit_info:
        flag._handle(signal.SIGTERM, None)
    assert exit_info.value.code == 128 + signal.SIGTERM
