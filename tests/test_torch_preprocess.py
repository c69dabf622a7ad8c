"""PyTorch port, the preprocessing slice: S³FD, FAN and Graphonomy, the
latentpose cropper, the test-time-scaled segmentation, and the
``crop_as_in_dataset`` / ``preprocess_dataset`` CLIs, each held against
the JAX package on the CPU.

Weights: each net's flax tree (its shapes from ``jax.eval_shape`` of the JAX
module's ``init``) filled from a seeded numpy generator: kernels at
1/sqrt(fan-in), small biases, BatchNorm scales, offsets and statistics
drawn away from 1 and 0 (as ``tests/test_graphonomy_golden_parity.py``
randomises them), so eval-form BatchNorm is not the identity.  S³FD's
offset heads are scaled down, so that its boxes stay near their anchors and
the crops near the frame's size; Graphonomy's background logit is raised,
so that its person probability spreads around 0.5.  The flat npz is written
once and loaded into both packages: the JAX package's
``load_flat_npz_variables`` and the port's ``utils/weights.py``.

Tolerances (f32 on the CPU, sums in another order than XLA's): each head,
heatmap stack and probability map within 1e-4 of its largest magnitude;
boxes 1e-3 px in the same order; landmarks 1e-4 px; crops within the C++
crop's bound against cv2's (ROADMAP C.5: 3.5/255, here whole uint8
levels: 3); masks equal except pixels whose averaged probability lies
within 1e-4 of the 0.5 threshold.
"""

import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from latentpose_tpu.cli import crop_as_in_dataset as jcrop_cli
from latentpose_tpu.cli import preprocess_dataset as jprep_cli
from latentpose_tpu.eval import fan as jfan
from latentpose_tpu.preprocess import croppers as jcroppers
from latentpose_tpu.preprocess import graphonomy as jgraph
from latentpose_tpu.preprocess import s3fd as js3fd
from latentpose_tpu.preprocess import segmentation as jseg
from latentpose_tpu.utils import weights as jweights
from latentpose_tpu_torch.cli import crop_as_in_dataset as crop_cli
from latentpose_tpu_torch.cli import preprocess_dataset as prep_cli
from latentpose_tpu_torch.data import native_loader
from latentpose_tpu_torch.data.synthetic import render_face
from latentpose_tpu_torch.eval import fan
from latentpose_tpu_torch.ops.resize import resize_linear
from latentpose_tpu_torch.preprocess import croppers, graphonomy, s3fd
from latentpose_tpu_torch.preprocess import segmentation
from latentpose_tpu_torch.utils import weights
from latentpose_tpu_torch.utils.png import write_png

torch.set_num_threads(1)

REL = 1e-4
LM_TOL = 1e-4
CROP_LEVELS = 3          # uint8 levels: C.5's 3.5/255
# a narrow Graphonomy for the direct comparisons (the CLIs run it full)
NARROW = dict(backbone_cfg=dict(stem_widths=(8, 16),
                                entry_widths=(16, 24, 32), middle_blocks=2,
                                exit_widths=(32, 40, 48, 48, 64)),
              aspp_features=32)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(_flat(value, path))
        else:
            out[path] = value
    return out


def seeded_flat(module, x_shape, seed):
    """The flat npz dict ({"params/...", "batch_stats/..."}) of a JAX
    module's tree, filled from numpy's generator ``seed``."""
    shapes = _flat(jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                  jnp.zeros(x_shape, jnp.float32)))
    rng = np.random.RandomState(seed)
    out = {}
    for key in sorted(shapes):
        shape = shapes[key].shape
        leaf = key.rsplit("/", 1)[1]
        if key.startswith("batch_stats"):
            v = (rng.uniform(-0.3, 0.3, shape) if leaf == "mean"
                 else rng.uniform(0.5, 1.5, shape))
        elif leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) * np.sqrt(1.0 / fan_in)
            if "/reg" in key:       # S³FD's offsets: boxes near anchors
                v *= 0.05
        elif leaf == "bias":
            v = rng.uniform(-0.1, 0.1, shape)
            if key.endswith("/classifier/bias"):   # P(background) ~ 0.5
                v[0] += np.log(shape[0] - 1)
        elif leaf == "scale":
            v = (rng.uniform(4.0, 10.0, shape) if "l2norm" in key
                 else rng.uniform(0.5, 1.5, shape))
        else:                                   # the label adjacency
            v = rng.randn(*shape)
        out[key] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    """The files ``tools/convert_torch_weights.py`` makes: s3fd.npz, and for
    the CLI tests a one-module FAN (fan_2d.npz) and the narrow Graphonomy
    (graphonomy.npz), which :func:`small_nets` has both packages build."""
    root = tmp_path_factory.mktemp("weights")
    for name, module, shape, seed in (
            ("s3fd.npz", js3fd.S3FD(), (1, 32, 32, 3), 1),
            ("fan_2d.npz", jfan.FAN(num_modules=1), (1, 64, 64, 3), 2),
            ("graphonomy.npz", jgraph.Graphonomy(**NARROW), (1, 32, 32, 3),
             3)):
        np.savez(root / name, **seeded_flat(module, shape, seed))
    return root


@pytest.fixture
def small_nets(monkeypatch):
    """Both packages' backends build a one-module FAN and the narrow
    Graphonomy (the CLIs' full widths run on the card, chip_smoke.py)."""
    for mod, cls, kwargs in ((jfan, jfan.FAN, dict(num_modules=1)),
                             (fan, fan.FAN, dict(num_modules=1)),
                             (jgraph, jgraph.Graphonomy, NARROW),
                             (graphonomy, graphonomy.Graphonomy, NARROW)):
        name = cls.__name__
        monkeypatch.setattr(mod, name,
                            lambda *a, _c=cls, _k=kwargs, **k: _c(**_k))


def _image(h, w, seed):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h // 4 + 1, w // 4 + 1, 3)).astype(np.uint8)
    img = resize_linear(torch.from_numpy(base)[None], (w, h))[0].numpy()
    return np.ascontiguousarray(img)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max err {err} > {rel} x {scale}"


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


# ---------------------------------------------------------------- weights

def test_flat_npz_reader_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    flat = {"params/a/b/kernel": rng.rand(3, 3, 2, 4),
            "batch_stats/a/bn/mean": rng.rand(4),
            "a/bn__mean": rng.rand(5), "a/bn__var": rng.rand(5),
            "c/d/bias": rng.rand(2), "top": rng.rand(1)}
    np.savez(tmp_path / "w.npz", **flat)
    for source in (flat, str(tmp_path / "w.npz")):
        want = _flat(jweights.load_flat_npz_variables(source))
        got = _flat(weights.load_flat_npz_variables(source))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("net", ["s3fd", "fan", "graphonomy"])
def test_converter_round_trips_in_the_flax_layout(net):
    """The port's module -> flat npz dict: the JAX module's keys and shapes;
    back: bit-equal."""
    jmod, tmod, shape = {
        "s3fd": (js3fd.S3FD(), s3fd.S3FD(), (1, 32, 32, 3)),
        "fan": (jfan.FAN(num_modules=2), fan.FAN(num_modules=2),
                (1, 64, 64, 3)),
        "graphonomy": (jgraph.Graphonomy(**NARROW),
                       graphonomy.Graphonomy(**NARROW), (1, 32, 32, 3)),
    }[net]
    want = {k: v.shape for k, v in _flat(jax.eval_shape(
        jmod.init, jax.random.PRNGKey(0), jnp.zeros(shape))).items()}
    torch.manual_seed(0)
    for m in tmod.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.3, 0.3)
            m.running_var.uniform_(0.5, 1.5)
    flat = weights.flax_from_state_dict(tmod)
    assert {k: v.shape for k, v in flat.items()} == want
    back = weights.state_dict_from_flax(
        tmod, weights.load_flat_npz_variables(flat))
    own = tmod.state_dict()
    assert set(back) == {k for k in own if "num_batches" not in k}
    for k, v in back.items():
        assert torch.equal(v, own[k]), k


# ---------------------------------------------------------------- S³FD

@pytest.fixture(scope="module")
def s3fd_heads(weights_dir):
    """Two 100x140 frames (odd sizes down the trunk: the ceil-mode pool)
    through both packages' S³FD."""
    images = np.stack([_image(100, 140, 1), _image(100, 140, 2)])
    variables = jweights.load_flat_npz_variables(
        str(weights_dir / "s3fd.npz"))
    x = images.astype(np.float32) - np.array([123.0, 117.0, 104.0],
                                             np.float32)
    want = jax.jit(js3fd.S3FD().apply)(variables, jnp.asarray(x))
    detector = croppers.S3FDDetector(weights_dir / "s3fd.npz", "cpu")
    return images, want, detector.heads(images), detector


def test_s3fd_heads_match_jax(s3fd_heads):
    _, want, got, _ = s3fd_heads
    assert len(got) == 6
    for (wc, wr), (gc, gr) in zip(want, got):
        _close(gc.numpy(), _nchw(wc))
        _close(gr.numpy(), _nchw(wr))


def test_decode_and_nms_match_jax(s3fd_heads):
    """The port's decode on the JAX heads: the same boxes in the same
    order, frame by frame; the detector's own path close to them."""
    images, want, _, detector = s3fd_heads
    heads = [(torch.from_numpy(_nchw(c).copy()),
              torch.from_numpy(_nchw(r).copy()))
             for c, r in want]
    got = s3fd.decode_detections(heads)
    own = detector(images)
    for f in range(len(images)):
        frame = [(c[f:f + 1], r[f:f + 1]) for c, r in want]
        raw = js3fd.decode_detections(frame)
        assert len(raw) > 10
        np.testing.assert_allclose(got[f][:, :4], raw[:, :4], atol=1e-3)
        np.testing.assert_allclose(got[f][:, 4], raw[:, 4], atol=1e-6)
        kept = js3fd.nms(raw)
        np.testing.assert_allclose(s3fd.nms(got[f]), kept, atol=1e-3)
        # the port's own heads differ by ~1e-5 of their max, which the
        # offsets' exponential carries into the seeded net's wide boxes
        np.testing.assert_allclose(np.asarray(own[f]), kept, rtol=1e-4,
                                   atol=1e-3)


# ---------------------------------------------------------------- FAN

@pytest.mark.parametrize("modules,size", [(1, 256), (4, 64)])
def test_fan_heatmaps_and_landmarks_match_jax(tmp_path, modules, size):
    jmod = jfan.FAN(num_modules=modules)
    flat = seeded_flat(jmod, (1, 64, 64, 3), 5)
    images = np.random.RandomState(6).rand(2, size, size, 3).astype(
        np.float32)
    want = jax.jit(jmod.apply)(jweights.load_flat_npz_variables(flat),
                               jnp.asarray(images))
    tmod = weights.load_flax_weights(fan.FAN(num_modules=modules),
                                     flat).eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(_nchw(images)))
    assert len(got) == modules
    for g, w in zip(got, want):
        _close(g.numpy(), _nchw(w))
    # the landmarks of the same heatmaps are equal ...
    hm = np.asarray(want[-1])
    want_lm = np.asarray(jfan.heatmaps_to_landmarks(jnp.asarray(hm)))
    np.testing.assert_array_equal(
        fan.heatmaps_to_landmarks(torch.from_numpy(_nchw(hm))).numpy(),
        want_lm)
    # ... and of the port's heatmaps, except where the argmax or a
    # refinement's sign is a near-tie (within 1e-4 of the map's max)
    got_lm = fan.heatmaps_to_landmarks(got[-1]).numpy()
    flat_hm = _nchw(hm).reshape(*_nchw(hm).shape[:2], -1)
    top2 = np.sort(flat_hm, axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) <= REL * np.abs(hm).max()
    near = np.abs(got_lm - want_lm).max(axis=-1)
    assert ((near <= LM_TOL) | tie | (near == 1.0)).all()
    assert (near <= LM_TOL).mean() > 0.9


# ---------------------------------------------------------------- Graphonomy

def test_bilinear_upsample_matches_jax_image_resize():
    """Graphonomy's two ``jax.image.resize(..., "bilinear")`` calls are
    upsamples with half-pixel centres: F.interpolate(align_corners=False)."""
    x = np.random.RandomState(0).randn(2, 5, 7, 3).astype(np.float32)
    for out in ((20, 28), (12, 20), (5, 7)):
        want = jax.image.resize(jnp.asarray(x), (2, *out, 3), "bilinear")
        got = F.interpolate(torch.from_numpy(_nchw(x)), size=out,
                            mode="bilinear", align_corners=False)
        np.testing.assert_allclose(got.numpy(), _nchw(want), atol=1e-6)


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_graphonomy_matches_jax(weights_dir, hw):
    flat = str(weights_dir / "graphonomy.npz")
    images = np.random.RandomState(7).rand(2, *hw, 3).astype(np.float32)
    want = jax.jit(jgraph.Graphonomy(**NARROW).apply)(
        jweights.load_flat_npz_variables(flat), jnp.asarray(images))
    tmod = weights.load_flax_weights(graphonomy.Graphonomy(**NARROW),
                                     flat).eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(_nchw(images)))
    np.testing.assert_allclose(got.numpy(), _nchw(want), atol=REL)
    np.testing.assert_allclose(graphonomy.person_mask(got).numpy(),
                               np.asarray(jgraph.person_mask(want)),
                               atol=REL)


class _NarrowBackend:
    """The port's Graphonomy backend around the narrow net."""

    device = torch.device("cpu")

    def __init__(self, flat):
        self.model = weights.load_flax_weights(
            graphonomy.Graphonomy(**NARROW), flat).eval()

    def __call__(self, images):
        x = images.permute(0, 3, 1, 2).float() / 255.0
        with torch.no_grad():
            return graphonomy.person_mask(self.model(x.contiguous()))


@pytest.mark.parametrize("hw,out", [((64, 64), (48, 48)), ((64, 64), (96, 96)),
                                    ((64, 64), (128, 128)),
                                    ((360, 640), (256, 256)),
                                    ((100, 140), (75, 105))])
def test_resize_linear_matches_cv2(hw, out):
    """uint8: bit-equal to cv2.resize(INTER_LINEAR); float32: within 2e-5
    (cv2's float downscale sums in another order)."""
    cv2 = pytest.importorskip("cv2")
    img = np.random.RandomState(8).randint(0, 256, (*hw, 3)).astype(np.uint8)
    got = resize_linear(torch.from_numpy(img)[None], out)[0].numpy()
    np.testing.assert_array_equal(got, cv2.resize(img, out))
    prob = np.random.RandomState(9).rand(*hw).astype(np.float32)
    got = resize_linear(torch.from_numpy(prob)[None], out)[0].numpy()
    np.testing.assert_allclose(got, cv2.resize(prob, out), atol=2e-5)


def test_segment_with_tta_matches_jax(weights_dir):
    """Two 64² crops at the scales 0.75/1.0/1.5/2.0 through both packages:
    masks equal except where the averaged probability lies within 1e-4 of
    0.5."""
    flat = str(weights_dir / "graphonomy.npz")
    variables = jweights.load_flat_npz_variables(flat)
    apply = jax.jit(jgraph.Graphonomy(**NARROW).apply)

    def jax_backend(image):
        x = jnp.asarray(image.astype(np.float32)[None] / 255.0)
        return np.asarray(jgraph.person_mask(apply(variables, x)))[0]

    images = np.stack([_image(64, 64, 10), _image(64, 64, 11)])
    backend = _NarrowBackend(flat)
    got = segmentation.segment_with_tta(backend, images)
    acc = segmentation.tta_probabilities(backend, images).numpy()
    assert got.shape == (2, 64, 64) and got.dtype == np.float32
    for i, image in enumerate(images):
        want = jseg.segment_with_tta(jax_backend, image)
        agree = (got[i] == want) | (np.abs(acc[i] - 0.5) <= REL)
        assert agree.all()
        np.testing.assert_array_equal(
            segmentation.segment_with_tta(backend, image), got[i])
    assert 0.0 < got.mean() < 1.0


# ---------------------------------------------------------------- cropper

def test_latentpose_cropper_matches_jax():
    """Boxes inside the frame and over its edges, cubic and area: crops
    within CROP_LEVELS of the JAX cropper's (cv2), landmarks within 1e-4."""
    image = _image(120, 160, 12)
    lm = np.random.RandomState(13).uniform(0, 160, (68, 3)).astype(
        np.float32)
    boxes = [[60, 40, 100, 84], [-10, 30, 40, 90], [120.5, 70.25, 170, 130],
             [20, 10, 140, 115]]
    for size in (64, 48):
        want = jcroppers.LatentPoseFaceCropper(
            (size, size), landmark_detector=lambda img, bbox=None: lm)
        port = croppers.LatentPoseFaceCropper(
            (size, size), landmark_detector=lambda imgs: np.stack(
                [lm] * len(imgs)))
        crops, lms = port.crop_images(np.stack([image] * len(boxes)), boxes)
        for i, box in enumerate(boxes):
            w_crop, w_lm = want.crop_image(image, bbox=box)
            assert crops[i].shape == w_crop.shape
            diff = np.abs(crops[i].astype(int) - w_crop.astype(int))
            assert diff.max() <= CROP_LEVELS and diff.mean() < 0.5
            np.testing.assert_allclose(lms[i], w_lm, atol=LM_TOL)
        one, one_lm = port.crop_image(image, bbox=boxes[0])
        np.testing.assert_array_equal(one, crops[0])
        port.close()


def _raw_tree(root, videos, frames, size=(96, 128)):
    """Rendered faces pasted off-centre on size canvases, PNG."""
    h, w = size
    for v in range(videos):
        d = root / "images-raw" / "id00001" / f"video{v}"
        d.mkdir(parents=True)
        for f in range(frames):
            face = (render_face(1, 3 * f + v, 48)[0] * 255).astype(np.uint8)
            canvas = np.full((h, w, 3), 60, np.uint8)
            y, x = 20 + 3 * f, 50 + 5 * v
            canvas[y:y + 48, x:x + 48] = face
            write_png(d / f"{f:05d}.png", canvas)
    return root / "images-raw"


@pytest.fixture
def jax_png(monkeypatch):
    """The JAX CLIs as references here: their crops saved as PNG data under
    the ``.jpg`` name (lossless, so that both packages' later stages see
    the same pixels; the port writes PNG, ROADMAP C.5)."""
    from PIL import Image
    save = Image.Image.save
    monkeypatch.setattr(Image.Image, "save",
                        lambda self, fp, *a, **k: save(self, fp,
                                                       format="PNG"))


def _compare_crops(port_dir, jax_dir):
    port = sorted(p.relative_to(port_dir).with_suffix("")
                  for p in port_dir.rglob("*.png"))
    want = sorted(p.relative_to(jax_dir).with_suffix("")
                  for p in jax_dir.rglob("*.jpg"))
    assert port == want and port
    for rel in port:
        a = native_loader.decode(port_dir / rel.with_suffix(".png"))
        b = native_loader.decode(jax_dir / rel.with_suffix(".jpg"))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= CROP_LEVELS
    return port


def _compare_landmarks(port_dir, jax_dir):
    port = sorted(p.relative_to(port_dir) for p in port_dir.rglob("*.npy"))
    assert port == sorted(p.relative_to(jax_dir)
                          for p in jax_dir.rglob("*.npy")) and port
    for rel in port:
        np.testing.assert_allclose(np.load(port_dir / rel),
                                   np.load(jax_dir / rel), atol=LM_TOL)


def test_crop_cli_matches_jax(tmp_path, weights_dir, small_nets, jax_png):
    """crop_as_in_dataset on raw frames, S³FD boxes and FAN landmarks: the
    same stems, crops within CROP_LEVELS, landmarks within 1e-4 px."""
    src = _raw_tree(tmp_path, 1, 2) / "id00001" / "video0"
    common = ["--image-size", "64", "--save-landmarks",
              "--weights_dir", str(weights_dir)]
    assert jcrop_cli.main([str(src), str(tmp_path / "jax"), *common,
                           "--landmarks-dir", str(tmp_path / "jax_lm")]) == 2
    assert crop_cli.main([str(src), str(tmp_path / "port"), *common,
                          "--landmarks-dir", str(tmp_path / "port_lm"),
                          "--device", "cpu", "--batch_size", "1"]) == 2
    _compare_crops(tmp_path / "port", tmp_path / "jax")
    _compare_landmarks(tmp_path / "port_lm", tmp_path / "jax_lm")
    # the FFHQ style (A.19's second slice; the crop itself is held against
    # the JAX cropper in tests/test_torch_ablation_data.py): the same stems
    assert crop_cli.main([str(src), str(tmp_path / "ffhq"), "--crop-style",
                          "ffhq", *common, "--landmarks-dir",
                          str(tmp_path / "ffhq_lm"), "--device", "cpu"]) == 2
    assert sorted(p.stem for p in (tmp_path / "ffhq").glob("*.png")) \
        == sorted(p.stem for p in (tmp_path / "port").glob("*.png")) \
        == sorted(p.stem for p in (tmp_path / "ffhq_lm").glob("*.npy"))


def test_preprocess_dataset_matches_jax(tmp_path, weights_dir, small_nets,
                                        jax_png):
    """--do_crop --do_compute_segmentation on a raw tree of 2 videos x 2
    frames: the JAX CLI's layout and stems, crops, landmarks; the masks of
    the port's crops equal to the JAX segmentation stage's masks of the
    same crops, except near-0.5 pixels."""
    for root in (tmp_path / "jax", tmp_path / "port"):
        _raw_tree(root, 2, 2)
    flags = ["--image_size", "64", "--weights_dir", str(weights_dir)]
    jprep_cli.main(["--data_root", str(tmp_path / "jax"), "--do_crop",
                    "--do_compute_segmentation", *flags])
    prep_cli.main(["--data_root", str(tmp_path / "port"), "--do_crop",
                   "--do_compute_segmentation", "--device", "cpu", *flags])
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    stems = _compare_crops(port_root / "images-cropped",
                           jax_root / "images-cropped")
    _compare_landmarks(port_root / "keypoints-cropped",
                       jax_root / "keypoints-cropped")
    assert sorted(p.relative_to(port_root / "segmentation-cropped")
                  .with_suffix("") for p in
                  (port_root / "segmentation-cropped").rglob("*.png")) \
        == stems
    # the JAX segmentation stage on the port's crops
    ref = tmp_path / "ref"
    shutil.copytree(port_root / "images-cropped", ref / "images-cropped")
    jprep_cli.main(["--data_root", str(ref), "--do_compute_segmentation",
                    *flags])
    backend = segmentation.make_segmentation_backend(weights_dir, "cpu")
    for rel in stems:
        crop = native_loader.decode(port_root / "images-cropped"
                                    / rel.with_suffix(".png"))
        acc = segmentation.tta_probabilities(backend, crop[None])[0].numpy()
        got = native_loader.decode(port_root / "segmentation-cropped"
                                   / rel.with_suffix(".png"))
        want = native_loader.decode(ref / "segmentation-cropped"
                                    / rel.with_suffix(".png"))
        assert set(np.unique(got)) <= {0, 255}
        assert ((got == want).all(-1) | (np.abs(acc - 0.5) <= REL)).all()
    # --do_crop_ffhq (A.19's second slice; its crops are held against the
    # JAX CLI's in test_crop_cli_matches_jax): the same stems, FFHQ-style
    prep_cli.main(["--data_root", str(port_root), "--do_crop_ffhq",
                   "--device", "cpu", *flags])
    for sub, suffix in (("images-cropped-ffhq", ".png"),
                        ("keypoints-cropped-ffhq", ".npy")):
        assert sorted(p.relative_to(port_root / sub).with_suffix("")
                      for p in (port_root / sub).rglob(f"*{suffix}")) \
            == stems, sub

