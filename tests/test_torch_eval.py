"""PyTorch port, the eval half of the preprocessing-and-eval slice: the
resizes of the face crops, the paper's metrics, ArcFace-r100, LPIPS and the
descriptor and landmark backends, each held against the JAX package (or cv2,
which the JAX package calls) on the CPU.

Tolerances:

- INTER_AREA: bit-equal to cv2.  INTER_CUBIC: bit-equal to cv2 as this
  wheel runs it (through IPP, in f32) except on .5 ties, where IPP's own
  rounding of its weights decides: a value that differs differs by 1 level
  and lies within ``CUBIC_TIE`` of a tie before rounding (1e-5 of the
  values read so over 9M); against cv2's own fixed-point code (IPP off) at
  most 1 level;
- metrics: the same numpy code, 1e-12;
- ArcFace (f32, sums in another order than XLA's): 2e-4 of the embedding's
  largest magnitude; normalized descriptors through the backends the same;
- the proxies: 1e-6 (the same numpy code after a bit-equal resize);
- LPIPS: 1e-4 relative.
"""

import cv2
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from hypothesis import given, settings, strategies as st

from latentpose_tpu.eval import arcface as jarcface
from latentpose_tpu.eval import backends as jbackends
from latentpose_tpu.eval import lpips as jlpips
from latentpose_tpu.eval import metrics as jmetrics
from latentpose_tpu.utils.weights import load_flat_npz_variables
from latentpose_tpu_torch.data.synthetic import render_face
from latentpose_tpu_torch.eval import arcface, backends, lpips, metrics
from latentpose_tpu_torch.ops import resize as resize_module
from latentpose_tpu_torch.ops.resize import resize_area, resize_cubic
from latentpose_tpu_torch.utils.weights import (flax_from_state_dict,
                                                load_flax_weights)

torch.set_num_threads(2)

CUBIC_TIE = 1e-3
ARCFACE_TOL = 2e-4
# a shallow, narrow tower at the published 112² input: stage 1's first unit
# takes the shortcut conv (16 != conv0's 64)
NARROW = dict(stage_blocks=(1, 2, 1, 1), stage_features=(16, 32, 32, 64))


@pytest.fixture
def ipp_off():
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(True)


def _images(shape, seed, n=2):
    return np.random.RandomState(seed).randint(
        0, 256, (n, *shape, 3)).astype(np.uint8)


def _cv2(images, size, interpolation):
    return np.stack([cv2.resize(im, size, interpolation=interpolation)
                     for im in images])


def _cubic_f64(images, size):
    """The cubic resize before rounding, in f64 (within ~1e-5 of the f32
    sums)."""
    (xi, xw), (yi, yw) = (resize_module._cubic_coefs(n_dst, n_src) for
                          n_dst, n_src in zip(size, images.shape[2:0:-1]))
    rows = np.einsum("bhwkc,wk->bhwc", images[:, :, xi].astype(np.float64),
                     xw.astype(np.float64))
    return np.einsum("bhkwc,hk->bhwc", rows[:, yi], yw.astype(np.float64))


def _check_cubic(hw, size, seed):
    images = _images(hw, seed)
    got = resize_cubic(torch.from_numpy(images), size).numpy()
    want = _cv2(images, size, cv2.INTER_CUBIC)
    diff = np.abs(got.astype(int) - want)
    raw = _cubic_f64(images, size)[diff > 0]
    print(f"cubic {hw}->{size[::-1]}: {(diff > 0).mean():.2e} of the values "
          f"differ, each by {diff.max()}, at {raw[:4]}")
    assert diff.max() <= 1
    assert np.all(np.abs(raw - np.floor(raw) - 0.5) < CUBIC_TIE)


# the harness's crops: 150² (256² frames) and 38² (64² frames) to ArcFace's
# 112² and the proxy's 16²; then odd shapes both ways
CASES = [((150, 150), (112, 112)), ((38, 38), (112, 112)),
         ((150, 150), (16, 16)), ((38, 38), (16, 16)),
         ((37, 53), (11, 13)), ((61, 29), (90, 17))]


@pytest.mark.parametrize("hw,size", CASES)
def test_resize_cubic_matches_cv2(hw, size):
    _check_cubic(hw, size, seed=sum(hw) + sum(size))


@pytest.mark.parametrize("hw,size", CASES)
def test_resize_cubic_within_a_level_of_cv2_own_code(hw, size, ipp_off):
    """cv2 without IPP: 11-bit weights, another rounding."""
    images = _images(hw, seed=1 + sum(hw))
    got = resize_cubic(torch.from_numpy(images), size).numpy()
    diff = np.abs(got.astype(int) - _cv2(images, size, cv2.INTER_CUBIC))
    print(f"cubic {hw}->{size[::-1]} against cv2 without IPP: "
          f"{(diff > 0).mean():.2e} of the values differ")
    assert diff.max() <= 1


@pytest.mark.parametrize("hw,size", [
    ((150, 150), (16, 16)), ((38, 38), (16, 16)), ((37, 53), (11, 13)),
    ((150, 150), (112, 112)),
    # integer factors: 2x2 (cv2's rounded shift) and 3x3, 4x2 (f32 scale)
    ((32, 32), (16, 16)), ((48, 48), (16, 16)), ((32, 64), (16, 16))])
def test_resize_area_bit_equal_to_cv2(hw, size):
    images = _images(hw, seed=2 + sum(hw))
    for ipp in (True, False):
        cv2.ipp.setUseIPP(ipp)
        want = _cv2(images, size, cv2.INTER_AREA)
        np.testing.assert_array_equal(
            resize_area(torch.from_numpy(images), size).numpy(), want)
    cv2.ipp.setUseIPP(True)


@settings(max_examples=20, deadline=None)
@given(h=st.integers(4, 96), w=st.integers(4, 96), oh=st.integers(2, 96),
       ow=st.integers(2, 96), seed=st.integers(0, 2**16))
def test_resizes_match_cv2_on_drawn_shapes(h, w, oh, ow, seed):
    _check_cubic((h, w), (ow, oh), seed)
    if oh <= h and ow <= w:
        images = _images((h, w), seed)
        np.testing.assert_array_equal(
            resize_area(torch.from_numpy(images), (ow, oh)).numpy(),
            _cv2(images, (ow, oh), cv2.INTER_AREA))


def test_resize_area_refuses_upscaling():
    with pytest.raises(ValueError, match="downscales only"):
        resize_area(torch.zeros((1, 8, 8, 3), dtype=torch.uint8), (16, 4))


# ------------------------------------------------------------------ metrics


def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    n, f = 4, 5
    gt = rng.randn(n, 512).astype(np.float32)
    gt /= np.linalg.norm(gt, axis=-1, keepdims=True)
    ours = rng.randn(n, n, f, 512).astype(np.float32)
    ours /= np.linalg.norm(ours, axis=-1, keepdims=True)
    assert metrics.identity_error(gt, ours) == pytest.approx(
        jmetrics.identity_error(gt, ours), abs=1e-12)
    lm_gt = rng.uniform(0, 256, (n, f, 68, 2)).astype(np.float32)
    lm = (lm_gt * 1.1 + rng.randn(n, f, 68, 2) * 3).astype(np.float32)
    for align in (False, True):
        assert metrics.pose_reconstruction_error(lm_gt, lm, align) == \
            pytest.approx(jmetrics.pose_reconstruction_error(
                lm_gt, lm, align), abs=1e-12)
    for got, want in zip(metrics.optimal_scale_shift(lm, lm_gt),
                         jmetrics.optimal_scale_shift(lm, lm_gt)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# ------------------------------------------------------------------ ArcFace


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _jax_shapes(module, shape=(1, 112, 112, 3)):
    return _flat(jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                jnp.zeros(shape, jnp.uint8)))


def seeded_flat(shapes, seed):
    """A flat npz dict of ``shapes`` from numpy's generator ``seed``:
    kernels at 1/sqrt(fan-in), BatchNorm drawn away from the identity,
    PReLU slopes in [0.1, 0.4]."""
    rng = np.random.RandomState(seed)
    out = {}
    for key in sorted(shapes):
        shape = shapes[key].shape
        leaf = key.rsplit("/", 1)[1]
        if key.startswith("batch_stats"):
            v = (rng.uniform(-0.3, 0.3, shape) if leaf == "mean"
                 else rng.uniform(0.5, 1.5, shape))
        elif leaf == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "bias":
            v = rng.uniform(-0.1, 0.1, shape)
        elif leaf == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        else:
            assert leaf == "alpha", key
            v = rng.uniform(0.1, 0.4, shape)
        out[key] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def arcface_npz(tmp_path_factory):
    """A narrow ArcFace's weights, written as ``arcface_r100.npz``."""
    path = tmp_path_factory.mktemp("arcface") / "arcface_r100.npz"
    np.savez(path, **seeded_flat(
        _jax_shapes(jarcface.ArcFaceR100(**NARROW)), 3))
    return path


def _faces(size, n=4, label=1):
    return np.stack([(render_face(label + i % 2, 3 * i, size)[0] * 255
                      + 0.5).astype(np.uint8) for i in range(n)])


def test_arcface_tower_matches_jax(arcface_npz):
    images = np.concatenate([_faces(112), _images((112, 112), 4)])
    want = np.asarray(jarcface.ArcFaceR100(**NARROW).apply(
        load_flat_npz_variables(str(arcface_npz)), jnp.asarray(images)))
    net = load_flax_weights(arcface.ArcFaceR100(**NARROW), str(arcface_npz))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(images)).numpy()
    assert got.shape == (len(images), 512)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ARCFACE_TOL * np.abs(want).max())
    np.testing.assert_allclose(
        arcface.normalize_embeddings(torch.tensor(want)).numpy(),
        np.asarray(jarcface.normalize_embeddings(want)), atol=1e-6)


def test_arcface_full_depth_keys_match_jax():
    """The published tower's flat keys and shapes, as the JAX package's
    ``init`` makes them (eval_shape: no forward), and back to itself."""
    want = {k: tuple(v.shape) for k, v in _jax_shapes(
        jarcface.ArcFaceR100()).items()}
    net = arcface.ArcFaceR100()
    flat = flax_from_state_dict(net)
    assert {k: v.shape for k, v in flat.items()} == want
    # stem 6; 49 units of 15, the 4 first ones' shortcut 5 more; head 10
    assert len(want) == 6 + 49 * 15 + 4 * 5 + 10
    load_flax_weights(net, flat)


def test_arcface_backend_matches_jax(arcface_npz, monkeypatch):
    import functools
    monkeypatch.setattr(jarcface, "ArcFaceR100",
                        functools.partial(jarcface.ArcFaceR100, **NARROW))
    monkeypatch.setattr(arcface, "ArcFaceR100",
                        functools.partial(arcface.ArcFaceR100, **NARROW))
    want_backend = jbackends.ArcFaceBackend(str(arcface_npz))
    got_backend = backends.ArcFaceBackend(str(arcface_npz), device="cpu")
    bbox = backends.get_default_bbox("latentpose")
    assert bbox == jbackends.get_default_bbox("latentpose")
    for size in (64, 256):      # crops of 38² (upscaled) and 150²
        frames = list(_faces(size)[..., ::-1])      # BGR, as cv2 reads
        want, _ = want_backend(frames, bbox)
        got, bad = got_backend(frames, bbox)
        assert bad == 0 and got.shape == (4, 512)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=ARCFACE_TOL * np.abs(want).max())
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   atol=1e-6)


@pytest.mark.parametrize("size", [64, 256])
def test_proxy_backends_match_jax(size):
    frames = list(_faces(size, n=3)[..., ::-1])
    bbox = jbackends.get_default_bbox("x2face")
    want, _ = jbackends.ProxyDescriptorBackend()(frames, bbox)
    got, _ = backends.ProxyDescriptorBackend()(frames, bbox)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    jlm = jbackends.ProxyLandmarkBackend()
    lm, ok = backends.ProxyLandmarkBackend()(np.stack(frames))
    assert ok and lm.shape == (3, 68, 2)
    np.testing.assert_allclose(lm, np.stack([jlm(f)[0] for f in frames]),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(backends.procedural_mean_face(size),
                                  jbackends.procedural_mean_face(size))


def test_factories_refuse_without_weights_and_take_the_proxies(tmp_path):
    for make in (backends.make_descriptor_backend,
                 backends.make_landmark_backend):
        with pytest.raises(FileNotFoundError, match="--allow_proxy_eval"):
            make(str(tmp_path), device="cpu")
    assert isinstance(backends.make_descriptor_backend(
        str(tmp_path), allow_proxy=True, device="cpu"),
        backends.ProxyDescriptorBackend)
    assert isinstance(backends.make_landmark_backend(
        str(tmp_path), allow_proxy=True, device="cpu"),
        backends.ProxyLandmarkBackend)


# -------------------------------------------------------------------- LPIPS


def _pairs(size=64, n=3):
    rng = np.random.RandomState(5)
    a = rng.rand(n, size, size, 3).astype(np.float32)
    b = np.clip(a + rng.randn(*a.shape).astype(np.float32) * 0.1, 0, 1)
    return a, b


def test_lpips_unarmed_tower_matches_jax(tmp_path):
    a, b = _pairs()
    want_fn, want_armed = jlpips.lpips_fn(str(tmp_path), allow_random=True)
    got_fn, armed = lpips.lpips_fn(str(tmp_path), allow_random=True,
                                   device="cpu")
    assert armed is False and want_armed is False
    want = np.asarray(want_fn(jnp.asarray(a), jnp.asarray(b)))
    got = got_fn(a, b).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    with pytest.raises(FileNotFoundError, match="allow_random"):
        lpips.load_lpips_params(str(tmp_path), device="cpu")


def test_lpips_weights_file_matches_jax(tmp_path):
    rng = np.random.RandomState(6)
    flat, in_ch = {}, 3
    for i, (out_ch, k, *_rest) in enumerate(lpips._ALEX_PLAN):
        flat[f"conv{i}/kernel"] = (rng.randn(k, k, in_ch, out_ch)
                                   / np.sqrt(k * k * in_ch)).astype(np.float32)
        flat[f"conv{i}/bias"] = rng.uniform(-0.1, 0.1, out_ch) \
            .astype(np.float32)
        # some negative lins: both clamp them at 0
        flat[f"lin{i}/weight"] = rng.uniform(-0.5, 1.0, out_ch) \
            .astype(np.float32) / out_ch
        in_ch = out_ch
    np.savez(tmp_path / lpips.WEIGHTS_FILE, **flat)
    a, b = _pairs(size=96)
    want_fn, want_armed = jlpips.lpips_fn(str(tmp_path))
    got_fn, armed = lpips.lpips_fn(str(tmp_path), device="cpu")
    assert armed and want_armed
    want = np.asarray(want_fn(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got_fn(a, b).numpy(), want, rtol=1e-4)
    assert np.all(want > 0)
    np.testing.assert_allclose(got_fn(a, a).numpy(), 0.0, atol=1e-7)


# ---------------------------------------------------------------- the CLIs

IDENTITIES = ["idA/vid1", "idB/vid2"]
NUM_FRAMES = 4
SIZE = 64


def _render(identity_idx, frame):
    return (render_face(identity_idx + 1, frame, SIZE)[0] * 255) \
        .astype(np.uint8)


def _write_results(results_root, render_result):
    """The driving-results tree: per identity and driver an mp4 of
    driver | reenactment, render_result(i, j, f) -> uint8 RGB."""
    for i, ident in enumerate(IDENTITIES):
        res_dir = results_root / (ident.replace("/", "_") + "_identity") \
            / "driving-results"
        res_dir.mkdir(parents=True)
        for j, driver in enumerate(IDENTITIES):
            path = res_dir / (driver.replace("/", "_") + "_driver.mp4")
            writer = cv2.VideoWriter(
                str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25,
                (2 * SIZE, SIZE))
            assert writer.isOpened()
            for f in range(NUM_FRAMES):
                side = np.concatenate([_render(j, f), render_result(i, j, f)],
                                      axis=1)
                writer.write(side[..., ::-1])
            writer.release()


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    """tests/test_eval_harness_e2e.py's tree (JPEG frames), with masks that
    erase: idA's grey PNGs (cv2 reads them as 3 channels; mid values make
    the erase truncate), idB's colour PNGs with one file missing (that
    frame stays whole); reenactments leaking 30 % of the driver."""
    root = tmp_path_factory.mktemp("evaltree")
    data_root = root / "data"
    yy, xx = np.mgrid[:SIZE, :SIZE]
    oval = ((yy - 30) / 26.0) ** 2 + ((xx - 32) / 20.0) ** 2
    for i, ident in enumerate(IDENTITIES):
        for sub in ("identity", "driver"):
            img_dir = data_root / "images-cropped" / ident / sub
            segm_dir = data_root / "segmentation-cropped" / ident / sub
            img_dir.mkdir(parents=True)
            segm_dir.mkdir(parents=True)
            for f in range(NUM_FRAMES):
                cv2.imwrite(str(img_dir / f"{f:03d}.jpg"),
                            _render(i, f + 7 * (sub == "driver"))[..., ::-1])
                mask = np.clip((1.2 - oval) * 255, 0, 255).astype(np.uint8)
                if i == 1 and f == 2:
                    continue
                cv2.imwrite(str(segm_dir / f"{f:03d}.png"),
                            mask if i == 0 else np.stack([mask] * 3, -1))
    results = root / "results"
    _write_results(results, lambda i, j, f: np.clip(
        0.7 * _render(i, f + 7).astype(np.float32)
        + 0.3 * _render(j, f + 7).astype(np.float32), 0, 255)
        .astype(np.uint8))
    return data_root, results


def _eval_argv(data_root, results_root):
    return ["--results_root", str(results_root), "--data_root",
            str(data_root), "--identities", *IDENTITIES, "--num_frames",
            str(NUM_FRAMES), "--image_size", str(SIZE),
            "--eval_weights_dir", "", "--allow_proxy_eval"]


def _caches(results_root):
    return {p.relative_to(results_root): np.load(p)
            for p in sorted(results_root.rglob("*.npy"))}


def _same_numbers(got, want, atol):
    assert set(got) == set(want)
    for key in want:
        assert np.isfinite(got[key]), key
        assert got[key] == pytest.approx(want[key], abs=atol), key


def test_cli_matches_jax(eval_tree, tmp_path, capsys):
    import shutil
    from latentpose_tpu.cli import compute_pose_identity_error as jcli
    from latentpose_tpu_torch.cli import compute_pose_identity_error as tcli
    data_root, results = eval_tree
    roots = {}
    for who in ("jax", "port"):
        roots[who] = tmp_path / who
        shutil.copytree(results, roots[who])
    want = jcli.main(_eval_argv(data_root, roots["jax"]))
    capsys.readouterr()
    got = tcli.main(_eval_argv(data_root, roots["port"]) + ["--device",
                                                            "cpu"])
    lines = capsys.readouterr().out.splitlines()
    _same_numbers(got, want, 1e-6)
    assert 0.0 < want["identity_error"] < 1.0
    assert [ln.split(":")[0] for ln in lines[-3:]] == [
        "Identity error", "Pose reconstruction error",
        "Pose reconstruction error (with optimal alignment)"]
    want_caches, got_caches = _caches(roots["jax"]), _caches(roots["port"])
    assert set(got_caches) == set(want_caches) and len(want_caches) == 6
    for key, value in want_caches.items():
        np.testing.assert_allclose(got_caches[key], value, rtol=0,
                                   atol=1e-5, err_msg=str(key))

    # a second run reads its caches: the videos are gone, no backend runs
    for ident in IDENTITIES:
        shutil.rmtree(roots["port"] / (ident.replace("/", "_") + "_identity")
                      / "driving-results")
    timer = backends.StageTimer()
    again = tcli.main(_eval_argv(data_root, roots["port"])
                      + ["--device", "cpu"], timer)
    assert again == got
    assert set(timer.seconds) == set(timer.calls) == {"metrics"}


def test_cli_reads_frame_directories(eval_tree, tmp_path):
    """The form the port's drive writes without a video encoder:
    ``<name>.mp4.frames/`` PNGs holding the frames cv2 decodes."""
    import shutil
    from latentpose_tpu_torch.cli import compute_pose_identity_error as tcli
    from latentpose_tpu_torch.utils.png import write_png
    data_root, results = eval_tree
    videos, frames = tmp_path / "videos", tmp_path / "frames"
    shutil.copytree(results, videos)
    shutil.copytree(results, frames)
    for mp4 in sorted(frames.rglob("*.mp4")):
        out = mp4.parent / (mp4.name + ".frames")
        out.mkdir()
        cap = cv2.VideoCapture(str(mp4))
        for k in range(NUM_FRAMES + 1):      # the tail frame is ignored
            ok, image = cap.read()
            if not ok:
                image = np.zeros((SIZE, 2 * SIZE, 3), np.uint8)
            write_png(out / f"{k:06d}.png", image[..., ::-1])
        cap.release()
        mp4.unlink()
    want = tcli.main(_eval_argv(data_root, videos) + ["--device", "cpu"])
    got = tcli.main(_eval_argv(data_root, frames) + ["--device", "cpu"])
    assert got == want


def test_cli_refuses_cuda_without_a_card(eval_tree, tmp_path):
    from latentpose_tpu_torch.cli import compute_pose_identity_error as tcli
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(_eval_argv(eval_tree[0], tmp_path))


def test_batched_drive_child_refuses_cuda_without_a_card(eval_tree,
                                                         tmp_path):
    """A child on its default ``--device cuda`` with no card fails, and
    the sweep with it: nothing falls back to the CPU."""
    import subprocess
    from latentpose_tpu_torch.cli import batched_drive as tbd
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _tiny_finetuned(tmp_path / "sweep" / "idA_vid1_identity")
    with pytest.raises(subprocess.CalledProcessError):
        tbd.main(["--puppeteering_dir", str(tmp_path / "sweep"),
                  "--data_root", str(eval_tree[0]), "--drivers",
                  "idA/vid1/driver", "--extra_args", "--destination",
                  str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def _fake_checkpoint(root):
    path = root / "meta" / "checkpoints" / "model_00000010.ckpt"
    path.mkdir(parents=True)
    (path / "meta.json").write_text("{}")
    return path


def _entry(command, entry):
    """A command (list or shell string) with the JAX script in place of the
    port's module."""
    module = f"latentpose_tpu_torch.cli.{entry}"
    if isinstance(command, str):
        return command.replace(f"-m {module}", f"{entry}.py")
    assert command[1:3] == ["-m", module], command
    return [command[0], f"{entry}.py", *command[3:]]


@pytest.mark.parametrize("template", ["", "sbatch -J {name} -o {log} "
                                          "--wrap {cmd}"])
def test_batched_finetune_dry_run_matches_jax(eval_tree, tmp_path, template):
    from latentpose_tpu.cli import batched_finetune as jbf
    from latentpose_tpu_torch.cli import batched_finetune as tbf
    data_root, _ = eval_tree
    ckpt = _fake_checkpoint(tmp_path)
    argv = ["--model", str(ckpt), "--data_root", str(data_root),
            "--identities", *[f"{i}/identity" for i in IDENTITIES],
            "--output_dir", str(tmp_path / "puppeteering"),
            "--target_iterations", "8", "--max_batch_size", "3",
            "--submit_template", template, "--dry_run",
            "--extra_args", "--device", "cpu"]
    # one identity already fine-tuned: skipped by both
    done = (tmp_path / "puppeteering" / "meta_model_00000010.ckpt"
            / "idB_vid2_identity" / "checkpoints")
    done.mkdir(parents=True)
    (done / "model_00000001.ckpt").mkdir()
    want = jbf.main(argv)
    got = tbf.main(argv)
    assert len(want) == 1
    assert [_entry(c, "train") for c in got] == want
    text = " ".join(got[0]) if not template else got[0]
    assert "-m latentpose_tpu_torch.cli.train" in text
    assert "--num_epochs 8" in text and "--batch_size 3" in text


def _tiny_finetuned(experiment_dir):
    """A fine-tuned flagship-family checkpoint at SIZE² with tiny generator
    widths, written by the port."""
    import types
    from latentpose_tpu_torch import checkpoint as ckpt_lib
    from latentpose_tpu_torch import convert, registry
    args = dict(
        generator="vector_pose_unsupervised_segmentation_noBottleneck",
        embedder="unsupervised_pose_separate_embResNeXt_segmentation",
        discriminator="no_landmarks", image_size=SIZE, in_channels=3,
        out_channels=3, num_channels=4, max_num_channels=16,
        embed_channels=16, pose_embedding_size=8, gen_padding="zero",
        gen_constant_input_size=4, gen_num_residual_blocks=1,
        norm_layer="in", average_function="sum", compute_dtype="float32",
        num_devices=1, random_seed=0, finetune=True, iteration=0,
        data_root="", img_dir="images-cropped")
    ns = types.SimpleNamespace(**args)
    g = torch.Generator().manual_seed(0)
    flat = {"step": np.zeros((), np.int32)}
    for part in ("embedder", "generator"):
        net = registry.load_wrapper(f"{part}s", args[part]).get_net(
            ns, generator=g)
        flat.update(convert.export(net, part))
    identity = torch.rand(1, 16, generator=g).numpy()
    flat["params::finetune_embedding"] = identity
    flat["ema_params::finetune_embedding"] = identity
    return ckpt_lib.save_checkpoint(experiment_dir, flat, args, iteration=4,
                                    finetune=True)


def test_batched_drive_composes_into_eval(eval_tree, tmp_path):
    """batched_finetune's layout -> batched_drive (dry run against the JAX
    CLI's commands, then one run of the port's drive on the CPU) ->
    compute_pose_identity_error, in both packages."""
    import shutil
    from latentpose_tpu.cli import batched_drive as jbd
    from latentpose_tpu.cli import compute_pose_identity_error as jcli
    from latentpose_tpu_torch.cli import batched_drive as tbd
    from latentpose_tpu_torch.cli import compute_pose_identity_error as tcli
    data_root, _ = eval_tree
    sweep = tmp_path / "puppeteering" / "meta_model_00000010.ckpt"
    for ident in IDENTITIES:
        avatar = sweep / (ident.replace("/", "_") + "_identity")
        _tiny_finetuned(avatar)
        (avatar / "checkpoints" / "model_00000001.ckpt").mkdir()  # older
    argv = ["--puppeteering_dir", str(sweep), "--data_root", str(data_root),
            "--drivers", *[f"{i}/driver" for i in IDENTITIES],
            "--extra_args", "--device", "cpu", "--compute_dtype", "float32"]
    want = jbd.main(["--dry_run", *argv])
    assert [_entry(c, "drive") for c in tbd.main(["--dry_run", *argv])] \
        == want
    assert all(c[2].endswith("model_00000004.ckpt") for c in want)

    tbd.main(argv)
    for ident in IDENTITIES:
        results = sweep / (ident.replace("/", "_") + "_identity") \
            / "driving-results"
        assert sorted(p.name for p in results.iterdir()) == [
            "idA_vid1_driver.mp4", "idB_vid2_driver.mp4"]
    shutil.copytree(sweep, tmp_path / "jax_copy")
    got = tcli.main(_eval_argv(data_root, sweep) + ["--device", "cpu"])
    _same_numbers(got, jcli.main(_eval_argv(data_root,
                                            tmp_path / "jax_copy")), 1e-6)
