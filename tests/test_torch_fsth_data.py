"""PyTorch port, the FSTH family's data held against the JAX package: the
stickman rasterizer (``csrc/stickman.cpp``) against ``cv2.polylines`` and
the JAX package's renders, the synthetic source's keypoints and stickmen,
and the three landmark datasets (``voxceleb2``, ``voxceleb2_segm``,
``voxceleb2_FSTH_crop``) against the JAX datasets on a tree of PNG frames,
``.npy`` keypoints and masks written here, f32 and on the uint8 wire.

Stickmen and keypoints are bit-equal.  Images are bit-equal where the
resize is INTER_AREA; where it is INTER_CUBIC the port computes what cv2's
x86 wheel computes through IPP, equal except on .5 ties (ROADMAP C.5,
``tests/test_torch_eval.py``): there a value may sit one level off, on at
most CUBIC_TIES of the values."""

import types

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from latentpose_tpu.data import synthetic as jsynthetic
from latentpose_tpu.data import voxceleb2 as jvox
from latentpose_tpu.data import voxceleb2_FSTH_crop as jvox_crop
from latentpose_tpu.data import voxceleb2_segm as jvox_segm
from latentpose_tpu_torch.data import synthetic as tsynthetic
from latentpose_tpu_torch.data import voxceleb2 as tvox
from latentpose_tpu_torch.data import voxceleb2_FSTH_crop as tvox_crop
from latentpose_tpu_torch.data import voxceleb2_segm as tvox_segm
from latentpose_tpu_torch.data.common import voxceleb as tvoxceleb
from latentpose_tpu_torch.data.native_loader import draw_polylines
from latentpose_tpu_torch.runners.loop import (dequantize_batch_host,
                                               quantize_batch_u8)

CUBIC_TIES = 1e-3       # of a cubic-resized image's values
IDENTITIES = ("id00001/vidA", "id00001/vidB", "id00002/vidA")
FRAMES = 5
SOURCE = 48             # the tree's frames: 48², resized up (cubic) or down
COLOR = (255, 7, 9)


def _cv2_polylines(h, w, pts, closed, thickness):
    canvas = np.zeros((h, w, 3), np.uint8)
    cv2.polylines(canvas, [np.asarray(pts, np.int32)], closed, COLOR,
                  thickness=thickness)
    return canvas


def _port_polylines(h, w, pts, closed, thickness):
    return draw_polylines(np.zeros((h, w, 3), np.uint8),
                          [(np.asarray(pts), closed, COLOR)], thickness)


@st.composite
def _polylines(draw):
    """68-point sets on canvases of 1-96 pixels a side, up to 100 pixels
    off the canvas, with runs of coincident points."""
    h, w = draw(st.integers(1, 96)), draw(st.integers(1, 96))
    n = draw(st.sampled_from([1, 2, 3, 5, 17, 68]))
    coord = st.integers(-100, 196)
    pts = draw(st.lists(st.tuples(coord, coord), min_size=n, max_size=n))
    repeats = draw(st.lists(st.integers(0, n - 1), max_size=4))
    for i in repeats:       # a segment whose two ends coincide
        pts[min(i + 1, n - 1)] = pts[i]
    return h, w, pts, draw(st.booleans()), draw(st.sampled_from([2, 2, 3]))


@settings(max_examples=400, deadline=None)
@given(_polylines())
def test_polylines_are_bit_equal_to_cv2(case):
    h, w, pts, closed, thickness = case
    np.testing.assert_array_equal(
        _port_polylines(h, w, pts, closed, thickness),
        _cv2_polylines(h, w, pts, closed, thickness))


def test_polylines_far_off_the_canvas_are_bit_equal_to_cv2():
    rng = np.random.RandomState(0)
    for trial in range(300):
        h, w = rng.randint(1, 200, 2)
        pts = rng.randint(-100000, 100000, size=(rng.randint(2, 20), 2))
        closed, thickness = bool(trial % 2), 2 + trial % 2
        np.testing.assert_array_equal(
            _port_polylines(int(h), int(w), pts, closed, thickness),
            _cv2_polylines(int(h), int(w), pts, closed, thickness))


def test_stickman_refuses_a_thin_line():
    with pytest.raises(ValueError, match="thickness"):
        _port_polylines(8, 8, [(1, 1), (5, 5)], False, 1)


@pytest.mark.parametrize("size", [32, 64, 256])
def test_synthetic_stickmen_and_keypoints_equal_the_jax_renders(size):
    for label in range(3):
        for frame in (0, 7, 19, 31, 45):
            np.testing.assert_array_equal(
                tsynthetic.synthetic_keypoints(label, frame, size),
                jsynthetic.synthetic_keypoints(label, frame, size))
            for name in ("render_stickman", "render_stickman_u8"):
                got = getattr(tsynthetic, name)(label, frame, size)
                want = getattr(jsynthetic, name)(label, frame, size)
                assert got.dtype == want.dtype, name
                np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("finetune", [False, True], ids=["meta", "finetune"])
@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_synthetic_stickmen_batches_equal_the_jax_loader(finetune, wire):
    kwargs = dict(batch_size=3, num_labels=4, num_enc_frames=2,
                  finetune=finetune, seed=3, wire_dtype=wire)
    jax_loader = jsynthetic.SyntheticDataLoader(image_size=32, stickmen=True,
                                                **kwargs)
    port_loader = tsynthetic.SyntheticDataLoader(32, stickmen=True, **kwargs)
    for it in range(2):
        want, got = jax_loader.get_batch(it), port_loader.get_batch(it)
        for w, g in zip(want, got):
            assert set(g) == set(w)
            for key in w:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert {"enc_stickmen", "dec_stickmen", "dec_keypoints"} <= set(got[0])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A pre-cropped tree: 48² PNG frames, (68, 3) f32 keypoints and PNG
    masks (the second video's as ``.png.npy``) for three videos."""
    root = tmp_path_factory.mktemp("landmark_tree")
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:SOURCE, 0:SOURCE]
    for v, path in enumerate(IDENTITIES):
        for f in range(FRAMES):
            name = f"{f:05d}"
            for sub in ("images-cropped", "keypoints-cropped",
                        "segmentation-cropped"):
                (root / sub / path).mkdir(parents=True, exist_ok=True)
            smooth = np.stack([np.sin(xx / (5.0 + c + v) + f)
                               * np.cos(yy / (7.0 + c)) for c in range(3)],
                              -1)
            image = np.clip(127.5 + 100 * smooth
                            + rng.normal(0, 10, smooth.shape), 0, 255)
            cv2.imwrite(str(root / "images-cropped" / path / f"{name}.png"),
                        image.astype(np.uint8))
            kp = np.concatenate(
                [rng.uniform(-4, SOURCE + 4, (68, 2)),
                 rng.uniform(0, 1, (68, 1))], 1).astype(np.float32)
            np.save(root / "keypoints-cropped" / path / f"{name}.npy", kp)
            mask = (rng.uniform(0, 1, (SOURCE, SOURCE)) * 255).astype(
                np.uint8)
            base = root / "segmentation-cropped" / path
            if v == 1:
                np.save(base / f"{name}.png.npy",
                        np.stack([mask, mask, mask], -1))
            else:
                cv2.imwrite(str(base / f"{name}.png"),
                            np.stack([mask // 2, mask, mask // 3], -1))
    return root


def _args(root, image_size, wire="float32", finetune=False):
    return types.SimpleNamespace(
        data_root=str(root), img_dir="images-cropped",
        kp_dir="keypoints-cropped", segm_dir="segmentation-cropped",
        train_split_path="none.csv",
        val_split_path=IDENTITIES[0] if finetune else "none.csv",
        finetune=finetune, checkpoint_path="", num_labels=0, inference=False,
        n_frames_for_encoder=2, image_size=image_size, batch_size=3,
        random_seed=0, num_workers=2, prefetch_size=4, draw_oval=True,
        transfer_dtype=wire)


LOADERS = {"voxceleb2": (jvox, tvox), "voxceleb2_segm": (jvox_segm,
                                                         tvox_segm),
           "voxceleb2_FSTH_crop": (jvox_crop, tvox_crop)}


def _first_batch(wrapper, args):
    """The first batch of the val part (deterministic frames)."""
    loader = wrapper.get_dataloader(args, "val", "val")
    data, target = next(iter(loader))
    return {**data, **target}


def _assert_images(got, want, cubic, key):
    if not cubic:
        np.testing.assert_array_equal(got, want, err_msg=key)
        return
    diff = np.abs(np.rint(got * 255).astype(int) - np.rint(want * 255)
                  .astype(int))
    assert diff.max() <= 1, key
    assert (diff > 0).mean() <= CUBIC_TIES, (key, (diff > 0).mean())


@pytest.mark.parametrize("image_size", [64, 32], ids=["cubic", "area"])
@pytest.mark.parametrize("name", sorted(LOADERS))
def test_landmark_loader_matches_the_jax_loader(tree, name, image_size):
    jmod, tmod = LOADERS[name]
    want = _first_batch(jmod.Wrapper, _args(tree, image_size))
    got = _first_batch(tmod.Wrapper, _args(tree, image_size))
    assert set(got) == set(want)
    assert ("real_segm" in got) == (name == "voxceleb2_segm")
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key in ("enc_rgbs", "pose_input_rgbs", "target_rgbs"):
            _assert_images(g, w, image_size > 38, key)
        else:       # stickmen, keypoints, masks, labels
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_landmark_loader_fine_tune_branch_matches_the_jax_loader(tree, name):
    jmod, tmod = LOADERS[name]
    want = _first_batch(jmod.Wrapper, _args(tree, 32, finetune=True))
    got = _first_batch(tmod.Wrapper, _args(tree, 32, finetune=True))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_landmark_loader_on_the_wire_is_the_f32_batch(tree, name):
    """The wire's uint8 batch is the host quantize of the f32 batch, so
    dequantized it is bit-equal to what the f32 batch gives the step."""
    _, tmod = LOADERS[name]
    f32 = _first_batch(tmod.Wrapper, _args(tree, 32))
    u8 = _first_batch(tmod.Wrapper, _args(tree, 32, wire="uint8"))
    for key in ("enc_rgbs", "enc_stickmen", "pose_input_rgbs",
                "dec_stickmen", "target_rgbs"):
        assert u8[key].dtype == np.uint8, key
    quantized = quantize_batch_u8(f32)
    for key in f32:
        np.testing.assert_array_equal(u8[key], quantized[key], err_msg=key)
        np.testing.assert_array_equal(dequantize_batch_host(u8)[key],
                                      dequantize_batch_host(quantized)[key],
                                      err_msg=key)


def test_stickman_draws_every_part_in_its_colour():
    kp = tsynthetic.synthetic_keypoints(0, 3, 64)
    for oval in (True, False):
        parts = ([tvoxceleb.STICKMAN_OVAL] if oval else []) \
            + tvoxceleb.STICKMAN_PARTS
        stick = tvoxceleb.draw_stickman((64, 64), kp, parts)
        colours = {tuple(c) for c in stick.reshape(-1, 3)}
        assert ((255, 255, 255) in colours) == oval
        assert {(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 0, 255),
                (0, 255, 255), (255, 255, 0)} <= colours
