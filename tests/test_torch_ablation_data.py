"""PyTorch port, the second half of the ablation families' data held
against the JAX package: the X2Face dataset (``voxceleb2_X2Face``) and the
flagship's dataset with VoxCeleb1 pose crops
(``voxceleb2_segmentation_nolandmarks_X2Face_FAbNet_crops``), both crop
types, the meta and fine-tune branches and the uint8 wire, on a tree of
PNG frames, PNG masks and a bboxes dict written here; and the FFHQ crop
(``preprocess/croppers.py``) on 68-point sets whose crops stay inside the
frame or leave it on any side.

Frames are bit-equal where the JAX package resizes with INTER_AREA and its
crop needs no padding.  Where it resizes with INTER_CUBIC the port computes
what cv2's x86 wheel computes through IPP, equal except on .5 ties
(``tests/test_torch_fsth_data.py``).  A crop that needs padding (blurred
and faded), which the JAX package computes with cv2 and the port in C++
(``csrc/lpr_loader.cpp``), is held to the JAX suite's own bound for its
C++ crop against cv2 (``tests/test_torch_data.py``: 3.5/255 at most,
0.5/255 on average).  The FFHQ crop: within 2 levels of the JAX cropper
with at least 99 % of values equal, landmarks within 1e-4."""

import types

import cv2
import numpy as np
import pytest

from latentpose_tpu.data import voxceleb2_X2Face as jx2
from latentpose_tpu.data import \
    voxceleb2_segmentation_nolandmarks_X2Face_FAbNet_crops as jmixed
from latentpose_tpu.preprocess import croppers as jcroppers
from latentpose_tpu_torch.data import voxceleb2_X2Face as tx2
from latentpose_tpu_torch.data import \
    voxceleb2_segmentation_nolandmarks_X2Face_FAbNet_crops as tmixed
from latentpose_tpu_torch.preprocess import croppers as tcroppers
from latentpose_tpu_torch.runners.loop import quantize_batch_u8
from test_torch_data import MAX_ERR, MEAN_ERR
from test_torch_data import private_jax_loader  # noqa: F401 (autouse)
from test_torch_fsth_data import CUBIC_TIES

SOURCE = 48
FRAMES = 4
# video -> its 256-space box (None: no entry in the dict)
VIDEOS = {"id00001/vidA": (60.0, 50.0, 200.0, 210.0),     # inside
          "id00001/vidB": (-20.0, -10.0, 120.0, 150.0),   # over the border
          "id00002/vidA": None}                           # the central box
PADDED = {"id00001/vidB"}       # whose VoxCeleb1 crops leave the frame
LOADERS = {"voxceleb2_X2Face": (jx2, tx2),
           "mixed_crops": (jmixed, tmixed)}
FFHQ_LEVELS = 2
FFHQ_EQUAL = 0.99
LANDMARK_ATOL = 1e-4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """48² PNG frames, PNG masks and the bboxes dict of three videos."""
    root = tmp_path_factory.mktemp("x2face_tree")
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:SOURCE, 0:SOURCE]
    boxes = {}
    for v, (path, box) in enumerate(VIDEOS.items()):
        for sub in ("images-cropped", "segmentation-cropped"):
            (root / sub / path).mkdir(parents=True, exist_ok=True)
        for f in range(FRAMES):
            smooth = np.stack([np.sin(xx / (5.0 + c + v) + f)
                               * np.cos(yy / (7.0 + c)) for c in range(3)],
                              -1)
            image = np.clip(127.5 + 100 * smooth
                            + rng.normal(0, 10, smooth.shape), 0, 255)
            cv2.imwrite(str(root / "images-cropped" / path / f"{f:05d}.png"),
                        image.astype(np.uint8))
            mask = (rng.uniform(0, 1, (SOURCE, SOURCE)) * 255).astype(
                np.uint8)
            cv2.imwrite(str(root / "segmentation-cropped" / path
                            / f"{f:05d}.png"),
                        np.stack([mask // 2, mask, mask // 3], -1))
        if box is not None:
            identity, video = path.split("/")
            boxes.setdefault(identity, {})[video] = np.tile(
                np.asarray(box, np.float32), (FRAMES, 1))
    np.save(root / "bboxes.npy", boxes)
    return root


def _args(root, image_size, crop_type="x2face", wire="float32",
          finetune=False):
    return types.SimpleNamespace(
        data_root=str(root), img_dir="images-cropped",
        kp_dir="keypoints-cropped", segm_dir="segmentation-cropped",
        bboxes_dir=str(root / "bboxes.npy"), train_split_path="none.csv",
        val_split_path="id00001/vidB" if finetune else "none.csv",
        finetune=finetune, checkpoint_path="", num_labels=0, inference=False,
        n_frames_for_encoder=2, image_size=image_size, batch_size=3,
        random_seed=0, num_workers=2, prefetch_size=4, draw_oval=True,
        transfer_dtype=wire, voxceleb1_crop_type=crop_type)


def _first_batch(wrapper, args):
    """The first batch of the val part (deterministic frames)."""
    loader = wrapper.get_dataloader(args, "val", "val")
    data, target = next(iter(loader))
    return {**data, **target}


def _assert_frames(got, want, key, exact, cubic=False):
    if cubic:
        diff = np.abs(np.rint(got * 255).astype(int)
                      - np.rint(want * 255).astype(int))
        assert diff.max() <= 1, key
        assert (diff > 0).mean() <= CUBIC_TIES, (key, (diff > 0).mean())
    elif exact:
        np.testing.assert_array_equal(got, want, err_msg=key)
    else:
        diff = np.abs(got - want)
        assert diff.max() <= MAX_ERR and diff.mean() <= MEAN_ERR, \
            (key, diff.max() * 255, diff.mean() * 255)


def _assert_batches(got, want, name, image_size, paths):
    assert set(got) == set(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape and g.dtype == w.dtype, key
        for i, path in enumerate(paths):
            if key == "label":
                assert g[i] == w[i]
            elif key == "pose_input_rgbs" or (
                    name == "voxceleb2_X2Face" and key == "target_rgbs"):
                _assert_frames(g[i], w[i], key, path not in PADDED)
            elif name == "voxceleb2_X2Face":      # the identity frames
                _assert_frames(g[i], w[i], key, True, image_size > SOURCE)
            else:   # the flagship's x1.8 crops, padded on every video
                _assert_frames(g[i], w[i], key, False)


@pytest.mark.parametrize("crop_type", ["x2face", "fabnet"])
@pytest.mark.parametrize("image_size", [64, 32], ids=["cubic", "area"])
@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_matches_the_jax_loader(tree, name, image_size, crop_type):
    jmod, tmod = LOADERS[name]
    args = _args(tree, image_size, crop_type)
    want = _first_batch(jmod.Wrapper, args)
    got = _first_batch(tmod.Wrapper, _args(tree, image_size, crop_type))
    assert ("real_segm" in got) == (name == "mixed_crops")
    _assert_batches(got, want, name, image_size, list(VIDEOS))


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_fine_tune_branch_matches_the_jax_loader(tree, name):
    jmod, tmod = LOADERS[name]
    want = _first_batch(jmod.Wrapper, _args(tree, 32, finetune=True))
    got = _first_batch(tmod.Wrapper, _args(tree, 32, finetune=True))
    assert list(got["label"]) == [0, 0, 0]
    _assert_batches(got, want, name, 32, ["id00001/vidB"] * 3)


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_on_the_wire_is_the_f32_batch(tree, name):
    """The wire's uint8 batch is the host quantize of the f32 batch; the
    mixed-crop dataset's target is the flagship's on the wire: the JAX
    dataset's ``_masked_target`` of the uint8 driver crop and mask."""
    _, tmod = LOADERS[name]
    f32 = _first_batch(tmod.Wrapper, _args(tree, 32))
    wire = tmod.Wrapper.get_dataloader(_args(tree, 32, wire="uint8"), "val",
                                       "val")
    data, target = next(iter(wire))
    u8 = {**data, **target}
    for key in ("enc_rgbs", "pose_input_rgbs", "target_rgbs"):
        assert u8[key].dtype == np.uint8, key
    quantized = quantize_batch_u8(f32)
    for key in f32:
        if name == "mixed_crops" and key == "target_rgbs":
            continue
        np.testing.assert_array_equal(u8[key], quantized[key], err_msg=key)
    if name == "mixed_crops":
        loader = wire.dataset.loader
        for i, path in enumerate(VIDEOS):
            driver = loader.list_ids(path, 3)[-1]
            image = loader.load_images(path, [driver], 32)
            np.testing.assert_array_equal(
                u8["target_rgbs"][i], np.floor(
                    image.astype(np.float32) * u8["real_segm"][i]
                    .astype(np.float32) / 255.0 + 0.5).astype(np.uint8))


def test_voxceleb1_boxes_match_jax():
    rng = np.random.RandomState(1)
    for raw in [None] + [rng.uniform(-40, 300, 4) for _ in range(20)]:
        for crop_type in ("x2face", "fabnet"):
            assert tx2.voxceleb1_bbox(raw, crop_type) \
                == jx2.voxceleb1_bbox(raw, crop_type)


# --- the FFHQ crop ------------------------------------------------------------

def _face_landmarks(rng, cx, cy, size):
    """68 points shaped as a face (eyes 36-47, mouth corners 48 and 54)
    around (cx, cy), with a z column."""
    lm = rng.uniform(-0.3, 0.3, (68, 2)) * size
    lm[36:42] += [-0.3 * size, -0.2 * size]
    lm[42:48] += [0.3 * size, -0.2 * size]
    lm[48] += [-0.2 * size, 0.4 * size]
    lm[54] += [0.2 * size, 0.4 * size]
    lm += [cx, cy]
    z = rng.uniform(-5, 5, (68, 1))
    return np.concatenate([lm, z], 1).astype(np.float32)


# (frame h, w, face centre x, y, size): inside, over each border, larger
# than the frame, a small face in a large frame (the area resize)
FFHQ_CASES = [(120, 100, 50, 60, 30), (120, 100, 8, 60, 40),
              (120, 100, 50, 6, 40), (120, 100, 95, 60, 40),
              (120, 100, 50, 115, 40), (64, 80, 40, 32, 90),
              (200, 180, 90, 100, 20), (90, 90, 45, 45, 12)]


@pytest.mark.parametrize("case", FFHQ_CASES)
def test_ffhq_crop_matches_the_jax_cropper(case):
    h, w, cx, cy, size = case
    rng = np.random.RandomState(sum(case))
    yy, xx = np.mgrid[0:h, 0:w]
    image = np.clip(127 + 100 * np.stack(
        [np.sin(xx / (5.0 + c)) * np.cos(yy / 7.0) for c in range(3)], -1)
        + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)
    lm = _face_landmarks(rng, cx, cy, size)
    jcropper = jcroppers.FFHQFaceCropper((64, 64), None,
                                         lambda img, bbox=None: lm)
    tcropper = tcroppers.FFHQFaceCropper(
        (64, 64), None, lambda imgs: np.repeat(lm[None], len(imgs), 0),
        "cpu")
    want, want_lm = jcropper.crop_image(image)
    got, got_lm = tcropper.crop_images(image[None])
    got, got_lm = got[0], got_lm[0]
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= FFHQ_LEVELS, diff.max()
    assert (diff == 0).mean() >= FFHQ_EQUAL, (diff == 0).mean()
    np.testing.assert_allclose(got_lm, want_lm, atol=LANDMARK_ATOL)


def test_ffhq_crop_keeps_the_reference_landmark_ratios():
    """x scales by the height's ratio and y (and z) by the width's, as the
    reference does (``croppers.py:138-139``): visible on a crop that is
    not square after the border."""
    rng = np.random.RandomState(5)
    lm = _face_landmarks(rng, 50, 60, 30)
    cropper = tcroppers.FFHQFaceCropper(
        (48, 64), None, lambda imgs: np.repeat(lm[None], len(imgs), 0),
        "cpu")
    image = np.zeros((120, 100, 3), np.uint8)
    crop, lm_cropped = cropper.crop_from_landmarks(image, lm)
    _, got = cropper.crop_images(image[None])
    want = lm_cropped.copy()
    want[:, 0] *= 64 / crop.shape[0]
    want[:, 1:] *= 48 / crop.shape[1]
    np.testing.assert_allclose(got[0], want, rtol=1e-6)


def test_channel_median_averages_the_two_middle_values():
    """``np.median`` of an even count (``torch.median`` takes the lower)."""
    import torch
    values = np.random.RandomState(2).uniform(0, 255, (6, 4, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tcroppers.channel_median(torch.from_numpy(values)).numpy(),
        np.median(values, axis=(0, 1)))
    np.testing.assert_array_equal(
        tcroppers.channel_median(torch.from_numpy(values[:5, :3])).numpy(),
        np.median(values[:5, :3], axis=(0, 1)))


def test_ffhq_crop_refuses_a_box_as_jax_does():
    cropper = tcroppers.FFHQFaceCropper((64, 64), None, lambda imgs: None,
                                        "cpu")
    with pytest.raises(NotImplementedError, match="custom bbox"):
        cropper.crop_images(np.zeros((1, 8, 8, 3), np.uint8), [[0, 0, 4, 4]])
