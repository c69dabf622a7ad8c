"""PyTorch port, the VoxCeleb2 data path held against the JAX package: the
C++ decoder (PNG and JPEG frames, every PNG colour type) and its crops, the
segmentation mask's crop, the identity lists, the dataset's samples, the
batch loader's order, the producers' shutdown, the cross-driving lookup and
drive's image-directory decode.

Fixtures are fabricated with cv2 as ``tests/test_data.py`` does: a
VoxCeleb2-layout tree of smooth random frames (JPEG for two identities, PNG
for one), PNG and ``.png.npy`` masks and a bboxes dict that pads the crops.
Tolerances: the frames' crop is bit-equal to the JAX package's C++ loader
(the port builds its own copy of that source); the driver frame, target and
mask, which the JAX package crops with cv2, are held to the JAX suite's own
bound for its C++ crop against cv2 (``tests/test_native_cropped_loader.py``):
3.5/255 at most, 0.5/255 on average.

The JAX package's loader is held through a private build of its source
(:func:`private_jax_loader`): ``latentpose_tpu/data/native_loader.py``
builds ``native/liblpr_loader.so`` in place with ``make`` when it is
missing, and under pytest-xdist every worker does so at collection
(``tests/test_native_loader.py`` asks ``is_available()`` there).  GNU ld
rewrites an existing output in place, so one worker's link truncates and
rewrites the library another worker has already loaded, which undoes that
worker's relocations; another worker may load it half written ("file too
short") and skip.  The seeded frame draws wait until no loader producer of
an earlier test is left drawing from the global ``random``.
"""

import gc
import os
import random
import re
import struct
import subprocess
import threading
import time
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.ndimage import uniform_filter

from latentpose_tpu.cli import drive as jdrive_cli
from latentpose_tpu.data import native_loader as jnative
from latentpose_tpu.data import pipeline as jpipeline
from latentpose_tpu.data import voxceleb2_segmentation_nolandmarks as jds
from latentpose_tpu.data.common import crop as jcrop
from latentpose_tpu.data.common import voxceleb as jvox
from latentpose_tpu_torch.cli import drive as tdrive_cli
from latentpose_tpu_torch.data import native_loader as tnative
from latentpose_tpu_torch.data import pipeline as tpipeline
from latentpose_tpu_torch.data import voxceleb2_segmentation_nolandmarks as tds
from latentpose_tpu_torch.data.common import crop as tcrop
from latentpose_tpu_torch.data.common import voxceleb as tvox
from latentpose_tpu_torch.runners import loop as tloop

cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parent.parent
MAX_ERR = 3.5 / 255
MEAN_ERR = 0.5 / 255
SRC = 96          # source frame size
IDENTITIES = {    # identity -> (frame format, mask format, has bboxes)
    "id00001": ("jpg", "png", True),
    "id00002": ("png", "npy", True),
    "id00003": ("jpg", "png", False),
}
VIDEOS = ("videoA", "videoB")
FRAMES = 6


def _makefile_command(lib):
    """The compile command of ``native/Makefile`` (its CXXFLAGS, LDLIBS and
    rule) with ``lib`` as the output."""
    text = (REPO / "native" / "Makefile").read_text()

    def var(name):
        return re.search(rf"^{name}\s*\??=(.*)$", text, re.M).group(1).split()

    return ["g++", *var("CXXFLAGS"), "-shared", "-o", str(lib),
            str(REPO / "native" / "lpr_loader.cpp"), *var("LDLIBS")]


@pytest.fixture(scope="module", autouse=True)
def private_jax_loader(tmp_path_factory):
    """The JAX package's C++ loader, built from ``native/lpr_loader.cpp``
    with ``native/Makefile``'s flags into this worker's own directory
    (written to a temporary file, then renamed), and bound to
    ``latentpose_tpu.data.native_loader`` for this module's tests, so no
    other worker's ``make`` rewrites the library these tests read."""
    lib = tmp_path_factory.mktemp("jax_native_loader") / "liblpr_loader.so"
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(_makefile_command(tmp), capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stderr
    os.replace(tmp, lib)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATH", lib)
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_load_failed", False)
        assert jnative.is_available(), "the private JAX loader did not load"
        yield lib


LOADER_MODULES = ("latentpose_tpu.data.pipeline", "latentpose_tpu.runners.loop",
                  "latentpose_tpu_torch.data.pipeline",
                  "latentpose_tpu_torch.runners.loop")


def _producers():
    """Live producer threads of loaders: either package's ``BatchLoader``
    and ``device_prefetch`` (the thread's target is defined there)."""
    return [t for t in threading.enumerate() if t.is_alive()
            and getattr(getattr(t, "_target", None), "__module__", None)
            in LOADER_MODULES]


def quiesce_loaders(timeout=30.0):
    """Collect abandoned loader iterators (their ``finally`` stops their
    producers) and wait for every producer thread to end, so that a seeded
    draw from the global ``random`` is not shared with one.  A producer
    whose iterator something still holds outlives the wait blocked on its
    full queue, where it draws nothing."""
    gc.collect()
    deadline = time.time() + timeout
    for thread in _producers():
        thread.join(max(0.0, deadline - time.time()))


def _smooth(rng, shape):
    return (uniform_filter(rng.rand(*shape), size=(7, 7, 1)[:len(shape)])
            * 255).astype(np.uint8)


def _mask(rng):
    yy, xx = np.mgrid[0:SRC, 0:SRC]
    m = (((yy - 52) / 30.0) ** 2 + ((xx - 47) / 22.0) ** 2 < 1).astype(float)
    return np.clip(uniform_filter(m + 0.3 * rng.rand(SRC, SRC), 5) * 255,
                   0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The fixture tree: 3 identities x 2 videos x 6 frames, masks, boxes
    (256-space l, t, r, b, for videoA of the identities that have them),
    train.csv and val.csv."""
    root = tmp_path_factory.mktemp("vox")
    bboxes = {}
    for ident, (fmt, mfmt, has_boxes) in IDENTITIES.items():
        for video in VIDEOS:
            img_dir = root / "images-cropped" / ident / video
            segm_dir = root / "segmentation-cropped" / ident / video
            img_dir.mkdir(parents=True)
            segm_dir.mkdir(parents=True)
            boxes = []
            for f in range(FRAMES):
                rng = np.random.RandomState(
                    zlib.crc32(f"{ident}/{video}/{f}".encode()))
                cv2.imwrite(str(img_dir / f"{f:05d}.{fmt}"),
                            _smooth(rng, (SRC, SRC, 3)))
                mask = _mask(rng)
                if mfmt == "png":
                    cv2.imwrite(str(segm_dir / f"{f:05d}.png"),
                                np.dstack([255 - mask, mask, mask // 2]))
                else:
                    np.save(segm_dir / f"{f:05d}.png.npy", mask[..., None])
                # pads on every side of some crops, none on others
                boxes.append([50 + 9 * f, 40 + 6 * f, 190 + 9 * f,
                              200 + 6 * f])
            if has_boxes and video == "videoA":
                bboxes.setdefault(ident, {})[video] = np.array(boxes,
                                                               np.float32)
    np.save(root / "bboxes.npy", bboxes, allow_pickle=True)
    rows = [f"{i}/{v}" for i in IDENTITIES for v in VIDEOS]
    (root / "train.csv").write_text("path\n" + "\n".join(rows) + "\n")
    (root / "val.csv").write_text("path\n" + "\n".join(rows[1:3]) + "\n")
    return root


def _args(root, finetune=False, **over):
    args = types.SimpleNamespace(
        data_root=str(root), img_dir="images-cropped",
        kp_dir="keypoints-cropped", segm_dir="segmentation-cropped",
        bboxes_dir=str(root / "bboxes.npy"),
        train_split_path=str(root / "train.csv"),
        val_split_path=str(root / "val.csv"), finetune=finetune,
        checkpoint_path="", num_labels=0, inference=False, image_size=32,
        batch_size=2, num_workers=2, prefetch_size=4, random_seed=3,
        draw_oval=True, n_frames_for_encoder=3, transfer_dtype="float32")
    for k, v in over.items():
        setattr(args, k, v)
    return args


def _frames(root):
    return sorted((root / "images-cropped").rglob("0000*.*"))


# --- the decoder --------------------------------------------------------------

@pytest.mark.parametrize("size", [32, 160])
def test_load_cropped_is_bit_equal_to_the_jax_loader(tree, size):
    """Every frame of the tree (JPEG and PNG) through the dataset's crop,
    with its box (padded or not, with the 1px strip or without)."""
    loader = jds.SegmSampleLoader(tree, "images-cropped",
                                  bboxes_dir=tree / "bboxes.npy")
    paths = _frames(tree)
    boxes = [loader._bbox_for(f"{p.parent.parent.name}/{p.parent.name}",
                              p.stem) for p in paths]
    bb = np.asarray([b[:4] for b in boxes], np.float64)
    flags = np.asarray([b[4] for b in boxes], np.uint8)
    assert flags.any() and not flags.all()
    want, wf = jnative.NativeBatchLoader(2).load_cropped(paths, bb, flags,
                                                         size)
    got, gf = tnative.NativeBatchLoader(2).load_cropped(paths, bb, flags,
                                                        size)
    assert wf == gf == 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("crops", [False, True])
def test_load_is_bit_equal_to_the_jax_loader(tree, crops):
    paths = _frames(tree)
    box = np.tile([[10, 5, 80, 75]], (len(paths), 1)) if crops else None
    want, wf = jnative.NativeBatchLoader(2).load(paths, 48, box)
    got, gf = tnative.NativeBatchLoader(2).load(paths, 48, box)
    assert wf == gf == 0
    np.testing.assert_array_equal(got, want)


def _adam7_png(img):
    """An interlaced (Adam7) 8-bit RGB PNG of ``img``, its rows filtered in
    turn with each of the five filters."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    raw = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = img[y0::dy, x0::dx].astype(np.int32)
        if sub.size == 0:
            continue
        prev = np.zeros(sub.shape[1] * 3, np.int32)
        for k, row in enumerate(sub.reshape(sub.shape[0], -1)):
            left = np.concatenate([[0, 0, 0], row[:-3]])
            upleft = np.concatenate([[0, 0, 0], prev[:-3]])
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            paeth = np.where((pa <= pb) & (pa <= pc), left,
                             np.where(pb <= pc, prev, upleft))
            pred = [0, left, prev, (left + prev) // 2, paeth][k % 5]
            raw += bytes([k % 5]) + ((row - pred) % 256).astype(
                np.uint8).tobytes()
            prev = row
    h, w = img.shape[:2]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _write_variant(path, kind, img):
    from PIL import Image
    if kind == "rgb":
        cv2.imwrite(str(path), img)
    elif kind == "gray":
        cv2.imwrite(str(path), img[..., 0])
    elif kind == "rgb16":
        cv2.imwrite(str(path), img.astype(np.uint16) * 257 + 100)
    elif kind == "rgba":
        cv2.imwrite(str(path), np.dstack([img, img[..., :1]]))
    elif kind == "palette":
        Image.fromarray(img).convert("P", palette=Image.ADAPTIVE,
                                     colors=50).save(path)
    elif kind == "palette2bit":
        Image.fromarray(img).convert("P", palette=Image.ADAPTIVE,
                                     colors=4).save(path, bits=2)
    elif kind == "gray1bit":
        Image.fromarray(img[..., 0] > 128).save(path)
    elif kind == "gray_alpha":
        Image.fromarray(img[..., 0]).convert("LA").save(path)
    elif kind == "adam7":
        path.write_bytes(_adam7_png(img))


@pytest.mark.parametrize("kind", ["rgb", "gray", "rgb16", "rgba", "palette",
                                  "palette2bit", "gray1bit", "gray_alpha",
                                  "adam7"])
def test_png_decoder_is_bit_equal_to_libpng(tmp_path, kind):
    """The port decodes PNG itself (zlib, the row filters, Adam7, every
    colour type); libpng (the JAX package's loader) and cv2 read the same
    pixels."""
    img = _smooth(np.random.RandomState(5), (37, 37, 3))
    path = tmp_path / "f.png"
    _write_variant(path, kind, img)
    want, wf = jnative.NativeBatchLoader(2).load([path], 37)
    got, gf = tnative.NativeBatchLoader(2).load([path], 37)
    assert wf == gf == 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.rint(got[0] * 255).astype(np.uint8), cv2.imread(str(path))[..., ::-1])


@pytest.mark.parametrize("sampling", ["420", "422", "444", "440", "411",
                                      "grey"])
def test_jpeg_decoder_is_bit_equal_to_libjpeg(tmp_path, sampling):
    """JPEG frames decode to the planes of their samples, which the loader
    upsamples and converts itself as libjpeg does (the same code turns
    nvJPEG's planes into RGB where the card is); where it does not cover
    the sampling (4:4:0, 4:1:1) the decoder's own RGB.  Bit-equal to cv2
    (libjpeg) at odd sizes, smooth and noisy."""
    rng = np.random.RandomState(int(sampling) if sampling.isdigit() else 9)
    params = [cv2.IMWRITE_JPEG_QUALITY, 90]
    if sampling != "grey":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(
            cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
    for h, w in ((37, 53), (2, 3), (64, 64)):
        for img in (_smooth(rng, (h, w, 3)),
                    rng.randint(0, 256, (h, w, 3)).astype(np.uint8)):
            path = tmp_path / f"{h}x{w}.jpg"
            cv2.imwrite(str(path), img[..., 0] if sampling == "grey"
                        else img, params)
            np.testing.assert_array_equal(
                tnative.decode(path), cv2.imread(str(path))[..., ::-1])


def test_failed_files_are_counted_and_zeroed(tmp_path):
    (tmp_path / "bad.png").write_bytes(b"\x89PNG\r\n\x1a\nbroken")
    cv2.imwrite(str(tmp_path / "ok.png"), np.full((8, 8, 3), 200, np.uint8))
    out, failed = tnative.NativeBatchLoader(2).load(
        [tmp_path / "bad.png", tmp_path / "missing.jpg", tmp_path / "ok.png"],
        8)
    assert failed == 2
    assert not out[:2].any() and out[2].min() > 0.7


# --- the mask -----------------------------------------------------------------

def _jax_mask_crop(segm, bbox, has_bbox, size):
    """The JAX package's mask crop (cv2 + numpy), ``load_sample``'s
    ``load_segmentation`` branch."""
    l, t, r, b = bbox
    ti, li, bi, ri = jcrop.bbox_to_integer_coords(t, l, b, r, *segm.shape)
    if has_bbox:
        segm = segm[1:-1, 1:-1]
        ti, li, bi, ri = ti - 1, li - 1, bi - 1, ri - 1
    segm = jcrop.crop_with_padding(segm, ti, li, bi, ri, segmentation=True)
    return cv2.resize(segm, (size, size)).astype(np.float32) / 255.0


@pytest.mark.parametrize("case", [
    ((0.30, 0.30, 0.70, 0.72), True),    # pads on all sides after x1.8
    ((0.05, 0.05, 0.45, 0.50), True),    # heavy top/left padding
    ((0.55, 0.50, 0.95, 0.95), True),    # heavy bottom/right padding
    ((0.35, 0.40, 0.60, 0.60), False),   # no strip
    ((0.0, 0.0, 1.0, 1.0), False),       # identity (pre-cropped)
])
@pytest.mark.parametrize("size", [64, 160])
def test_mask_crop_matches_the_jax_python_path(tmp_path, case, size):
    """The PNG mask (channel 1) and the same mask as an array (the
    ``.png.npy`` path) against cv2's crop in the JAX package."""
    raw, has_bbox = case
    bbox = raw if raw == (0.0, 0.0, 1.0, 1.0) \
        else tcrop.square_and_scale_bbox(*raw)
    assert bbox == (raw if raw == (0.0, 0.0, 1.0, 1.0)
                    else jcrop.square_and_scale_bbox(*raw))
    rng = np.random.RandomState(hash((raw, size)) % 2 ** 31)
    mask = _mask(rng)
    cv2.imwrite(str(tmp_path / "m.png"), np.dstack([mask // 3, mask, 255 - mask]))
    want = _jax_mask_crop(mask, bbox, has_bbox, size)
    got, failed = tnative.NativeBatchLoader(2).load_segm(
        [tmp_path / "m.png"], np.asarray([bbox]), np.asarray([has_bbox]),
        size)
    assert failed == 0
    diff = np.abs(got[0] - want)
    assert diff.max() <= MAX_ERR and diff.mean() <= MEAN_ERR, \
        (diff.max() * 255, diff.mean() * 255)
    np.testing.assert_array_equal(
        tnative.NativeBatchLoader.crop_segm(mask, bbox, has_bbox, size),
        got[0])


def test_integer_box_matches_jax():
    rng = np.random.RandomState(2)
    for _ in range(200):
        l, t = rng.uniform(-0.3, 0.6, 2)
        box = tcrop.square_and_scale_bbox(l, t, l + rng.uniform(0.1, 0.7),
                                          t + rng.uniform(0.1, 0.7))
        args = (box[1], box[0], box[3], box[2], 97, 97)
        assert tcrop.bbox_to_integer_coords(*args) \
            == jcrop.bbox_to_integer_coords(*args)


# --- identity lists, samples, the loader ---------------------------------------

@pytest.mark.parametrize("source", ["csv", "listing", "single", "finetune",
                                    "resume", "splits_val"])
def test_get_part_data_matches_jax(tree, source):
    """The three sources (a CSV, the tree's listing, one identity's
    directory), the fine-tune listing, resume's truncation, and the
    repository's own split read without pandas."""
    over = {"csv": {}, "listing": dict(train_split_path="none.csv"),
            "single": dict(train_split_path="id00002/videoB"),
            "finetune": dict(train_split_path="id00002/videoA",
                             finetune=True),
            "resume": dict(checkpoint_path="ckpt", num_labels=3),
            "splits_val": dict(train_split_path=str(
                REPO / "data" / "splits" / "val.csv"))}[source]
    want_args, got_args = _args(tree, **over), _args(tree, **over)
    want = jvox.get_part_data(want_args, "train")
    got = tvox.get_part_data(got_args, "train")
    assert got.paths == want.paths and got.files == want.files
    assert got_args.num_labels == want_args.num_labels
    assert len(got.paths) > (300 if source == "splits_val" else 0)


def _datasets(tree, finetune=False):
    over = dict(train_split_path="id00001/videoA", finetune=True) \
        if finetune else {}
    jloader = jds.Wrapper.get_dataloader(_args(tree, **over), "train")
    tloader = tds.Wrapper.get_dataloader(_args(tree, **over), "train")
    return jloader.dataset, tloader.dataset


def _assert_close(got, want, key):
    diff = np.abs(got - want)
    assert diff.max() <= MAX_ERR and diff.mean() <= MEAN_ERR, \
        (key, diff.max() * 255, diff.mean() * 255)


@pytest.mark.parametrize("branch", ["meta", "finetune"])
def test_dataset_items_match_jax(tree, branch, monkeypatch):
    """Given the same frame draw (the JAX package's global ``random``
    seeded as the port's per-sample ``random.Random``), the identity frames
    are bit-equal; the driver, target and mask, which the JAX package crops
    with cv2, agree within the crop's bound."""
    jset, tset = _datasets(tree, finetune=branch == "finetune")
    assert len(jset) == len(tset) and jset.num_labels == tset.num_labels
    tset.epoch = 2
    quiesce_loaders()
    for index in range(len(tset)):
        random.seed(tds.frame_key(tset.seed, tset.epoch, index))
        want_data, want_target = jset[index]
        got_data, got_target = tset[index]
        assert set(got_data) == set(want_data)
        assert set(got_target) == set(want_target)
        assert got_target["label"] == want_target["label"]
        enc = got_data["enc_rgbs"]
        assert enc.dtype == np.float32 and enc.shape == \
            want_data["enc_rgbs"].shape
        if branch == "meta":
            np.testing.assert_array_equal(enc, want_data["enc_rgbs"])
        else:
            _assert_close(enc, want_data["enc_rgbs"], "enc_rgbs")
        for key in ("pose_input_rgbs", "target_rgbs"):
            _assert_close(got_data[key], want_data[key], key)
        _assert_close(got_target["real_segm"], want_target["real_segm"],
                      "real_segm")


def test_frame_draws_are_keyed_on_seed_epoch_and_index(tree):
    _, tset = _datasets(tree)

    def draw(epoch, index, deterministic=False):
        tset.epoch = epoch
        return tset.get(index, deterministic)[0]["enc_rgbs"]

    np.testing.assert_array_equal(draw(0, 1), draw(0, 1))
    assert not np.array_equal(draw(0, 1), draw(1, 1))
    np.testing.assert_array_equal(draw(0, 1, True), draw(5, 1, True))


@pytest.mark.parametrize("case", [
    dict(shuffle=True, drop_last=True, batch_size=4),
    dict(shuffle=True, drop_last=False, batch_size=4),
    dict(shuffle=False, drop_last=True, batch_size=5),
    dict(shuffle=True, drop_last=True, batch_size=50),     # shrinks to 6
])
def test_batch_loader_order_matches_jax(case):
    """Epoch order (``RandomState(seed + epoch)``), drop_last and the
    batch's shrink to the dataset size, over three epochs."""
    class Numbers:
        def __len__(self):
            return 6

        def __getitem__(self, index):
            return {"x": np.float32(index)}, {"label": int(index)}

    want = jpipeline.BatchLoader(Numbers(), seed=7, num_workers=2,
                                 prefetch_size=8, **case)
    got = tpipeline.BatchLoader(Numbers(), seed=7, num_workers=2,
                                prefetch_size=8, **case)
    assert got.batch_size == want.batch_size and len(got) == len(want)
    for _ in range(3):
        w, g = list(want), list(got)
        assert len(g) == len(w)
        for (wd, wt), (gd, gt) in zip(w, g):
            np.testing.assert_array_equal(gd["x"], wd["x"])
            np.testing.assert_array_equal(gt["label"], wt["label"])
            assert gt["label"].dtype == wt["label"].dtype


def _loader_threads():
    return [t for t in threading.enumerate()
            if t is not threading.current_thread() and t.daemon]


@pytest.mark.parametrize("where", ["mid_epoch", "after_last"])
@pytest.mark.parametrize("which", ["batch_loader", "device_prefetch"])
def test_abandoned_iterators_stop_their_producers(which, where):
    """A consumer that leaves in the middle of an epoch, or right after the
    last item without asking for the end, leaves no producer thread alive
    after 1 s, though the queues were full."""
    class Slow:
        def __len__(self):
            return 12

        def __getitem__(self, index):
            time.sleep(0.01)
            return {"x": np.zeros(3, np.float32)}, {"label": int(index)}

    before = set(_loader_threads())
    loader = tpipeline.BatchLoader(Slow(), batch_size=2, num_workers=2,
                                   prefetch_size=2)
    items = iter(loader) if which == "batch_loader" else \
        tloop.device_prefetch(loader, torch.device("cpu"), ("x", "label"),
                              depth=1)
    n = 1 if where == "mid_epoch" else len(loader)
    for _ in range(n):
        next(items)
    time.sleep(0.2)          # the producers fill their queues and block
    del items
    deadline = time.time() + 1.0
    while set(_loader_threads()) - before and time.time() < deadline:
        time.sleep(0.02)
    assert not set(_loader_threads()) - before


def test_producer_errors_reach_the_consumer():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, index):
            raise KeyError(f"sample {index}")

    with pytest.raises(KeyError, match="sample"):
        list(tpipeline.BatchLoader(Broken(), batch_size=2, num_workers=1))


@pytest.mark.parametrize("same_identity", [True, False])
@pytest.mark.parametrize("deterministic", [True, False])
def test_other_sample_by_label_matches_jax(tree, same_identity,
                                           deterministic):
    jset, tset = _datasets(tree)
    quiesce_loaders()
    for label in range(len(tset)):
        random.seed(label)
        want = jset.get_other_sample_by_label(label, same_identity,
                                              deterministic)
        got = tset.get_other_sample_by_label(
            label, same_identity, deterministic,
            rng=random.Random(label))
        assert got == want


# --- drive's image directory ---------------------------------------------------

def test_driver_frames_of_an_image_directory_match_jax(tree):
    """The repair: drive decodes an image directory through the C++
    loader (float32, bilinear) as the JAX package does, with no cv2."""
    directory = tree / "images-cropped" / "id00002" / "videoA"
    want = jdrive_cli.load_driver_frames(directory, 48)
    got = tdrive_cli.load_driver_frames(directory, 48)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (FRAMES, 48, 48, 3)
    np.testing.assert_array_equal(got, want)
