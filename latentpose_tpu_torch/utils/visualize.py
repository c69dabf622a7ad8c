"""Visualization grids (port of ``latentpose_tpu/utils/visualize.py``).

Row layout per sample: identity source | pose source | generator output |
true segm | predicted segm | [the cross-driving columns for each suffix:
driver + output for '_other_video' (same person, other video) and
'_other_person'].  Inputs are host arrays (numpy).
"""

from __future__ import annotations

import numpy as np


def _to_numpy_img(x):
    if getattr(x, "dtype", None) == np.uint8:
        x = np.asarray(x, np.float32) / 255.0
    x = np.asarray(x, np.float32)
    if x.ndim == 4:  # (T, H, W, C) -> first frame
        x = x[0]
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    return np.clip(x, 0.0, 1.0)


CAPTION_HEIGHT = 38


def rasterize_caption_header(labels, col_width, total_width):
    """White 38-px strip with one label drawn over each column start
    (cv2.FONT_HERSHEY_PLAIN, scale 1.25, black, thickness 2); the blank
    strip where cv2 is not installed (the labels still reach the sidecar
    .txt), as the JAX package does."""
    try:
        import cv2
    except ImportError:
        return np.ones((CAPTION_HEIGHT, total_width, 3), np.float32)
    strip = np.full((CAPTION_HEIGHT, total_width, 3), 255, np.uint8)
    for i, text in enumerate(labels):
        cv2.putText(strip, text, (i * col_width + 1, CAPTION_HEIGHT - 4),
                    cv2.FONT_HERSHEY_PLAIN, 1.25, (0, 0, 0), 2)
    return strip.astype(np.float32) / 255.0


def make_visual(data_dict, n_samples=2):
    """(grid (H*, W*, 3) f32 with the caption header on top, per-row
    caption strings) from a populated data_dict of host arrays."""
    suffixes = [""]
    for suffix in ("_other_video", "_other_person"):
        if ("fake_rgbs" + suffix) in data_dict:
            suffixes.append(suffix)

    rows = []
    captions = []
    batch = np.asarray(data_dict["fake_rgbs"]).shape[0]
    for n in range(min(n_samples, batch)):
        cols = []
        caption = []
        if data_dict.get("enc_rgbs") is not None:
            cols.append(_to_numpy_img(np.asarray(data_dict["enc_rgbs"])[n]))
            caption.append("identity src")
        for suffix in suffixes:
            pose_key = "pose_input_rgbs" + suffix
            if data_dict.get(pose_key) is not None:
                cols.append(_to_numpy_img(np.asarray(data_dict[pose_key])[n]))
                caption.append("pose src" + suffix)
            cols.append(_to_numpy_img(np.asarray(
                data_dict["fake_rgbs" + suffix])[n]))
            caption.append("generated" + suffix)
            if suffix == "":
                for key, name in (("real_segm", "true segm"),
                                  ("fake_segm", "pred segm")):
                    if data_dict.get(key) is not None:
                        cols.append(_to_numpy_img(
                            np.asarray(data_dict[key])[n]))
                        caption.append(name)
        rows.append(np.concatenate(cols, axis=1))
        captions.append(" | ".join(caption))
        if n == 0:
            header_labels = list(caption)
            col_width = cols[0].shape[1]

    width = max(r.shape[1] for r in rows)
    rows = [np.pad(r, ((0, 0), (0, width - r.shape[1]), (0, 0)))
            for r in rows]
    header = rasterize_caption_header(header_labels, col_width, width)
    return np.concatenate([header] + rows, axis=0), captions
