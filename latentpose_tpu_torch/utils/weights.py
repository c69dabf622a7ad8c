"""Converted pretrained-weight discovery (port of
``latentpose_tpu/utils/weights.py``, with the same search order):

1. the explicit directory the caller passed (``--vgg_weights_dir``);
2. ``$LATENTPOSE_WEIGHTS_DIR``;
3. ``<repo>/weights/``.

A component that needs a missing file fails unless its caller opted into the
degraded mode (``--allow_random_vgg``).  See WEIGHTS.md for how the ``.npz``
files are made.
"""

from __future__ import annotations

import os
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parents[2]


def find_weights_file(filename: str, explicit_dir=None):
    """The path of a converted weights file, or None if it is absent."""
    candidates = []
    if explicit_dir:
        candidates.append(Path(explicit_dir) / filename)
    env_dir = os.environ.get("LATENTPOSE_WEIGHTS_DIR")
    if env_dir:
        candidates.append(Path(env_dir) / filename)
    candidates.append(_REPO_ROOT / "weights" / filename)
    for cand in candidates:
        if cand.exists():
            return str(cand)
    return None


def missing_weights_error(filename: str, component: str, opt_in_flag: str,
                          explicit_dir=None) -> FileNotFoundError:
    return FileNotFoundError(
        f"{component}: converted weights file {filename!r} not found "
        f"(searched: explicit dir {explicit_dir!r}, $LATENTPOSE_WEIGHTS_DIR, "
        f"{_REPO_ROOT / 'weights'}). This component is NOT paper-parity "
        f"without real weights; see WEIGHTS.md for the acquisition + "
        f"conversion recipe, or pass {opt_in_flag} to knowingly run the "
        f"degraded fallback (tests/synthetic configs only).")
