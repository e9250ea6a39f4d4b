"""Image loading with the typed directory layout of the scan datasets.

Images live under per-type directories injected as the second path segment:
``<data_root>/<img_type>/<...>/<file>``.  Files are PNGs, read by
``data/png.py`` as BGR ``(H, W, 3)`` uint8 (grey files come back with three
equal channels).
"""

from __future__ import annotations

import os
import threading

import numpy as np

from radnet_torch.data.png import read_png


def choose_img_type(types: list[str], rng: np.random.Generator | None = None) -> str:
    """Draw one image type: the first gets probability 0.5 when there are at
    most 3 types, else 0.3, and the rest share the remainder uniformly."""
    if len(types) <= 1:
        return types[0]
    rng = rng or np.random.default_rng()
    first_prob = 0.5 if len(types) <= 3 else 0.3
    rest = (1.0 - first_prob) / (len(types) - 1)
    return rng.choice(types, p=[first_prob] + [rest] * (len(types) - 1))


def get_image(img_path: str, types: list[str], random_type: bool = False,
              rng: np.random.Generator | None = None) -> np.ndarray:
    """Load one image, with the image type (the first, or one drawn by
    :func:`choose_img_type`) injected into its path."""
    img_type = choose_img_type(types, rng) if random_type else types[0]
    path = _resolve_typed_path(img_path, img_type)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"cannot decode image: {path}")
    return read_png(path)


_resolved_paths: dict[tuple[str, str], str] = {}
_resolved_paths_lock = threading.Lock()


def _resolve_typed_path(img_path: str, img_type: str) -> str:
    """Where the type segment goes, probed on disk and memoized.

    Right after the data root (index 1 of a relative path, 2 of an absolute
    one) comes first; any other position that names an existing file is
    taken next.  An unresolvable path returns the first position and is not
    memoized, since the file may appear later."""
    memo_key = (os.path.abspath(img_path), img_type)
    with _resolved_paths_lock:
        hit = _resolved_paths.get(memo_key)
    if hit is not None:
        return hit

    parts = img_path.split("/")
    is_abs = img_path.startswith("/")
    ref_idx = 2 if is_abs else 1

    def joined(idx: int) -> str:
        out = os.path.join(*(parts[:idx] + [img_type] + parts[idx:]))
        return "/" + out.lstrip("/") if is_abs else out

    path = joined(ref_idx)
    if not os.path.isfile(path):
        for idx in range(1, len(parts)):
            if idx != ref_idx and os.path.isfile(joined(idx)):
                path = joined(idx)
                break
        else:
            return path
    with _resolved_paths_lock:
        _resolved_paths[memo_key] = path
    return path
