"""Annotations, image loading with the typed directory layout of the scan
datasets, and the class-balanced sample selector of training.

The annotation CSV has the columns ``img_path,label,xmin,ymin,xmax,ymax``.
Images live under per-type directories injected as the second path segment:
``<data_root>/<img_type>/<...>/<file>``.  Files are PNG or JPEG, read by
``data/image.py`` as ``cv2.imdecode(..., IMREAD_COLOR)`` reads them: BGR
``(H, W, 3)`` uint8, grey files with three equal channels, EXIF orientation
applied.  Decoded panels are kept in a byte-bounded LRU cache: a training
epoch reads every panel again, and decoding one costs an inflate or a JPEG's
entropy decode and IDCT on the host.
"""

from __future__ import annotations

import collections
import csv
import os
import threading
import time
from typing import Any

import numpy as np

from radnet_torch.data.image import read_image


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
              rng: np.random.Generator | None = None, writable: bool = False) -> np.ndarray:
    """Load one image, with the image type (the first, or one drawn by
    :func:`choose_img_type`) injected into its path.  Returns a read-only
    array from the decoded-panel cache unless ``writable`` (a copy)."""
    img_type = choose_img_type(types, rng) if random_type else types[0]
    path = _resolve_typed_path(img_path, img_type)
    key = os.path.abspath(path)
    img = _decoded_cache_get(key)
    if img is None:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"cannot decode image: {path}")
        img = read_image(path)
        _decoded_cache_put(key, img)
    return img.copy() if writable else img


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


# --------------------------------------------------------------------------- #
# Decoded-panel LRU cache, keyed by the resolved absolute path.  Entries are
# read-only: augmentation never writes its input, and a write would be a
# loud error instead of a corrupted cache.
# --------------------------------------------------------------------------- #
DECODED_CACHE_MB = 1024  # 0 disables the cache

_decoded_cache: "collections.OrderedDict[str, np.ndarray]" = collections.OrderedDict()
_decoded_cache_lock = threading.Lock()
_decoded_cache_bytes = 0


def _decoded_cache_get(path: str):
    with _decoded_cache_lock:
        img = _decoded_cache.get(path)
        if img is not None:
            _decoded_cache.move_to_end(path)
        return img


def _decoded_cache_put(path: str, img: np.ndarray) -> None:
    global _decoded_cache_bytes
    budget = DECODED_CACHE_MB * 1024 * 1024
    img.setflags(write=False)
    if img.nbytes > budget:
        return
    with _decoded_cache_lock:
        prev = _decoded_cache.pop(path, None)
        if prev is not None:
            _decoded_cache_bytes -= prev.nbytes
        while _decoded_cache and _decoded_cache_bytes + img.nbytes > budget:
            _, evicted = _decoded_cache.popitem(last=False)
            _decoded_cache_bytes -= evicted.nbytes
        _decoded_cache[path] = img
        _decoded_cache_bytes += img.nbytes


def get_data(annot_path: str, data_path: str, img_types: list[str],
             read_images: bool = True) -> tuple[list[dict[str, Any]], dict[str, int], dict[str, int]]:
    """Parse the annotation CSV: (per-image dicts with ``filepath``,
    ``width``, ``height``, ``depth`` and ``bboxes`` of ``class, x1, y1, x2,
    y2`` ints; class name -> box count; class name -> index in first-seen
    order), with ``bg`` appended to both maps when absent."""
    t0 = time.time()
    all_imgs: dict[str, dict[str, Any]] = {}
    class_count: dict[str, int] = {}
    class_mapping: dict[str, int] = {}
    with open(annot_path, newline="") as f:
        for row in csv.DictReader(f):
            img_name, class_name = row["img_path"], row["label"]
            class_count[class_name] = class_count.get(class_name, 0) + 1
            if class_name not in class_mapping:
                class_mapping[class_name] = len(class_mapping)
            if img_name not in all_imgs:
                filepath = data_path + "/" + img_name
                entry: dict[str, Any] = {"filepath": filepath, "bboxes": []}
                if read_images:
                    img = get_image(filepath, img_types, random_type=False)
                    entry["height"], entry["width"], entry["depth"] = img.shape
                all_imgs[img_name] = entry
            all_imgs[img_name]["bboxes"].append({
                "class": class_name,
                "x1": int(float(row["xmin"])), "y1": int(float(row["ymin"])),
                "x2": int(float(row["xmax"])), "y2": int(float(row["ymax"])),
            })
    data = list(all_imgs.values())
    if "bg" not in class_count:
        class_count["bg"] = 0
        class_mapping["bg"] = len(class_mapping)
    print(f"Read {annot_path}: {len(data)} images in {time.time() - t0:.2f}s")
    return data, class_count, class_mapping


class SampleSelector:
    """Round-robin class balancing over the classes that have boxes."""

    def __init__(self, class_count: dict[str, int]):
        self.classes = [c for c, n in class_count.items() if n > 0]
        self._pos = 0
        self.curr_class = self.classes[0] if self.classes else None

    def _advance(self) -> None:
        self._pos = (self._pos + 1) % len(self.classes)
        self.curr_class = self.classes[self._pos]

    def skip_image_for_balanced_class(self, img_data: dict[str, Any]) -> bool:
        """True if the image lacks the currently wanted class."""
        return not any(b["class"] == self.curr_class for b in img_data["bboxes"])

    def skip_tile_for_balanced_class(self, img_data: dict[str, Any]) -> bool:
        """Like the image variant, but advances the wanted class on a hit."""
        if any(b["class"] == self.curr_class for b in img_data["bboxes"]):
            self._advance()
            return False
        return True
