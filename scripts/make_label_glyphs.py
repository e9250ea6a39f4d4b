#!/usr/bin/env python
"""Build the glyph table with which the PyTorch port draws detection labels
without OpenCV (``radnet_torch/cli/label_glyphs.npz``).

The JAX package labels each drawn detection with ``cv2.putText`` in
``FONT_HERSHEY_DUPLEX`` (scale 1, thickness 1), on a white box sized by
``cv2.getTextSize`` in ``FONT_HERSHEY_COMPLEX``
(``radnet_tpu/cli/common.py::draw_detections``).  For every code point of
U+0020-U+007E and U+00A0-U+00FF this script stores:

* the DUPLEX coverage of the character, rendered white on black at a fixed
  integer origin, cropped to its covered pixels (0-255, the blend weight),
  and the crop's offset from the origin;
* the DUPLEX advance, ``getTextSize(c, DUPLEX, 1, 1)`` width - 1;
* the COMPLEX width and baseline, and the COMPLEX height (one for all);
* the version of the ``cv2`` that drew them.

``radnet_torch.cli.common`` draws a string from the table: each character's
coverage blended in the string's order at the pen, the pen advancing by the
character's advance.  Needs ``cv2``, which the port itself never imports.
The file is written byte for byte the same on every run with the same
``cv2`` (fixed zip entry dates).

Usage:
  python scripts/make_label_glyphs.py [--out radnet_torch/cli/label_glyphs.npz]
"""

from __future__ import annotations

import argparse
import io
import os
import zipfile

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "radnet_torch", "cli", "label_glyphs.npz")
CODE_POINTS = list(range(0x20, 0x7F)) + list(range(0xA0, 0x100))
CANVAS = 128  # px a side; the origin at (ORIGIN_X, ORIGIN_Y)
ORIGIN_X, ORIGIN_Y = 40, 80


def coverage(ch: str) -> np.ndarray:
    """The DUPLEX coverage of ``ch`` drawn white on black at the origin of
    a ``CANVAS`` square: with a white colour the blend leaves the weight
    itself in each pixel."""
    img = np.zeros((CANVAS, CANVAS, 3), np.uint8)
    cv2.putText(img, ch, (ORIGIN_X, ORIGIN_Y), cv2.FONT_HERSHEY_DUPLEX, 1, (255, 255, 255), 1)
    a = img[..., 0]
    assert (img == a[..., None]).all(), f"{ch!r}: the channels differ"
    border = np.concatenate([a[0], a[-1], a[:, 0], a[:, -1]])
    assert not border.any(), f"{ch!r}: coverage touches the canvas border"
    return a


def build_table() -> dict:
    alphas, starts, shapes, offsets = [], [], [], []
    advance, c_width, c_baseline, c_heights = [], [], [], set()
    start = 0
    for cp in CODE_POINTS:
        ch = chr(cp)
        a = coverage(ch)
        ys, xs = np.nonzero(a)
        if len(ys):
            y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
            crop = a[y0:y1, x0:x1]
            offsets.append((y0 - ORIGIN_Y, x0 - ORIGIN_X))
        else:
            crop = np.zeros((0, 0), np.uint8)
            offsets.append((0, 0))
        alphas.append(crop.reshape(-1))
        starts.append(start)
        shapes.append(crop.shape)
        start += crop.size
        (w, _), _ = cv2.getTextSize(ch, cv2.FONT_HERSHEY_DUPLEX, 1, 1)
        advance.append(w - 1)
        (w, h), base = cv2.getTextSize(ch, cv2.FONT_HERSHEY_COMPLEX, 1, 1)
        c_width.append(w)
        c_baseline.append(base)
        c_heights.add(h)
    assert len(c_heights) == 1, f"COMPLEX heights differ between characters: {sorted(c_heights)}"
    return {
        "code_points": np.asarray(CODE_POINTS, np.int32),
        "alpha": np.concatenate(alphas).astype(np.uint8),
        "start": np.asarray(starts, np.int64),
        "shape": np.asarray(shapes, np.int32).reshape(-1, 2),
        "offset": np.asarray(offsets, np.int32),
        "advance": np.asarray(advance, np.int32),
        "complex_width": np.asarray(c_width, np.int32),
        "complex_baseline": np.asarray(c_baseline, np.int32),
        "complex_height": np.asarray(c_heights.pop(), np.int32),
        "cv2_version": np.asarray(cv2.__version__),
    }


def write_npz(path: str, arrays: dict) -> None:
    """``np.savez_compressed`` with every zip entry dated 1980-01-01, so the
    bytes depend on the arrays alone."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        for name, arr in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asanyarray(arr), allow_pickle=False)
            info = zipfile.ZipInfo(f"{name}.npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            zf.writestr(info, buf.getvalue())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    table = build_table()
    write_npz(args.out, table)
    print(f"{args.out}: {len(CODE_POINTS)} glyphs, {table['alpha'].size} coverage bytes, "
          f"cv2 {cv2.__version__}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
