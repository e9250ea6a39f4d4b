#!/usr/bin/env python
"""Write the image fixtures with which the port's reader is held to OpenCV
on a host that has no OpenCV or PIL (the card's).

Under ``tests/data/images/`` it writes a few small files that cover the
reader's main cases, and ``cv2_pixels.npz``: for each file, the BGR uint8
array ``cv2.imdecode(np.fromfile(path, np.uint8), cv2.IMREAD_COLOR)`` gives,
and the cv2 version under the key ``cv2_version``.

* ``paeth_grey.png``  a grey panel with real Paeth residuals on every row;
* ``grey16.png``      16-bit grey (cv2's writer), read as its high bytes;
* ``palette.png``     an 8-bit palette image (PIL's adaptive palette);
* ``adam7_rgb.png``   Adam7-interlaced RGB, the five filters taking turns by
                      row (random filtered bytes);
* ``panel_420.jpg``   a 640 x 480 colour panel (``chip_smoke.py``'s
                      synthetic panel generator), cv2's default 4:2:0 at
                      quality 95: ``chip_smoke.py`` serves it;
* ``odd_444.jpg``     4:4:4, 123 x 157 (a size no MCU divides);
* ``progressive.jpg`` progressive 4:2:0 with optimized tables, 123 x 157;
* ``exif6.jpg``       PIL's, with EXIF orientation 6 (read 157 x 123);
* ``grey_lzw_pred.tif`` grey, LZW + Predictor 2, strips of 16 rows, MM;
* ``rgb_deflate_tiles_o6.tif`` colour, Deflate tiles of 32 at 123 x 157,
                      Orientation 6 (libtiff mirrors each tile);
* ``grey16_bigtiff_tiles.tif`` 16-bit grey BigTIFF, Deflate + Predictor 2
                      tiles;
* ``palette4_packbits.tif`` a 4-bit palette (16-bit colormap), PackBits;
* ``rgba_unassoc_planar.tif`` RGBA of unassociated alpha (premultiplied on
                      read), separate planes, LZW;
* ``cmyk.tif``        uncompressed CMYK, its IFD before its data;
* ``ycbcr420_tiles_o6.tif`` JPEG-compressed YCbCr 4:2:0 tiles of 32 at 123 x
                      157 with JPEGTables and Orientation 6, encoded by
                      ``scripts/jpeg_writer.py`` (``chip_smoke.py`` serves it);
* ``rgb_jpeg_strips.tif`` cv2's own JPEG TIFF: Photometric 2 (RGB, no colour
                      conversion), strips of 16 rows, JPEGTables;
* ``grey_jpeg_strips.tif`` grey JPEG strips of 16 rows (cv2's streams, their
                      tables moved to JPEGTables), big-endian;
* ``progressive_jpeg.tif`` progressive 4:2:0 YCbCr strips of 32 rows (cv2's
                      streams, tables in each);
* ``cmyk_pil.jpg``    PIL's CMYK JPEG (Adobe transform 0), 45 x 61;
* ``ycck_22.jpg``     YCCK (Adobe transform 2), Y and K sampled 2 x 2, Cb and
                      Cr 1 x 1, restart every 4 MCUs, 45 x 61, encoded by
                      ``scripts/jpeg_writer.py``;
* ``cmyk_jpeg.tif``   PIL's CMYK JPEG-TIFF (4 samples, no colour conversion);
* ``ycbcr22_lzw_tiles_o6.tif`` packed YCbCr 2, 2, LZW tiles of 32 at 45 x
                      61, Orientation 6 (libtiff's own YCbCr conversion);
* ``ycbcr_planar.tif`` YCbCr 1, 1 in separate planes, Deflate strips of 16
                      rows, ReferenceBlackWhite of Rec. 601's ranges.

The TIFFs are written by ``scripts/tiff_writer.py``, which needs neither cv2
nor PIL, their JPEG streams by cv2 or ``scripts/jpeg_writer.py``.

The files are written byte for byte the same on every run with the same cv2 and
PIL; ``tests/test_torch_image_decode.py`` checks that they and the ``.npz``
still equal what live cv2 writes and reads.  Needs cv2 and PIL, which the
port itself never imports.

Usage:
  python scripts/make_image_fixtures.py [--out tests/data/images]
"""

from __future__ import annotations

import argparse
import io
import os
import struct
import sys
import zlib

import cv2
import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "images")
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from radnet_torch.data import png  # noqa: E402
from jpeg_writer import encode_cmyk, encode_tiles, split_tables  # noqa: E402
from tiff_writer import encode_tiff  # noqa: E402

ODD_HW = (123, 157)
SMALL_HW = (45, 61)
ADAM7 = [(0, 8, 0, 8), (4, 8, 0, 8), (0, 4, 4, 8), (2, 4, 0, 4), (0, 2, 2, 4), (1, 2, 0, 2),
         (0, 1, 1, 2)]


def small_panel(h: int, w: int, seed: int) -> np.ndarray:
    """A small BGR panel: textured dark rock, bright figures, a tint."""
    rng = np.random.default_rng(seed)
    img = np.repeat(np.repeat(rng.integers(20, 60, (-(-h // 4), -(-w // 4))), 4, 0), 4, 1)[:h, :w]
    for _ in range(6):
        bh, bw = rng.integers(6, h // 3), rng.integers(6, w // 3)
        y, x = rng.integers(0, h - bh), rng.integers(0, w - bw)
        img[y:y + bh, x:x + bw] = rng.integers(110, 250)
    tint = np.array([-12, 0, 14])
    return np.clip(img[..., None] + tint + rng.integers(-6, 7, (h, w, 3)), 0, 255).astype(np.uint8)


def adam7_rgb(h: int, w: int, seed: int) -> bytes:
    """An interlaced 8-bit RGB PNG of random filtered bytes, each pass's rows
    taking the filter types 0-4 in turn."""
    rng = np.random.default_rng(seed)
    raw = []
    for x0, dx, y0, dy in ADAM7:
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if pw and ph:
            rows = rng.integers(0, 256, (ph, 3 * pw + 1), dtype=np.uint8)
            rows[:, 0] = np.arange(ph) % 5
            raw.append(rows.tobytes())
    return (png._SIGNATURE + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + png._chunk(b"IDAT", zlib.compress(b"".join(raw), 9)) + png._chunk(b"IEND", b""))


def encode(ext: str, img: np.ndarray, params=()) -> bytes:
    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok, ext
    return buf.tobytes()


def pil(img: np.ndarray, fmt: str, mode: str = "RGB", **kw) -> bytes:
    out = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img[..., ::-1])).convert(mode).save(out, fmt, **kw)
    return out.getvalue()


def jpeg_strips(img: np.ndarray, rows: int, params=()) -> list[bytes]:
    """cv2's JPEG stream of each strip of ``rows`` rows."""
    return [encode(".jpg", img[y:y + rows], params) for y in range(0, img.shape[0], rows)]


def fixtures() -> dict[str, bytes]:
    """File name -> bytes of every fixture."""
    grey = small_panel(96, 128, 11)[..., 1]
    colour = small_panel(96, 128, 12)
    odd = small_panel(*ODD_HW, 13)
    grey16 = grey.astype(np.uint16) * 257 + np.arange(128, dtype=np.uint16)
    exif = Image.Exif()
    exif[0x0112] = 6
    tables, tiles = encode_tiles(odd[..., ::-1], (32, 32), quality=90, sampling=(2, 2))
    grey_strips = jpeg_strips(grey, 16)
    grey_tables = split_tables(grey_strips[0])[0]
    small = small_panel(*SMALL_HW, 17)
    ycc = cv2.cvtColor(small, cv2.COLOR_BGR2YCrCb)[..., [0, 2, 1]]  # Y, Cb, Cr
    cmyk = np.concatenate([small[..., ::-1], np.maximum(small.max(-1, keepdims=True), 60)], -1)
    ref_bw = (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])
    return {
        "paeth_grey.png": chip_smoke.paeth_residual_png(grey, level=9),
        "grey16.png": encode(".png", grey16),
        "palette.png": pil(colour, "PNG", "P"),
        "adam7_rgb.png": adam7_rgb(37, 45, seed=14),
        "panel_420.jpg": encode(".jpg", chip_smoke.synthetic_colour_panel(15, (480, 640))),
        "odd_444.jpg": encode(".jpg", odd, (cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)),
        "progressive.jpg": encode(".jpg", odd, (cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                                cv2.IMWRITE_JPEG_OPTIMIZE, 1)),
        "exif6.jpg": pil(odd, "JPEG", quality=90, exif=exif.tobytes()),
        "grey_lzw_pred.tif": encode_tiff(grey, compression="lzw", predictor=2, rows_per_strip=16,
                                         order=">"),
        "rgb_deflate_tiles_o6.tif": encode_tiff(odd[..., ::-1], compression="deflate",
                                                tile=(32, 32), tags={274: (3, 6)}),
        "grey16_bigtiff_tiles.tif": encode_tiff(grey16, bits=16, compression="deflate",
                                                predictor=2, tile=(32, 32), bigtiff=True),
        "palette4_packbits.tif": encode_tiff(
            grey >> 4, bits=4, photometric=3, compression="packbits", rows_per_strip=8,
            tags={320: (3, np.random.default_rng(16).integers(0, 65536, 48))}),
        "rgba_unassoc_planar.tif": encode_tiff(
            np.concatenate([colour[..., ::-1], grey[..., None]], -1), compression="lzw", planar=2,
            rows_per_strip=32, tags={338: (3, [2])}),
        "cmyk.tif": encode_tiff(np.concatenate([255 - colour[..., ::-1], grey[..., None] // 4], -1),
                                photometric=5, ifd_first=True),
        "ycbcr420_tiles_o6.tif": encode_tiff(odd[..., ::-1], compression="jpeg", photometric=6,
                                             tile=(32, 32), streams=tiles, jpeg_tables=tables,
                                             tags={274: (3, 6), 530: (3, [2, 2])}),
        "rgb_jpeg_strips.tif": encode(".tiff", colour, (cv2.IMWRITE_TIFF_COMPRESSION, 7,
                                                        cv2.IMWRITE_TIFF_ROWSPERSTRIP, 16)),
        "grey_jpeg_strips.tif": encode_tiff(grey, compression="jpeg", rows_per_strip=16, order=">",
                                            streams=[split_tables(s)[1] for s in grey_strips],
                                            jpeg_tables=grey_tables),
        "progressive_jpeg.tif": encode_tiff(
            odd[..., ::-1], compression="jpeg", photometric=6, rows_per_strip=32,
            streams=jpeg_strips(odd, 32, (cv2.IMWRITE_JPEG_PROGRESSIVE, 1)),
            tags={530: (3, [2, 2])}),
        "cmyk_pil.jpg": pil(small, "JPEG", "CMYK", quality=90),
        "ycck_22.jpg": encode_cmyk(cmyk, 90, ((2, 2), (1, 1), (1, 1), (2, 2)), transform=2,
                                   restart=4),
        "cmyk_jpeg.tif": pil(small, "TIFF", "CMYK", compression="jpeg"),
        "ycbcr22_lzw_tiles_o6.tif": encode_tiff(ycc, photometric=6, subsampling=(2, 2),
                                                compression="lzw", tile=(32, 32),
                                                tags={274: (3, 6)}),
        "ycbcr_planar.tif": encode_tiff(ycc, photometric=6, planar=2, compression="deflate",
                                        rows_per_strip=16, tags={530: (3, [1, 1]), 532: ref_bw}),
    }


def cv2_pixels(files: dict[str, bytes]) -> dict[str, np.ndarray]:
    return {name: cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
            for name, data in files.items()}


def write(out: str) -> None:
    os.makedirs(out, exist_ok=True)
    files = fixtures()
    for name, data in files.items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
    np.savez_compressed(os.path.join(out, "cv2_pixels.npz"), cv2_version=np.array(cv2.__version__),
                        **cv2_pixels(files))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=OUT)
    write(p.parse_args(argv).out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
