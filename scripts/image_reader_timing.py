#!/usr/bin/env python3
"""Time the port's image reader (radnet_torch/data/image.py) on this host.

Builds the reader's host libraries (csrc/png_unfilter.cpp, csrc/jpeg_decode.cpp,
csrc/tiff_decode.cpp) into an empty build directory and prints their build
seconds, then decodes,
``--repeats`` times each in turns, and prints the median, the fastest and the
slowest seconds of:

* ``paeth_1000x1000``   a grey PNG of random bytes under the Paeth filter on
                        every row (chip_smoke.py's ``png_decode_paeth_1000x1000_s``);
* ``paeth_4400x3000``   chip_smoke.py's synthetic grey panel written with real
                        Paeth residuals on every row;
* ``filter0_4400x3000`` the same panel written by the port's writer (filter 0);
* ``inflate_4400x3000_paeth``  zlib's share of the Paeth panel's decode;
* ``tiff_lzw_pred_strips_4400x3000``, ``tiff_deflate_tiles_4400x3000``,
  ``tiff_none_4400x3000``  the panel as a TIFF (scripts/tiff_writer.py) of
                        LZW + Predictor 2 strips of 16 rows, of Deflate tiles
                        of 256, and uncompressed in one strip (which libtiff
                        chops into strips of about 8 KiB);
* ``tiff_jpeg_tiles_4400x3000``  the panel as a JPEG-compressed TIFF of 256 x
                        256 tiles at quality 90 (scripts/jpeg_writer.py), its
                        tables in JPEGTables (chip_smoke.py's
                        ``tiff_decode_jpeg_4400x3000_s``);
* ``jpeg_ycck_22_4400x3000``  the panel as a YCCK JPEG (its grey as K, no ink
                        in C, M, Y; Y and K sampled 2 x 2; a restart every
                        row of MCUs; scripts/jpeg_writer.py), as
                        chip_smoke.py writes it;
* ``tiff_ycbcr22_lzw_strips_4400x3000``  the panel as packed YCbCr 2, 2 in LZW
                        strips of 16 rows (Cb = Cr = 128), as chip_smoke.py
                        writes it;
* every file of tests/data/images (``panel_420.jpg`` is a 640 x 480 JPEG).

Each decode is checked against the pixels written (or the cv2 pixels stored
beside the fixtures; the JPEG-TIFF and YCCK panels, which are lossy,
against their first decodes).  The last lines are the host's CPU model, the
card's ``nvidia-smi --query-gpu=name,power.limit`` line where there is a
card, and one JSON object of the readings.

Usage:
  python3 scripts/image_reader_timing.py [--repeats 7]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from radnet_torch.data.image import decode_image  # noqa: E402
from radnet_torch.data.png import encode_png  # noqa: E402
from radnet_torch.ops import cuda_kernels, host_kernels  # noqa: E402
from jpeg_writer import encode_cmyk, encode_tiles  # noqa: E402
from tiff_writer import encode_tiff  # noqa: E402


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return next(line.split(":", 1)[1].strip() for line in f if line.startswith("model name"))
    except (OSError, StopIteration):
        return platform.processor() or "unknown"


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no card"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--repeats", type=int, default=7)
    args = p.parse_args(argv)

    with tempfile.TemporaryDirectory() as build_dir:
        cuda_kernels.BUILD_DIR = host_kernels.BUILD_DIR = Path(build_dir)
        build_s = cuda_kernels.build(host_kernels.LIBRARIES)
        for lib in host_kernels.LIBRARIES:
            lib.fn(next(iter(lib.functions)))

        grey = chip_smoke.synthetic_grey_panel(chip_smoke.SEED)
        paeth_panel = chip_smoke.paeth_residual_png(grey)
        files = {"paeth_1000x1000": (chip_smoke.paeth_png(1000, 1000), None),
                 "paeth_4400x3000": (paeth_panel, chip_smoke.bgr(grey)),
                 "filter0_4400x3000": (encode_png(grey), chip_smoke.bgr(grey)),
                 "tiff_lzw_pred_strips_4400x3000": (
                     encode_tiff(grey, compression="lzw", predictor=2, rows_per_strip=16),
                     chip_smoke.bgr(grey)),
                 "tiff_deflate_tiles_4400x3000": (
                     encode_tiff(grey, compression="deflate", tile=(256, 256)), chip_smoke.bgr(grey)),
                 "tiff_none_4400x3000": (encode_tiff(grey), chip_smoke.bgr(grey))}
        tables, streams = encode_tiles(grey, (256, 256), quality=90)
        jpeg_tif = encode_tiff(grey, compression="jpeg", tile=(256, 256), streams=streams,
                               jpeg_tables=tables)
        files["tiff_jpeg_tiles_4400x3000"] = (jpeg_tif, decode_image(jpeg_tif))
        white, mid = np.full_like(grey, 255), np.full_like(grey, 128)
        ycck = encode_cmyk(np.stack([white] * 3 + [grey], -1), 90, ((2, 2), (1, 1), (1, 1), (2, 2)),
                           transform=2, restart=-(-grey.shape[1] // 16))
        files["jpeg_ycck_22_4400x3000"] = (ycck, decode_image(ycck))
        files["tiff_ycbcr22_lzw_strips_4400x3000"] = (
            encode_tiff(np.stack([grey, mid, mid], -1), photometric=6, subsampling=(2, 2),
                        compression="lzw", rows_per_strip=16), chip_smoke.bgr(grey))
        fixtures = np.load(os.path.join(chip_smoke.IMAGE_FIXTURES, "cv2_pixels.npz"))
        for name in sorted(f for f in fixtures.files if f != "cv2_version"):
            with open(os.path.join(chip_smoke.IMAGE_FIXTURES, name), "rb") as f:
                files[name] = (f.read(), fixtures[name])
        idat = paeth_panel[8 + 25 + 8:-12 - 4]

        times: dict = {k: [] for k in list(files) + ["inflate_4400x3000_paeth"]}
        for _ in range(args.repeats):
            for name, (data, want) in files.items():
                t0 = time.perf_counter()
                got = decode_image(data)
                times[name].append(time.perf_counter() - t0)
                if want is not None and not (got.shape == want.shape and (got == want).all()):
                    raise SystemExit(f"{name}: the decode is not the pixels written")
            t0 = time.perf_counter()
            zlib.decompress(idat)
            times["inflate_4400x3000_paeth"].append(time.perf_counter() - t0)

    readings = {"host_library_build_s": build_s, "repeats": args.repeats,
                "decode_s": {k: {"median": statistics.median(v), "min": min(v), "max": max(v)}
                             for k, v in times.items()}}
    print(f"cpu: {cpu_model()}, {os.cpu_count()} cores")
    print(card())
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
