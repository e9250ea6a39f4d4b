"""The port's image reader against ``cv2.imdecode(..., cv2.IMREAD_COLOR)`` and
the JAX package's readers.

``radnet_torch.data.image.decode_image`` / ``read_image`` (PNG through
``data/png.py`` and ``csrc/png_unfilter.cpp``, JPEG through ``data/jpeg.py``
and ``csrc/jpeg_decode.cpp``) must give cv2's BGR uint8 array, shape
included, with 0 differing pixels: every PNG bit depth and colour type,
interlaced or not, each filter on its own rows, tRNS, several IDATs and
PIL's output; cv2's JPEGs at four qualities and five samplings, sequential
and progressive, with optimized tables and restart intervals, at sizes no
MCU divides, and PIL's; EXIF orientations 1-8 in PNG and JPEG (TIFF has
its own tests, ``test_torch_tiff.py``, and a case here).  Where cv2
returns no image (a truncated file, a corrupt one), the port raises
``ValueError``; a format cv2 reads that the port does not yet read raises
``ValueError`` naming it.  Seeded corruptions of both formats hold the port
to cv2 file by file, but for the departures ROADMAP.md Queue 3 lists.

The references are cv2 5.0.0 built with libjpeg-turbo 3.1.2 (its AVX2 code
on an x86 host: the port keeps that IDCT's 16-bit lanes, which only corrupt
files reach) and libpng 1.6.58; ``test_reference_versions`` fails, naming
both, under others.  Then the port's ``get_image`` and ``cli.serve`` are held
against the JAX package's on JPEG, Paeth PNG, EXIF-rotated PNG and TIFF files with
the same weights, and the host library is built and used from several
threads at once.  The fixtures of ``tests/data/images`` (the card's host has
no cv2) must still be what ``scripts/make_image_fixtures.py`` writes and
live cv2 reads.
"""

import ctypes
import io
import json
import os
import re
import struct
import subprocess
import sys
import threading
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from radnet_torch.cli import serve as tserve
from radnet_torch.data import dataset as tdataset
from radnet_torch.data import image as timage
from radnet_torch.data import jpeg as tjpeg
from radnet_torch.data import png as tpng
from radnet_torch.ops import cuda_kernels, host_kernels
from radnet_tpu.cli import serve as jserve
from radnet_tpu.data import dataset as jdataset
from tests.test_torch_cascade import _assert_same_dets, _grey_panel
from tests.test_torch_test_cli import _write_jax_model_dir
from tests.torch_port_util import jax_resnet, port_cv2_resize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import chip_smoke  # noqa: E402
import export_jax_model  # noqa: E402
import make_image_fixtures  # noqa: E402

torch.set_num_threads(1)

REFERENCE = {"cv2": "5.0.0", "libjpeg-turbo": "3.1.2", "libpng": "1.6.58"}
SIZES = [(1, 1), (8, 9), (17, 23), (33, 257)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = make_image_fixtures.ADAM7
FIXTURES = os.path.join(ROOT, "tests", "data", "images")
# Departures from cv2 that ROADMAP.md Queue 3 accepts: a progressive JPEG
# whose refinement scans are missing (libjpeg-turbo smooths its blocks), and
# the variants not read yet (a corrupt SOF marker can name one).
DEPARTURES = ("missing refinement scans", "is not read yet")


def cv2_decode(data: bytes):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def assert_as_cv2(data: bytes) -> str:
    """The port's decode of ``data`` is cv2's, or both refuse it.  Returns
    "same", "both refuse" or the departure's message."""
    want = cv2_decode(data)
    try:
        got = timage.decode_image(data)
    except ValueError as e:
        if want is not None and any(d in str(e) for d in DEPARTURES):
            return str(e)
        assert want is None, f"the port raised {e!r}, cv2 read {want.shape}"
        return "both refuse"
    assert want is not None, f"cv2 refuses the file, the port read {got.shape}"
    assert got.shape == want.shape and got.dtype == np.uint8
    assert (got != want).sum() == 0, f"{(got != want).any(-1).sum()} pixels differ"
    return "same"


def smooth_panel(h, w, seed, c=3):
    """Natural-looking content: a blurred random field with edges and noise."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (max(1, h // 4) + 1, max(1, w // 4) + 1, c), dtype=np.uint8)
    img = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC).reshape(h, w, c)
    img = np.clip(img.astype(int) + rng.integers(-20, 21, img.shape), 0, 255).astype(np.uint8)
    return img if c > 1 else img[..., 0]


# --------------------------------------------------------------------------- #
# PNG
# --------------------------------------------------------------------------- #
def png_bytes(h, w, color, depth, interlace, seed, trns=False, n_idat=3, palette_len=256):
    """A PNG of random filtered bytes (any byte string is a valid filtered
    stream), each pass's rows taking the filter types 0-4 in turn, its
    zlib stream split over ``n_idat`` IDAT chunks."""
    rng = np.random.default_rng(seed)
    bits = CHANNELS[color] * depth
    passes = ADAM7 if interlace else [(0, 1, 0, 1)]
    raw = []
    for x0, dx, y0, dy in passes:
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if pw and ph:
            rows = rng.integers(0, 256, (ph, (pw * bits + 7) // 8 + 1), dtype=np.uint8)
            rows[:, 0] = np.arange(ph) % 5
            raw.append(rows.tobytes())
    body = tpng._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if color == 3:
        body += tpng._chunk(b"PLTE", rng.integers(0, 256, 3 * palette_len, dtype=np.uint8).tobytes())
    if trns:
        body += tpng._chunk(b"tRNS", {0: b"\x00\x01", 2: b"\x00\x01\x00\x02\x00\x03",
                                      3: bytes(range(7))}[color])
    z = zlib.compress(b"".join(raw))
    step = -(-len(z) // n_idat)
    for i in range(0, len(z), step):
        body += tpng._chunk(b"IDAT", z[i:i + step])
    return tpng._SIGNATURE + body + tpng._chunk(b"IEND", b"")


@pytest.mark.parametrize("interlace", [0, 1], ids=["progressive_rows", "adam7"])
@pytest.mark.parametrize("color,depth", [(c, d) for c, ds in tpng._DEPTHS.items() for d in ds])
def test_png_every_depth_and_colour_type(color, depth, interlace):
    for k, (h, w) in enumerate(SIZES):
        for trns in (False, True) if color in (0, 2, 3) else (False,):
            # A palette shorter than 2^depth: indices past it read black.
            data = png_bytes(h, w, color, depth, interlace, seed=k, trns=trns,
                             palette_len=100 if depth == 8 else 2 ** depth - 1)
            assert assert_as_cv2(data) == "same"


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P", "1", "LA", "I;16"])
def test_png_from_pil(mode):
    for k, (h, w) in enumerate(SIZES + [(61, 97)]):
        img = Image.fromarray(smooth_panel(h, w, k)[..., ::-1])
        img = img.convert("L").convert(mode) if mode == "I;16" else img.convert(mode)
        out = io.BytesIO()
        img.save(out, "PNG")
        assert assert_as_cv2(out.getvalue()) == "same"


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_from_cv2(channels, dtype):
    for k, (h, w) in enumerate(SIZES):
        img = smooth_panel(h, w, k, channels).astype(dtype) * (257 if dtype == np.uint16 else 1)
        for level in (1, 9):
            ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])
            assert ok and assert_as_cv2(buf.tobytes()) == "same"


def test_png_corrupt_and_truncated_as_cv2():
    """Cut at every 37th byte, a bad CRC, an incomplete or failing zlib
    stream, wrong data lengths, repeated or missing chunks: the port reads
    exactly what cv2 reads."""
    img = smooth_panel(37, 61, 0)
    data = tpng.encode_png(img)
    for cut in range(1, len(data), 37):
        assert assert_as_cv2(data[:cut]) == "both refuse"
    i = data.index(b"IDAT") - 4
    j = data.index(b"IEND") - 4
    ihdr, idat = data[8:i], data[i:j]
    raw = zlib.decompress(idat[8:-4])
    z = zlib.compress(raw)

    def with_idat(stream, n=1):
        step = -(-len(stream) // n)
        return (tpng._SIGNATURE + ihdr + b"".join(tpng._chunk(b"IDAT", stream[k:k + step])
                                                  for k in range(0, len(stream), step))
                + tpng._chunk(b"IEND", b""))

    bad_adler = z[:-1] + bytes([z[-1] ^ 1])
    flipped = bytearray(data)
    flipped[i + 20] ^= 1  # inside IDAT: its CRC no longer holds
    bad_iend = data[:-1] + bytes([data[-1] ^ 1])
    cases = {
        "bad IDAT CRC": (bytes(flipped), "both refuse"),
        "bad IEND CRC (cv2 does not read it)": (bad_iend, "same"),
        "bad adler32": (with_idat(bad_adler), "both refuse"),
        "no adler32": (with_idat(z[:-4]), "both refuse"),
        "data short by a byte": (with_idat(zlib.compress(raw[:-1])), "both refuse"),
        "data a byte long": (with_idat(zlib.compress(raw + b"\0")), "same"),
        "5 IDATs": (with_idat(z, 5), "same"),
        "no IEND": (data[:j], "both refuse"),
        "two IHDR": (data[:i] + data[8:i] + data[i:], "both refuse"),
        "bad filter type": (with_idat(zlib.compress(b"\x05" + raw[1:])), "both refuse"),
        "unknown critical chunk": (data[:i] + tpng._chunk(b"ABCD", b"x") + data[i:], "both refuse"),
        "bad ancillary CRC": (data[:i] + tpng._chunk(b"tEXt", b"a\0b")[:-1] + b"\0" + data[i:],
                              "same"),
        "garbage after IEND": (data + b"garbage", "same"),
    }
    for name, (case, want) in cases.items():
        assert assert_as_cv2(case) == want, name


@pytest.mark.parametrize("seed", [0, 1])
def test_png_seeded_corruptions_as_cv2(seed):
    """Bytes changed in IHDR and in the zlib stream, with the CRCs made good
    again, and chunks repeated or dropped."""
    rng = np.random.default_rng(seed)
    sources = []
    for mode in ("L", "RGB", "P", "1"):
        out = io.BytesIO()
        Image.fromarray(smooth_panel(37, 61, seed)[..., ::-1]).convert(mode).save(out, "PNG")
        sources.append(out.getvalue())
    sources.append(png_bytes(37, 61, 2, 8, 1, seed))

    def chunks(data):
        pos, out = 8, []
        while pos < len(data):
            (n,) = struct.unpack(">I", data[pos:pos + 4])
            out.append([data[pos + 4:pos + 8], bytearray(data[pos + 8:pos + 8 + n])])
            pos += 12 + n
        return out

    outcomes = set()
    for it in range(200):
        cs = chunks(sources[it % len(sources)])
        kind = it % 3
        if kind == 0:
            cs[0][1][rng.integers(0, 13)] = rng.integers(0, 256)
        elif kind == 1:
            k = next(k for k, (t, _) in enumerate(cs) if t == b"IDAT")
            cs[k][1][rng.integers(0, len(cs[k][1]))] = rng.integers(0, 256)
        else:
            k = rng.integers(0, len(cs))
            if rng.integers(0, 2):
                cs.insert(k, [cs[k][0], bytearray(cs[k][1])])
            else:
                del cs[k]
        data = tpng._SIGNATURE + b"".join(tpng._chunk(bytes(t), bytes(b)) for t, b in cs)
        outcomes.add(assert_as_cv2(data))
    assert outcomes == {"same", "both refuse"}


def test_png_size_limits_as_cv2():
    """libpng's default limit of 10^6 pixels a side; OpenCV's 2^30 pixels,
    where cv2 raises cv2.error."""
    def header_only(w, h):
        return (tpng._SIGNATURE + tpng._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + tpng._chunk(b"IDAT", zlib.compress(bytes(w + 1))) + tpng._chunk(b"IEND", b""))

    assert assert_as_cv2(header_only(1_000_001, 1)) == "both refuse"
    big = header_only(32769, 32768)
    with pytest.raises(cv2.error):
        cv2_decode(big)
    with pytest.raises(ValueError, match="size limits"):
        timage.decode_image(big)


# --------------------------------------------------------------------------- #
# JPEG
# --------------------------------------------------------------------------- #
SAMPLINGS = ["444", "422", "420", "440", "411"]


def cv2_jpeg(img, quality=95, sampling="420", progressive=0, optimize=0, rst=0) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
        cv2.IMWRITE_JPEG_OPTIMIZE, optimize, cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sampling)])
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("sampling", SAMPLINGS)
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_jpeg_from_cv2(quality, sampling):
    """Sequential and progressive, with and without optimized tables and a
    restart interval; grey input gives a one-component JPEG."""
    for k, (h, w) in enumerate(SIZES):
        img = smooth_panel(h, w, k)
        for progressive in (0, 1):
            for optimize in (0, 1):
                for rst in (0, 2):
                    data = cv2_jpeg(img, quality, sampling, progressive, optimize, rst)
                    assert assert_as_cv2(data) == "same"
        assert assert_as_cv2(cv2_jpeg(img[..., 1], quality, sampling)) == "same"


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_jpeg_from_pil(subsampling, progressive, mode):
    for k, (h, w) in enumerate(SIZES + [(61, 97)]):
        out = io.BytesIO()
        Image.fromarray(smooth_panel(h, w, k)[..., ::-1]).convert(mode).save(
            out, "JPEG", quality=85, subsampling=subsampling, progressive=progressive)
        assert assert_as_cv2(out.getvalue()) == "same"


def segments(data: bytes):
    """(marker, start, end) of each marker segment before the first scan's data."""
    pos, out = 2, []
    while True:
        marker = data[pos + 1]
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        out.append((marker, pos, pos + 2 + n))
        if marker == 0xDA:
            return out
        pos += 2 + n


def drop_segments(data: bytes, markers) -> bytes:
    keep = [data[s:e] for m, s, e in segments(data) if m not in markers]
    return data[:2] + b"".join(keep) + data[segments(data)[-1][2]:]


def test_jpeg_rgb_coded_and_without_huffman_tables():
    """No JFIF marker and component IDs R, G, B: libjpeg-turbo reads RGB, not
    YCbCr.  No DHT (a Motion-JPEG frame): a sequential JPEG takes the
    standard tables; a progressive one is refused."""
    img = smooth_panel(33, 57, 3)
    data = drop_segments(cv2_jpeg(img, sampling="444"), {0xE0})
    sof = next(s for m, s, _ in segments(data) if m == 0xC0)
    sos = next(s for m, s, _ in segments(data) if m == 0xDA)
    rgb = bytearray(data)
    for k, cid in enumerate(b"RGB"):
        rgb[sof + 10 + 3 * k] = cid
        rgb[sos + 5 + 2 * k] = cid
    assert assert_as_cv2(bytes(rgb)) == "same"
    assert not (timage.decode_image(bytes(rgb)) == timage.decode_image(data)).all()
    assert assert_as_cv2(drop_segments(cv2_jpeg(img), {0xC4})) == "same"
    assert assert_as_cv2(drop_segments(cv2_jpeg(img, progressive=1), {0xC4})) == "both refuse"


@pytest.mark.parametrize("sampling", ["420", "444"])
@pytest.mark.parametrize("progressive", [0, 1])
@pytest.mark.parametrize("rst", [0, 3])
def test_jpeg_truncated_as_cv2(sampling, progressive, rst):
    """cv2 gets no image where libjpeg-turbo's reader reaches the end of the
    data (OpenCV's memory source suspends it): every cut of a progressive
    file, a sequential one's anywhere before its last bits.  A sequential
    file without its EOI is read when the reader never looked past it."""
    data = cv2_jpeg(smooth_panel(61, 131, 5), 90, sampling, progressive, 0, rst)
    outcomes = [assert_as_cv2(data[:cut])
                for cut in list(range(1, len(data) - 10, 97)) + list(range(len(data) - 10, len(data) + 1))]
    assert outcomes[-1] == "same" and "both refuse" in outcomes


def test_jpeg_restart_and_marker_faults_as_cv2():
    """A wrong, missing or early RSTn (libjpeg's resync), garbage after one,
    a marker inside the entropy data (zero bits fed, the rest of the
    segment grey), garbage before EOI, data after EOI."""
    for progressive in (0, 1):
        for sampling in ("420", "444"):
            data = cv2_jpeg(smooth_panel(61, 131, 6), 90, sampling, progressive, 0, 3)
            rst = [i for i in range(len(data) - 1) if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
            mid = rst[len(rst) // 2]

            def renumber(step):
                b = bytearray(data)
                b[mid + 1] = 0xD0 + ((b[mid + 1] - 0xD0 + step) & 7)
                return bytes(b)

            marker = bytearray(data)
            marker[rst[len(rst) // 3] + 5: rst[len(rst) // 3] + 7] = b"\xff\xe1"
            cases = [renumber(4), renumber(1), renumber(-1), data[:mid] + data[mid + 2:],
                     data[:mid + 2] + b"\x11\x22\x33" + data[mid + 2:], bytes(marker),
                     data[:-2] + b"\x12\x34" + data[-2:], data + b"\x00\x01\x02"]
            for case in cases:
                assert_as_cv2(case)


@pytest.mark.parametrize("seed", [0, 1])
def test_jpeg_seeded_corruptions_as_cv2(seed):
    """One to three bytes changed anywhere: tables, headers and data.  The
    decoded pixels are cv2's, including where corrupt coefficients leave
    16 bits in the IDCT."""
    rng = np.random.default_rng(seed)
    img = smooth_panel(45, 131, seed)
    outcomes = []
    for it in range(300):
        data = bytearray(cv2_jpeg(img, 80, SAMPLINGS[it % 5], it % 2, 0, 2 * ((it // 2) % 2)))
        for _ in range(rng.integers(1, 4)):
            data[rng.integers(2, len(data))] = rng.integers(0, 256)
        outcomes.append(assert_as_cv2(bytes(data)))
    assert outcomes.count("same") > 200 and "both refuse" in outcomes
    assert sum(o not in ("same", "both refuse") for o in outcomes) <= 6


def test_jpeg_size_limit_as_cv2():
    data = bytearray(cv2_jpeg(smooth_panel(16, 16, 0)))
    sof = next(s for m, s, _ in segments(bytes(data)) if m == 0xC0)
    data[sof + 5:sof + 9] = struct.pack(">HH", 40000, 40000)
    with pytest.raises(cv2.error):
        cv2_decode(bytes(data))
    with pytest.raises(ValueError, match="size limits"):
        timage.decode_image(bytes(data))


@pytest.mark.parametrize("variant,marker,precision,n_comp", [
    ("arithmetic-coded JPEG (SOF9)", 0xC9, 8, 3),
    ("lossless JPEG (SOF3)", 0xC3, 8, 3),
    ("12-bit JPEG", 0xC0, 12, 3),
    ("4-component JPEG (Adobe CMYK/YCCK)", 0xC0, 8, 4),
])
def test_jpeg_variants_not_read_yet_raise(variant, marker, precision, n_comp):
    """libjpeg-turbo under cv2 reads these; the port names them.  The frame
    header is made by hand in a baseline file: the error comes before any
    data is read.  4-component JPEG is read now
    (tests/test_torch_image_colour.py): its file here, a 4-component frame
    over the 3-component scan, is held to cv2."""
    data = cv2_jpeg(smooth_panel(16, 16, 0))
    _, start, end = next(seg for seg in segments(data) if seg[0] == 0xC0)
    comps = b"".join(bytes([i + 1, 0x11, int(i > 0)]) for i in range(n_comp))
    body = bytes([precision]) + struct.pack(">HHB", 16, 16, n_comp) + comps
    sof = bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body
    if n_comp == 4:
        assert assert_as_cv2(data[:start] + sof + data[end:]) in ("same", "both refuse")
        return
    with pytest.raises(ValueError, match=re.escape(variant)):
        timage.decode_image(data[:start] + sof + data[end:])


# --------------------------------------------------------------------------- #
# EXIF orientation, formats, errors
# --------------------------------------------------------------------------- #
def exif_tiff(orientation: int, order: str) -> bytes:
    e = "<" if order == "II" else ">"
    return (order.encode() + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 2)
            + struct.pack(e + "HHI", 0x010F, 2, 4) + b"abc\0"
            + struct.pack(e + "HHIH", 0x0112, 3, 1, orientation) + b"\0\0" + b"\0\0\0\0")


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(orientation, fmt, order):
    """PIL writes the EXIF (JPEG APP1, PNG eXIf), little- or big-endian;
    orientations 5-8 swap height and width, as cv2 does."""
    img = smooth_panel(23, 41, orientation)
    out = io.BytesIO()
    Image.fromarray(img[..., ::-1]).save(out, fmt, exif=b"Exif\0\0" + exif_tiff(orientation, order))
    assert assert_as_cv2(out.getvalue()) == "same"
    got = timage.decode_image(out.getvalue())
    assert got.shape[:2] == ((41, 23) if orientation >= 5 else (23, 41))


def test_exif_orientation_in_png_after_idat_and_bad_values():
    img = smooth_panel(23, 41, 0)
    data = tpng.encode_png(img)
    end = data.index(b"IEND") - 4
    for orientation in (6, 0, 9, 300):
        late = data[:end] + tpng._chunk(b"eXIf", exif_tiff(orientation, "II")) + data[end:]
        assert assert_as_cv2(late) == "same"
    assert timage.exif_orientation(b"II*\0\xff\xff\xff\xff") == 1


# ext -> the name the port gives; each is a format cv2.imencode writes and
# cv2.imdecode reads back.  TIFF is read now: its case holds the port to cv2.
NOT_YET = {".tif": "TIFF", ".bmp": "BMP", ".webp": "WebP", ".jp2": "JPEG 2000", ".ppm": "PNM",
           ".pgm": "PNM", ".pbm": "PNM", ".pam": "PAM", ".pfm": "PFM", ".hdr": "Radiance HDR",
           ".ras": "Sun raster", ".avif": "AVIF", ".gif": "GIF"}


@pytest.mark.parametrize("ext", sorted(NOT_YET))
def test_formats_not_read_yet_raise_naming_them(ext):
    img = smooth_panel(40, 48, 0)  # OpenJPEG wants a tile of 32 or more a side
    if ext in (".pfm", ".hdr"):
        img = img.astype(np.float32) / 255
    if ext in (".pgm", ".pbm"):
        img = img[..., 0]
    ok, buf = cv2.imencode(ext, img)
    assert ok and cv2_decode(buf.tobytes()) is not None
    if ext == ".tif":
        assert assert_as_cv2(buf.tobytes()) == "same"
        return
    with pytest.raises(ValueError, match=NOT_YET[ext]):
        timage.decode_image(buf.tobytes())


def test_missing_and_unknown_files(tmp_path):
    with pytest.raises(FileNotFoundError):
        timage.read_image(str(tmp_path / "missing.png"))
    for junk in (b"", b"hello", b"\xff\xd8\x00\x00"):  # cv2 wants FF D8 FF for a JPEG
        assert cv2_decode(junk + b"\0" * 8) is None
        with pytest.raises(ValueError):
            timage.decode_image(junk + b"\0" * 8)


# --------------------------------------------------------------------------- #
# Fixtures for the card, the host library, the JAX package
# --------------------------------------------------------------------------- #
def test_reference_versions():
    info = cv2.getBuildInformation()
    have = {"cv2": cv2.__version__,
            "libjpeg-turbo": info.split("build-libjpeg-turbo (ver ")[1].split("-")[0],
            "libpng": info.split("libpng.so (ver ")[1].split(")")[0]}
    assert have == REFERENCE, f"the reader was held to {REFERENCE}; this host has {have}"


def test_fixtures_equal_live_cv2(tmp_path):
    make_image_fixtures.main(["--out", str(tmp_path)])
    saved = np.load(os.path.join(FIXTURES, "cv2_pixels.npz"))
    names = sorted(f for f in os.listdir(FIXTURES) if not f.endswith(".npz"))
    assert names == sorted(f for f in os.listdir(tmp_path) if not f.endswith(".npz"))
    assert sorted(saved.files) == sorted(names + ["cv2_version"])
    assert str(saved["cv2_version"]) == cv2.__version__
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        with open(tmp_path / name, "rb") as f:
            assert f.read() == data, f"{name} is not what the script writes now"
        np.testing.assert_array_equal(saved[name], cv2_decode(data))
        np.testing.assert_array_equal(timage.read_image(os.path.join(FIXTURES, name)), saved[name])


def test_host_library_built_and_used_from_threads(tmp_path, monkeypatch):
    """Both libraries built at first use into an empty build directory, once,
    while 8 threads decode through them at once; every result is cv2's."""
    monkeypatch.setattr(cuda_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(host_kernels, "BUILD_DIR", tmp_path)
    fresh = [host_kernels.HostLibrary(lib.source, lib.functions)
             for lib in (tpng.PNG_UNFILTER, tjpeg.JPEG_DECODE)]
    monkeypatch.setattr(tpng, "PNG_UNFILTER", fresh[0])
    monkeypatch.setattr(tjpeg, "JPEG_DECODE", fresh[1])
    files = [png_bytes(33, 257, 2, 8, k % 2, k) for k in range(4)]
    files += [cv2_jpeg(smooth_panel(61, 97, k), 90, SAMPLINGS[k], k % 2) for k in range(4)]
    results, errors = [None] * 32, []

    def work(i):
        try:
            results[i] = timage.decode_image(files[i % len(files)])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    for i, got in enumerate(results):
        np.testing.assert_array_equal(got, cv2_decode(files[i % len(files)]))
    built = sorted(p.name for p in tmp_path.iterdir())
    assert len(built) == 2 and all(p.endswith(".so") for p in built), built
    assert all(lib.build_s > 0 for lib in fresh)


def test_host_library_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises; there is no fallback."""
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(host_kernels, "CSRC", tmp_path)
    monkeypatch.setattr(cuda_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(host_kernels, "BUILD_DIR", tmp_path / "build")
    lib = host_kernels.HostLibrary("broken.cpp", {"f": (ctypes.c_int, [])})
    with pytest.raises(RuntimeError, match="broken.cpp"):
        lib.fn("f")


def test_reader_loads_no_codec_module():
    """Importing and running the reader (JPEG, PNG, TIFF) loads no OpenCV,
    PIL or JAX."""
    code = ("import sys; from radnet_torch.data.image import read_image; "
            f"read_image({os.path.join(FIXTURES, 'panel_420.jpg')!r}); "
            f"read_image({os.path.join(FIXTURES, 'paeth_grey.png')!r}); "
            f"read_image({os.path.join(FIXTURES, 'grey_lzw_pred.tif')!r}); "
            "bad = [m for m in ('cv2', 'PIL', 'tifffile', 'jax', 'radnet_tpu') if m in sys.modules]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)


@pytest.mark.parametrize("kind", ["jpeg", "paeth_png"])
def test_get_image_matches_jax(kind, tmp_path, monkeypatch):
    """A typed dataset of JPEG panels (grey and colour, one EXIF-rotated) or
    of grey PNGs written with real Paeth residuals."""
    rels = []
    for k in range(3):
        img = smooth_panel(45 + k, 70, k)
        for img_type in ("enhanced_topo_grey", "topo_grey"):
            rel = f"data/{img_type}/train/p{k}.{'jpg' if kind == 'jpeg' else 'png'}"
            (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
            if kind == "jpeg":
                out = io.BytesIO()
                exif = b"Exif\0\0" + exif_tiff(6, "MM") if k == 2 else b""
                Image.fromarray(img[..., ::-1]).convert("L" if k == 0 else "RGB").save(
                    out, "JPEG", quality=90, exif=exif)
                data = out.getvalue()
            else:
                data = chip_smoke.paeth_residual_png(img[..., k])
            (tmp_path / rel).write_bytes(data)
        rels.append(f"data/train/p{k}.{'jpg' if kind == 'jpeg' else 'png'}")
    monkeypatch.chdir(tmp_path)
    for rel in rels:
        for types in (["enhanced_topo_grey"], ["topo_grey", "enhanced_topo_grey"]):
            got = tdataset.get_image(rel, types)
            want = jdataset.get_image(rel, types)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """A tiny ResNet50 directory the JAX package wrote, then exported."""
    cfg, model, params, bstats = jax_resnet(0)
    path = tmp_path_factory.mktemp("models") / "jax_model"
    _write_jax_model_dir(path, cfg, model, params, bstats)
    export_jax_model.main([str(path)])
    return path


def test_serve_matches_jax_on_jpeg_and_exif_png(jax_dir, tmp_path, monkeypatch, capsys):
    """``cli.serve`` of both packages on one model directory: a JPEG panel,
    the same panel as a PNG with EXIF orientation 6, as a TIFF (cv2's LZW),
    a BMP (a format the port does not read yet: an error record from the
    port, detections from JAX's cv2) and a missing file; the port keeps
    serving after both errors."""
    monkeypatch.setattr(cv2, "resize", port_cv2_resize)
    monkeypatch.setenv("RADNET_COMPILE_CACHE", str(tmp_path / "jax_cache"))
    panel = _grey_panel(21)
    tint = panel.astype(np.int16) + np.array([-10, 0, 12], np.int16)
    colour = np.clip(tint, 0, 255).astype(np.uint8)
    paths = {name: str(tmp_path / name) for name in ("p.jpg", "p.png", "p.tif", "p.bmp")}
    Image.fromarray(colour[..., ::-1]).save(paths["p.jpg"], "JPEG", quality=92)
    Image.fromarray(panel[..., ::-1]).save(paths["p.png"], "PNG",
                                             exif=b"Exif\0\0" + exif_tiff(6, "II"))
    assert cv2.imwrite(paths["p.tif"], panel)
    assert cv2.imwrite(paths["p.bmp"], panel)
    lines = [paths["p.jpg"], paths["p.png"], paths["p.tif"], paths["p.bmp"],
             str(tmp_path / "missing.png"), paths["p.jpg"]]
    argv = ["--models-path", str(jax_dir.parent), "--model-name", jax_dir.name]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
    assert jserve.main(argv) == 0
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    out = io.StringIO()
    assert tserve.main(argv + ["--device", "cpu"], stdin=io.StringIO("\n".join(lines) + "\n"),
                       stdout=out) == 0
    got = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [r["path"] for r in got] == [r["path"] for r in want] == lines
    assert "BMP" in got[3]["error"] and "detections" in want[3]
    assert "error" in got[4] and "error" in want[4]
    for k in (0, 1, 2, 5):
        assert len(want[k]["detections"]) > 0
        dets = [[{"class": d["label"], "prob": d["confidence"],
                  **{c: d[c] for c in ("x1", "y1", "x2", "y2")}} for d in r[k]["detections"]]
                for r in (got, want)]
        _assert_same_dets(*dets)
