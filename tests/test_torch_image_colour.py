"""Colour as cv2 converts it: the port's reader against ``cv2.imdecode(...,
cv2.IMREAD_COLOR)`` on 4-component JPEG, JPEG-TIFF of 4 samples and YCbCr
TIFF.

``radnet_torch.data.image.read_image`` must give cv2's BGR uint8 array, shape
included, with 0 differing pixels, or both refuse.  The files are PIL's CMYK
JPEGs (their Adobe colour transform patched to 2, to an unknown code, or the
Adobe segment taken out), ``scripts/jpeg_writer.py``'s CMYK and YCCK streams
at any sampling and restart interval, PIL's CMYK and RGBA JPEG-TIFFs and
wrapped 4-component streams, and ``scripts/tiff_writer.py``'s packed YCbCr
at the 7 subsamplings libtiff puts (strips and tiles at sizes no block
divides, every codec, Predictor 2, Orientation 1-8, ReferenceBlackWhite and
YCbCrCoefficients other than the defaults) and separate YCbCr planes, raw and
JPEG.  What cv2 refuses the port refuses; seeded corruptions hold both to
the same outcome but for at most 2 a seed that raise naming a variant not
read yet (ROADMAP.md Queue 3).  The port's ``get_image`` is held against
the JAX package's on a CMYK JPEG and a YCbCr TIFF.  The reference is cv2
5.0.0 with its libtiff 4.7.1 and libjpeg-turbo 3.1.2
(``test_reference_versions`` in ``test_torch_image_decode.py``).
"""

import io
import os
import struct
import sys
import tempfile

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from radnet_torch.data import dataset as tdataset
from radnet_torch.data import image as timage
from radnet_tpu.data import dataset as jdataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from jpeg_writer import encode_cmyk  # noqa: E402
from tiff_writer import encode_tiff  # noqa: E402

torch.set_num_threads(1)

# The port's departures from cv2 that ROADMAP.md Queue 3 accepts: variants
# not read yet, and a progressive JPEG whose refinement scans are missing
# (libjpeg-turbo smooths its blocks); a corrupt file can make either.
DEPARTURES = ("is not read yet", "missing refinement scans")
ODD = [(37, 53), (53, 37), (1, 1), (17, 33)]
SUBSAMPLINGS = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)]
REF_BW_JPEG = (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])  # Rec. 601 ranges
COEF_709 = (5, [(2126, 10000), (7152, 10000), (722, 10000)])


def cv2_decode(data: bytes):
    try:
        return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        return None


def read_port(data: bytes) -> np.ndarray:
    """``read_image`` of the bytes written to a file."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "image")
        with open(path, "wb") as f:
            f.write(data)
        return timage.read_image(path)


def assert_as_cv2(data: bytes) -> str:
    """The port's read is cv2's, or both refuse.  Returns "same", "both
    refuse" or the departure's message."""
    want = cv2_decode(data)
    try:
        got = read_port(data)
    except ValueError as e:
        if want is not None and any(d in str(e) for d in DEPARTURES):
            return str(e)
        assert want is None, f"the port raised {e!r}, cv2 read {want.shape}"
        return "both refuse"
    assert want is not None, f"cv2 refuses the file, the port read {got.shape}"
    assert got.shape == want.shape and got.dtype == np.uint8, (got.shape, want.shape)
    assert (got != want).sum() == 0, f"{(got != want).any(-1).sum()} pixels differ"
    return "same"


def walk(h, w, c, seed):
    """Smooth content: a cumulative random walk along each row, per channel."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.integers(0, 24, (h, w, c)), axis=1).astype(np.uint8)


def pil_cmyk(rgb, fmt="JPEG", **kw) -> bytes:
    out = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(out, fmt, **kw)
    return out.getvalue()


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


def with_transform(data: bytes, transform) -> bytes:
    """The Adobe segment's colour transform set to ``transform``, or the
    segment taken out (None)."""
    _, start, end = next(s for s in segments(data) if s[0] == 0xEE)
    if transform is None:
        return data[:start] + data[end:]
    out = bytearray(data)
    out[start + 4 + 11] = transform
    return bytes(out)


# --------------------------------------------------------------------------- #
# 4-component JPEG
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("transform", [0, 2, 1, 7, 255, None],
                         ids=["cmyk", "ycck", "unknown_1", "unknown_7", "unknown_255", "no_adobe"])
def test_adobe_transform_as_cv2(transform):
    """libjpeg-turbo's colour space of 4 components: Adobe transform 0 is
    CMYK, 2 YCCK, any other code YCCK (with a warning), no Adobe segment
    CMYK; OpenCV then converts CMYK to BGR.  PIL writes transform 0."""
    for k, (h, w) in enumerate(ODD):
        rgb = walk(h, w, 3, k)
        for kw in ({}, {"subsampling": 2}, {"progressive": True}):
            data = pil_cmyk(rgb, quality=90, **kw)
            assert next(s for s in segments(data) if s[0] == 0xEE)
            assert assert_as_cv2(with_transform(data, transform)) == "same"


@pytest.mark.parametrize("kw", [{"subsampling": 0}, {"subsampling": 1}, {"subsampling": 2},
                                {"progressive": True}, {"progressive": True, "optimize": True},
                                {"restart_marker_blocks": 3}, {"restart_marker_rows": 1}],
                         ids=["444", "422", "420", "progressive", "progressive_optimized",
                              "restart_3", "restart_row"])
def test_pil_cmyk_jpeg(kw):
    """PIL's CMYK JPEGs (libjpeg's own encoder): baseline at three
    samplings, progressive, restart intervals; each also read as YCCK."""
    for k, (h, w) in enumerate(ODD + [(61, 97)]):
        data = pil_cmyk(walk(h, w, 3, k), quality=85, **kw)
        for transform in (0, 2):
            assert assert_as_cv2(with_transform(data, transform)) == "same"


FACTORS = {
    "1111": ((1, 1),) * 4,
    "y22_k22": ((2, 2), (1, 1), (1, 1), (2, 2)),
    "y21_cr12": ((2, 1), (1, 1), (1, 2), (1, 1)),
    "cb22": ((1, 1), (2, 2), (1, 1), (1, 1)),
    "y41_k21": ((4, 1), (1, 1), (1, 1), (2, 1)),
    "y12_k12": ((1, 2), (1, 1), (1, 1), (1, 2)),
}


@pytest.mark.parametrize("factors", list(FACTORS.values()), ids=list(FACTORS))
def test_written_4_component_jpeg(factors):
    """scripts/jpeg_writer.py's streams at per-component sampling (the MCU
    at most 10 blocks), Adobe transform 0, 2 or none, with and without a
    restart interval, at sizes no MCU divides."""
    for k, (h, w) in enumerate(ODD + [(2, 3)]):
        cmyk = walk(h, w, 4, k)
        for transform in (0, 2, None):
            for restart in (0, 2):
                data = encode_cmyk(cmyk, 90, factors, transform, restart)
                assert assert_as_cv2(data) == "same", (h, w, transform, restart)


def test_writer_near_the_samples():
    """What the writer stores as CMYK or YCCK decodes near the samples as
    OpenCV converts them: each of Y, M, C as K - ((255 - X) * K >> 8)."""
    cmyk = np.repeat(np.repeat(walk(16, 18, 4, 3), 4, 0), 4, 1) // 3 + 170
    k = cmyk[..., 3].astype(int)
    want = np.stack([k - ((255 - cmyk[..., c].astype(int)) * k >> 8) for c in (2, 1, 0)], -1)
    for transform in (0, 2):
        got = read_port(encode_cmyk(cmyk, 95, ((1, 1),) * 4, transform)).astype(int)
        assert np.abs(got - want).mean() < 1.5, transform


def test_exif_orientation_on_cmyk():
    """EXIF orientation 6 applied after the colour conversion, at odd sizes."""
    exif = Image.Exif()
    exif[0x0112] = 6
    for k, (h, w) in enumerate(ODD):
        data = pil_cmyk(walk(h, w, 3, k), quality=90, exif=exif.tobytes())
        for transform in (0, 2, None):
            assert assert_as_cv2(with_transform(data, transform)) == "same"
        assert read_port(data).shape[:2] == (w, h)


def test_mcu_over_10_blocks_refused_by_both():
    """libjpeg-turbo's D_MAX_BLOCKS_IN_MCU: an MCU of 11 blocks is refused,
    one of 10 is read."""
    cmyk = walk(37, 53, 4, 4)
    for transform in (0, 2):
        assert assert_as_cv2(encode_cmyk(cmyk, 90, ((2, 2), (2, 1), (1, 1), (2, 2)),
                                         transform)) == "both refuse"
        assert assert_as_cv2(encode_cmyk(cmyk, 90, ((2, 2), (1, 1), (1, 1), (2, 2)),
                                         transform)) == "same"


# --------------------------------------------------------------------------- #
# JPEG-TIFF of 4 samples
# --------------------------------------------------------------------------- #
def cmyk_streams(cmyk, rows, transform=None) -> list:
    return [encode_cmyk(cmyk[y:y + rows], 90, ((1, 1),) * 4, transform)
            for y in range(0, cmyk.shape[0], rows)]


@pytest.mark.parametrize("case", ["pil_cmyk", "pil_rgba", "cmyk_strips", "cmyk_ycck_streams",
                                  "rgb_extra", "rgb_unassociated_alpha", "cmyk_tiles_o6"])
def test_jpeg_tiff_of_4_samples(case):
    """libtiff's JPEG codec hands 4 samples on as they are (an Adobe
    transform in the streams is not applied); the CMYK put, or RGB's with an
    alpha sample (associated, unspecified: dropped; unassociated:
    premultiplied)."""
    for k, (h, w) in enumerate(ODD):
        rgb, c4 = walk(h, w, 3, k), walk(h, w, 4, k)
        if case == "pil_cmyk":
            data = pil_cmyk(rgb, "TIFF", compression="jpeg")
        elif case == "pil_rgba":
            out = io.BytesIO()
            Image.fromarray(rgb).convert("RGBA").save(out, "TIFF", compression="jpeg")
            data = out.getvalue()
        elif case == "cmyk_tiles_o6":
            tiles = []
            for y in range(0, h, 16):
                for x in range(0, w, 32):
                    block = np.zeros((16, 32, 4), np.uint8)
                    part = c4[y:y + 16, x:x + 32]
                    block[:part.shape[0], :part.shape[1]] = part
                    tiles.append(encode_cmyk(block, 90, ((1, 1),) * 4, None))
            data = encode_tiff(c4, compression="jpeg", photometric=5, tile=(32, 16), streams=tiles,
                               tags={274: (3, 6)})
        else:
            photometric = 5 if case.startswith("cmyk") else 2
            tags = {338: (3, [2])} if case == "rgb_unassociated_alpha" else {}
            streams = cmyk_streams(c4, 16, 2 if case == "cmyk_ycck_streams" else None)
            data = encode_tiff(c4, compression="jpeg", photometric=photometric, rows_per_strip=16,
                               streams=streams, tags=tags)
        assert assert_as_cv2(data) == "same"


def test_jpeg_tiff_of_4_samples_checks():
    """libtiff's checks hold for 4 samples: a stream of 3 components, or
    one whose first component is subsampled, is refused by both."""
    c4 = walk(37, 53, 4, 5)
    three = [cv2.imencode(".jpg", c4[y:y + 16, :, :3])[1].tobytes() for y in range(0, 37, 16)]
    sub = [encode_cmyk(c4[y:y + 16], 90, ((2, 2), (1, 1), (1, 1), (1, 1))) for y in range(0, 37, 16)]
    for streams in (three, sub):
        data = encode_tiff(c4, compression="jpeg", photometric=5, rows_per_strip=16, streams=streams)
        assert assert_as_cv2(data) == "both refuse"


# --------------------------------------------------------------------------- #
# YCbCr TIFF
# --------------------------------------------------------------------------- #
LAYOUTS = [{"rows_per_strip": 8}, {"rows_per_strip": 5}, {}, {"tile": (16, 16)},
           {"tile": (32, 16)}]


@pytest.mark.parametrize("compression", ["none", "lzw", "deflate", "packbits"])
@pytest.mark.parametrize("subsampling", SUBSAMPLINGS, ids=[f"{h}{v}" for h, v in SUBSAMPLINGS])
def test_packed_ycbcr(subsampling, compression):
    """Packed YCbCr at each subsampling tif_getimage.c puts, in strips (of
    8 rows, of 5, one strip) and tiles, at widths and heights no block
    divides, with Predictor 2 where the codec takes one (libtiff undoes it
    over its rows of packed bytes, or reports an error and leaves them).
    The edge blocks, libtiff's reads of whole rows of blocks (short of a 4,
    4 strip's last bytes where its scanline size rounds down) and the 4, 4
    put's skip over a clipped tile (10 bytes a block) as cv2 gives them.
    cv2 refuses uncompressed tiles whose size is not whole KiB."""
    outcomes = []
    for k, (h, w) in enumerate([(37, 53), (5, 6), (1, 1), (18, 35)]):
        img = walk(h, w, 3, k)
        for layout in LAYOUTS:
            for predictor in ((1, 2) if compression in ("lzw", "deflate") else (1,)):
                data = encode_tiff(img, photometric=6, subsampling=subsampling,
                                   compression=compression, predictor=predictor, **layout)
                outcomes.append(assert_as_cv2(data))
    assert outcomes.count("same") >= len(outcomes) // 2
    assert set(outcomes) <= {"same", "both refuse"}


def test_ycbcr_writer_near_the_samples():
    """The packed blocks decode to the written samples' colours, within the
    chroma's subsampling."""
    rgb = np.repeat(np.repeat(walk(12, 16, 3, 6), 4, 0), 4, 1)  # flat over 4 x 4 blocks
    f = rgb.astype(np.float64)
    ycc = np.stack([0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2],
                    -0.168736 * f[..., 0] - 0.331264 * f[..., 1] + 0.5 * f[..., 2] + 128,
                    0.5 * f[..., 0] - 0.418688 * f[..., 1] - 0.081312 * f[..., 2] + 128], -1)
    ycc = np.clip(np.round(ycc), 0, 255).astype(np.uint8)
    for subsampling in SUBSAMPLINGS:
        got = read_port(encode_tiff(ycc, photometric=6, subsampling=subsampling))
        assert np.abs(got[..., ::-1].astype(int) - rgb).max() <= 2, subsampling


def test_ycbcr_every_value():
    """All 2^24 (Y, Cb, Cr) through libtiff's default tables, and through
    those of Rec. 709 coefficients and Rec. 601 ranges: one 4096 x 4096
    image of 1, 1 each."""
    every = np.stack(np.meshgrid(*[np.arange(256, dtype=np.uint8)] * 3, indexing="ij"), -1)
    every = every.reshape(4096, 4096, 3)
    for tags in ({}, {529: COEF_709, 532: REF_BW_JPEG}):
        data = encode_tiff(every, photometric=6, subsampling=(1, 1), rows_per_strip=256, tags=tags)
        assert assert_as_cv2(data) == "same"


TABLE_CASES = {
    "rec601_ranges": ({532: REF_BW_JPEG}, "same"),
    "fractions": ({532: (5, [(15, 2), (471, 2), (257, 2), (481, 2), (255, 2), (479, 2)])}, "same"),
    "zero_ranges": ({532: (5, [(0, 1), (0, 1), (128, 1), (128, 1), (128, 1), (128, 1)])}, "same"),
    "inverted": ({532: (5, [(255, 1), (0, 1), (255, 1), (0, 1), (0, 1), (255, 1)])}, "same"),
    "srational": ({532: (10, [(-20, 1), (300, 1), (100, 3), (255, 1), (128, 1), (255, 1)])}, "same"),
    "as_long": ({532: (4, [0, 255, 128, 255, 128, 255])}, "same"),
    "as_double": ({532: (12, [16.5, 235.25, 128, 240, 128, 240])}, "same"),
    "count_5_ignored": ({532: (5, REF_BW_JPEG[1][:5])}, "same"),
    "out_of_int32": ({532: (5, [(4000000000, 1)] + REF_BW_JPEG[1][1:])}, "both refuse"),
    "rec709": ({529: COEF_709}, "same"),
    "srational_coefficients": ({529: (10, [(-3, 10), (5, 10), (1, 10)])}, "same"),
    "denominator_0": ({529: (5, [(2126, 0), (7152, 10000), (722, 10000)])}, "same"),
    "float_inf": ({529: (11, [float("inf"), 0.5, 0.1])}, "same"),
    "green_0": ({529: (5, [(2126, 10000), (0, 1), (722, 10000)])}, "both refuse"),
    "float_nan": ({529: (11, [0.3, float("nan"), 0.1])}, "both refuse"),
    "count_2_ignored": ({529: (5, [(1, 2), (1, 3)])}, "same"),
}


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_ycbcr_conversion_tables(case):
    """TIFFYCbCrToRGBInit's tables from ReferenceBlackWhite and
    YCbCrCoefficients of any numeric type, in float arithmetic as there;
    initYCbCrConversion refuses a green coefficient of 0, NaN, and
    ReferenceBlackWhite past int32's range; a tag of another count is
    ignored."""
    tags, want = TABLE_CASES[case]
    every = np.stack(np.meshgrid(*[np.arange(0, 256, 5, dtype=np.uint8)] * 3, indexing="ij"), -1)
    every = every.reshape(52 * 52, 52, 3)
    for subsampling in ((1, 1), (2, 2)):
        data = encode_tiff(every, photometric=6, subsampling=subsampling, rows_per_strip=64,
                           tags=tags)
        assert assert_as_cv2(data) == want


@pytest.mark.parametrize("orientation", range(1, 9))
def test_ycbcr_orientation(orientation):
    """libtiff's flips of each strip or tile (a horizontal flip mirrors a
    tile within its width), then OpenCV's transpose."""
    img = walk(37, 53, 3, orientation)
    for subsampling in ((2, 2), (4, 4), (4, 1), (1, 2)):
        for layout in ({"tile": (16, 16)}, {"rows_per_strip": 7}):
            data = encode_tiff(img, photometric=6, subsampling=subsampling, compression="lzw",
                               tags={274: (3, orientation)}, **layout)
            assert assert_as_cv2(data) == "same"


def plane_streams(img, rows=None, tile=None) -> list:
    """cv2's 1-component JPEG stream of each strip or tile of each plane."""
    out = []
    h, w = img.shape[:2]
    for c in range(3):
        plane = np.ascontiguousarray(img[..., c])
        if tile is None:
            out += [cv2.imencode(".jpg", plane[y:y + rows])[1].tobytes() for y in range(0, h, rows)]
            continue
        tw, tl = tile
        for y in range(0, h, tl):
            for x in range(0, w, tw):
                block = np.zeros((tl, tw), np.uint8)
                part = plane[y:y + tl, x:x + tw]
                block[:part.shape[0], :part.shape[1]] = part
                out.append(cv2.imencode(".jpg", block)[1].tobytes())
    return out


@pytest.mark.parametrize("case", ["raw_strips", "lzw_tiles", "deflate_strips_mm", "jpeg_strips",
                                  "jpeg_tiles_o6"])
def test_ycbcr_separate_planes(case):
    """putseparate8bitYCbCr11tile: Y, Cb and Cr in separate planes at
    subsampling 1, 1, uncompressed, LZW, Deflate or JPEG (each plane a
    1-component stream libtiff does not convert)."""
    for k, (h, w) in enumerate(ODD):
        img = walk(h, w, 3, k)
        tags = {530: (3, [1, 1])}
        if case == "jpeg_strips":
            data = encode_tiff(img, compression="jpeg", photometric=6, planar=2, rows_per_strip=16,
                               streams=plane_streams(img, rows=16), tags=tags)
        elif case == "jpeg_tiles_o6":
            data = encode_tiff(img, compression="jpeg", photometric=6, planar=2, tile=(32, 16),
                               streams=plane_streams(img, tile=(32, 16)), tags={**tags, 274: (3, 6)})
        else:
            compression = case.split("_")[0].replace("raw", "none")
            layout = {"tile": (16, 16)} if "tiles" in case else {"rows_per_strip": 8}
            data = encode_tiff(img, photometric=6, planar=2, compression=compression, tags=tags,
                               order=">" if case.endswith("_mm") else "<", **layout)
        assert assert_as_cv2(data) == "same"


def test_ycbcr_variants_refused_by_both():
    """What tif_getimage.c has no put for: other subsamplings (2, 4; 1, 4;
    3, 3; a 0), separate planes subsampled (the default 2, 2 too), 16 bits,
    other than 3 samples."""
    img = walk(37, 53, 3, 7)
    four = np.concatenate([img, img[..., :1]], -1)
    cases = [encode_tiff(img, photometric=6, rows_per_strip=8, tags={530: (3, list(ss))})
             for ss in ((2, 4), (1, 4), (3, 3), (0, 2), (2, 0))]
    cases += [encode_tiff(img, photometric=6, planar=2, compression="lzw", rows_per_strip=8,
                          tags=tags) for tags in ({530: (3, [2, 2])}, {}, {530: (3, [2, 1])})]
    cases += [encode_tiff(img.astype(np.uint16) * 257, bits=16, photometric=6, subsampling=(1, 1)),
              encode_tiff(four, photometric=6, tags={530: (3, [1, 1])}),
              encode_tiff(four, photometric=6, tags={530: (3, [1, 1]), 338: (3, [2])}),
              encode_tiff(img[..., :2], photometric=6, tags={530: (3, [1, 1])}),
              encode_tiff(img[..., 0], photometric=6, tags={530: (3, [1, 1])})]
    for data in cases:
        assert assert_as_cv2(data) == "both refuse"


def test_ycbcr_byte_counts_as_libtiff():
    """libtiff's sizes of packed YCbCr: one uncompressed strip chopped into
    strips of whole rows of blocks, byte counts missing or short estimated,
    RowsPerStrip past the image, the default subsampling 2, 2 where the tag
    is absent."""
    big, img = walk(300, 200, 3, 8), walk(37, 53, 3, 8)
    outcomes = []
    for subsampling in ((1, 1), (2, 2), (4, 4), (4, 2), (1, 2)):
        for tags in ({}, {279: None}, {279: (4, [10])}):
            outcomes.append(assert_as_cv2(encode_tiff(big, photometric=6, subsampling=subsampling,
                                                      tags=tags)))
        for rps in (100, 37, 36):
            outcomes.append(assert_as_cv2(encode_tiff(img, photometric=6, subsampling=subsampling,
                                                      rows_per_strip=rps)))
    outcomes.append(assert_as_cv2(encode_tiff(img, photometric=6, subsampling=(2, 2),
                                              rows_per_strip=8, tags={530: None})))
    assert outcomes.count("same") >= 25 and set(outcomes) <= {"same", "both refuse"}


# --------------------------------------------------------------------------- #
# Seeded corruptions, and the JAX package's reader
# --------------------------------------------------------------------------- #
def _header_range(data: bytes) -> tuple[int, int]:
    """A TIFF's IFD, or a JPEG's marker segments before its first scan."""
    if data[:2] == b"\xff\xd8":
        return 2, segments(data)[-1][2]
    e = "<" if data[:2] == b"II" else ">"
    (off,) = struct.unpack(e + "I", data[4:8])
    (n,) = struct.unpack(e + "H", data[off:off + 2])
    return off, off + 6 + 12 * n


def corruption_sources(seed: int) -> list:
    """PIL's CMYK JPEG (progressive), a YCCK JPEG with restarts, PIL's CMYK
    JPEG-TIFF, YCbCr 2, 2 LZW tiles with Predictor 2 and Orientation 6,
    YCbCr 4, 2 PackBits strips of Rec. 601 ranges, separate YCbCr Deflate."""
    rgb, c4 = walk(29, 41, 3, seed), walk(29, 41, 4, seed)
    return [
        pil_cmyk(rgb, quality=85, progressive=True),
        encode_cmyk(c4, 85, ((2, 2), (1, 1), (1, 1), (2, 2)), 2, restart=2),
        pil_cmyk(rgb, "TIFF", compression="jpeg"),
        encode_tiff(rgb, photometric=6, subsampling=(2, 2), compression="lzw", predictor=2,
                    tile=(16, 16), tags={274: (3, 6)}),
        encode_tiff(rgb, photometric=6, subsampling=(4, 2), compression="packbits",
                    rows_per_strip=8, tags={532: REF_BW_JPEG}, ifd_first=True),
        encode_tiff(rgb, photometric=6, planar=2, compression="deflate", rows_per_strip=8,
                    tags={530: (3, [1, 1])}, order=">"),
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_colour_seeded_corruptions_as_cv2(seed):
    """72 corruptions a seed, 216 in all, of 6 files: a cut anywhere, bytes
    changed or a bit flipped in the IFD or the JPEG headers, bytes changed
    after them.  Each is cv2's pixels or refused by both, but for at most 2
    a seed that raise naming a departure ROADMAP.md Queue 3 accepts."""
    rng = np.random.default_rng(seed)
    sources = corruption_sources(seed)
    outcomes = []
    for it in range(72):
        data = bytearray(sources[it % len(sources)])
        lo, hi = _header_range(bytes(data))
        kind = it // len(sources) % 4
        if kind == 0:
            data = data[: rng.integers(1, len(data))]
        elif kind == 1:
            for _ in range(rng.integers(1, 3)):
                data[rng.integers(lo, hi)] = rng.integers(0, 256)
        elif kind == 2:
            for _ in range(rng.integers(1, 4)):
                p = rng.integers(8, len(data))
                while lo <= p < hi:
                    p = rng.integers(8, len(data))
                data[p] = rng.integers(0, 256)
        else:
            data[rng.integers(lo, hi)] ^= 1 << int(rng.integers(0, 8))
        outcomes.append(assert_as_cv2(bytes(data)))
    assert outcomes.count("same") > 15 and outcomes.count("both refuse") > 15
    assert sum(o not in ("same", "both refuse") for o in outcomes) <= 2, outcomes


@pytest.mark.parametrize("kind", ["cmyk_jpeg", "ycbcr_tiff"])
def test_get_image_matches_jax_on_colour(kind, tmp_path, monkeypatch):
    """A typed dataset of PIL's CMYK JPEGs (one with EXIF orientation 6) or
    of packed YCbCr 2, 2 LZW TIFFs (one with Orientation 6), read by both
    packages' get_image."""
    rels = []
    exif = Image.Exif()
    exif[0x0112] = 6
    for k in range(3):
        rgb = walk(45 + k, 70, 3, k)
        ext = "jpg" if kind == "cmyk_jpeg" else "tif"
        for img_type in ("enhanced_topo_grey", "topo_grey"):
            rel = f"data/{img_type}/train/p{k}.{ext}"
            (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
            if kind == "cmyk_jpeg":
                data = pil_cmyk(rgb, quality=90, exif=exif.tobytes() if k == 2 else b"")
            else:
                data = encode_tiff(rgb, photometric=6, subsampling=(2, 2), compression="lzw",
                                   rows_per_strip=16, tags={274: (3, 6)} if k == 2 else {})
            (tmp_path / rel).write_bytes(data)
        rels.append(f"data/train/p{k}.{ext}")
    monkeypatch.chdir(tmp_path)
    for rel in rels:
        for types in (["enhanced_topo_grey"], ["topo_grey", "enhanced_topo_grey"]):
            got = tdataset.get_image(rel, types)
            want = jdataset.get_image(rel, types)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)
