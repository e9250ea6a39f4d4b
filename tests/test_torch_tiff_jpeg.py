"""JPEG-compressed TIFFs: the port's reader against ``cv2.imdecode(...,
cv2.IMREAD_COLOR)``.

``radnet_torch.data.image.decode_image`` on a TIFF of Compression 7
(``data/tiff.py``'s ``_JpegCodec`` over ``data/jpeg.py`` and
``csrc/jpeg_decode.cpp``) must give cv2's BGR uint8 array, shape included,
with 0 differing pixels, or both refuse.  The files are cv2's and PIL's own
JPEG TIFFs, and streams cv2 or ``scripts/jpeg_writer.py`` encodes, wrapped by
``scripts/tiff_writer.py``: strips and tiles at odd sizes, tables in
``JPEGTables``, in each stream or both, grey (Photometric 0 and 1), RGB
(no colour conversion) and YCbCr at 4:4:4, 4:2:2, 4:2:0, 4:1:1 and 4:4:0,
progressive and restart-interval streams, Orientation 1-8 on tiles, BigTIFF
in both byte orders, libtiff's checks of each stream (size, component count,
precision, sampling, tables), cut streams, and seeded corruptions.  The
variants not read yet raise naming themselves; the departures the seeded
corruptions may show are those ``ROADMAP.md`` Queue 3 lists.  The port's
``get_image`` is held against the JAX package's on JPEG-TIFF panels.  The
reference is cv2 5.0.0 with its libtiff 4.7.1 and libjpeg-turbo 3.1.2
(``test_reference_versions`` in ``test_torch_image_decode.py``).
"""

import io
import os
import struct
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from radnet_torch.data import dataset as tdataset
from radnet_torch.data import image as timage
from radnet_torch.data.jpeg import decode_jpeg
from radnet_tpu.data import dataset as jdataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from jpeg_writer import encode_jpeg, encode_tiles, join_tables, split_tables  # noqa: E402
from tiff_writer import encode_tiff  # noqa: E402

torch.set_num_threads(1)

# The port's departures from cv2 that ROADMAP.md Queue 3 accepts: variants
# not read yet (a corrupt tag or stream can make one).
DEPARTURE = "is not read yet"
ODD = [(37, 53), (53, 37), (1, 1), (17, 33)]
SF = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
FACTORS = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "411": (4, 1), "440": (1, 2)}


def cv2_decode(data: bytes):
    try:
        return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        return None


def assert_as_cv2(data: bytes) -> str:
    """The port's decode is cv2's, or both refuse.  Returns "same", "both
    refuse" or the departure's message."""
    want = cv2_decode(data)
    try:
        got = timage.decode_image(data)
    except ValueError as e:
        if want is not None and DEPARTURE in str(e):
            return str(e)
        assert want is None, f"the port raised {e!r}, cv2 read {want.shape}"
        return "both refuse"
    assert want is not None, f"cv2 refuses the file, the port read {got.shape}"
    assert got.shape == want.shape and got.dtype == np.uint8, (got.shape, want.shape)
    assert (got != want).sum() == 0, f"{(got != want).any(-1).sum()} pixels differ"
    return "same"


def panel(h, w, seed):
    """Smooth grey content: a cumulative random walk."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.integers(0, 24, (h, w)), axis=1).astype(np.uint8)


def colour(h, w, seed):
    """BGR content of three different walks."""
    g = panel(h, w, seed)
    return np.stack([g, g[::-1], g[:, ::-1]], -1)


def cv2_jpeg(img, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def strip_streams(img, rps, *params) -> list:
    return [cv2_jpeg(img[y:y + rps], *params) for y in range(0, img.shape[0], rps)]


def tile_streams(img, tw, tl, *params) -> list:
    """cv2's streams of each tile (edge tiles padded with zeros), in TIFF order."""
    out = []
    for y in range(0, img.shape[0], tl):
        for x in range(0, img.shape[1], tw):
            block = np.zeros((tl, tw) + img.shape[2:], np.uint8)
            part = img[y:y + tl, x:x + tw]
            block[:part.shape[0], :part.shape[1]] = part
            out.append(cv2_jpeg(block, *params))
    return out


def with_tables(streams: list, where: str) -> tuple[list, bytes | None]:
    """Streams with their tables in each ("own"), moved to a JPEGTables
    stream ("tables"), or in both ("both")."""
    if where == "own":
        return streams, None
    tables = split_tables(streams[0])[0]
    return (streams if where == "both" else [split_tables(s)[1] for s in streams]), tables


def ycbcr_tiff(bgr, streams, **kw) -> bytes:
    return encode_tiff(bgr[..., ::-1], compression="jpeg", photometric=6, streams=streams, **kw)


def grey_tiff(g, streams, photometric=1, **kw) -> bytes:
    return encode_tiff(g, compression="jpeg", photometric=photometric, streams=streams, **kw)


# --------------------------------------------------------------------------- #
# The writers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("rows", [8, 16, 0], ids=["rps8", "rps16", "whole"])
def test_cv2_writer(rows):
    """cv2's own JPEG TIFF writer: Photometric 2 (RGB, no colour conversion)
    and grey, JPEGTables, strips of 8 and 16 rows and the whole image."""
    for k, (h, w) in enumerate(ODD):
        for img in (colour(h, w, k), panel(h, w, k)):
            params = [cv2.IMWRITE_TIFF_COMPRESSION, 7]
            if rows:
                params += [cv2.IMWRITE_TIFF_ROWSPERSTRIP, rows]
            ok, buf = cv2.imencode(".tiff", img, params)
            assert ok
            assert assert_as_cv2(buf.tobytes()) == "same"


@pytest.mark.parametrize("mode", ["RGB", "L", "YCbCr"])
def test_pil_writer(mode):
    for k, (h, w) in enumerate(ODD):
        buf = io.BytesIO()
        Image.fromarray(colour(h, w, k)[..., ::-1].copy()).convert(mode).save(
            buf, "TIFF", compression="jpeg")
        assert assert_as_cv2(buf.getvalue()) == "same"


def test_numpy_jpeg_writer_read_as_cv2_reads_it():
    """scripts/jpeg_writer.py (the card's host has no cv2 to encode with):
    cv2 and the port read its whole streams and its tiles joined to their
    tables alike, and near the samples written."""
    g = panel(61, 83, 0)
    rgb = colour(61, 83, 1)[..., ::-1]
    for img, sampling in ((g, (1, 1)), (rgb, (1, 1)), (rgb, (2, 2)), (rgb, (2, 1))):
        data = encode_jpeg(img, 95, sampling)
        assert assert_as_cv2(data) == "same"
        # As near the samples as cv2's own encoder at that quality and sampling.
        name = {v: k for k, v in FACTORS.items()}[sampling]
        ref = cv2_decode(cv2_jpeg(img[..., ::-1] if img.ndim == 3 else img,
                                  cv2.IMWRITE_JPEG_QUALITY, 95, SF, SAMPLING[name]))
        got = timage.decode_image(data)
        err = [np.abs((a[..., ::-1] if img.ndim == 3 else a[..., 0]).astype(int) - img).mean()
               for a in (got, ref)]
        assert err[0] <= 1.05 * err[1] + 0.5, err
        tables, streams = encode_tiles(img, (32, 16), 90, sampling)
        for stream in streams:
            assert assert_as_cv2(join_tables(tables, stream)) == "same"
        photometric = 1 if img.ndim == 2 else 6
        data = encode_tiff(img, compression="jpeg", photometric=photometric, tile=(32, 16),
                           streams=streams, jpeg_tables=tables,
                           tags={530: (3, list(sampling))} if img.ndim == 3 else {})
        assert assert_as_cv2(data) == "same"


# --------------------------------------------------------------------------- #
# YCbCr, RGB and grey
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("tables", ["own", "tables", "both"])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "411", "440"])
def test_ycbcr_strips(sampling, tables):
    """Photometric 6 in strips of 16 rows (the last short), with its
    YCbCrSubsampling tag, and without it (libtiff takes the first stream's)."""
    bgr = colour(37, 53, 0)
    streams, jt = with_tables(strip_streams(bgr, 16, SF, SAMPLING[sampling]), tables)
    for tags in ({530: (3, list(FACTORS[sampling]))}, {}):
        data = ycbcr_tiff(bgr, streams, rows_per_strip=16, jpeg_tables=jt, tags=tags)
        assert assert_as_cv2(data) == "same"


@pytest.mark.parametrize("sampling", ["444", "422", "420"])
def test_ycbcr_tiles_at_odd_sizes(sampling):
    for k, (h, w) in enumerate(ODD):
        bgr = colour(h, w, k)
        for tables in ("own", "tables", "both"):
            streams, jt = with_tables(tile_streams(bgr, 16, 32, SF, SAMPLING[sampling]), tables)
            data = ycbcr_tiff(bgr, streams, tile=(16, 32), jpeg_tables=jt,
                              tags={530: (3, list(FACTORS[sampling]))})
            assert assert_as_cv2(data) == "same"


@pytest.mark.parametrize("sampling", ["420", "422", "444"])
def test_single_ycbcr_strip_is_decode_jpeg_of_its_stream(sampling):
    """A JFIF stream wrapped as the one strip of a Photometric 6 TIFF reads
    bit-equal to decode_jpeg of the stream itself."""
    bgr = colour(45, 61, 3)
    stream = cv2_jpeg(bgr, SF, SAMPLING[sampling])
    data = ycbcr_tiff(bgr, [stream], tags={530: (3, list(FACTORS[sampling]))})
    np.testing.assert_array_equal(timage.decode_image(data), decode_jpeg(stream)[0])
    assert assert_as_cv2(data) == "same"


def test_ycbcr_sampling_as_libtiff_checks_it():
    """Each stream's first component must be sampled as YCbCrSubsampling
    says (the default 2, 2 when the tag is absent, unless the first
    stream gives it), the others 1, 1; else both refuse.  Photometric 2
    takes no colour conversion, and refuses subsampled streams."""
    bgr = colour(37, 53, 1)
    s444, s420 = (strip_streams(bgr, 16, SF, SAMPLING[s]) for s in ("444", "420"))
    outcomes = [assert_as_cv2(ycbcr_tiff(bgr, s, rows_per_strip=16, tags=tags)) for s, tags in (
        (s444, {530: (3, [2, 2])}), (s420, {530: (3, [1, 1])}), (s420, {530: (3, [2, 1])}),
        (s420[:1] + s444[1:], {}), (s444[:1] + s420[1:], {}))]
    assert outcomes == ["both refuse"] * 5
    assert assert_as_cv2(ycbcr_tiff(bgr, s444, rows_per_strip=16)) == "same"  # first stream's 1, 1
    rgb = bgr[..., ::-1]
    data = encode_tiff(rgb, compression="jpeg", photometric=2, streams=s444, rows_per_strip=16)
    assert assert_as_cv2(data) == "same"
    assert not (timage.decode_image(data) == timage.decode_image(ycbcr_tiff(bgr, s444, rows_per_strip=16,
                                                                          tags={530: (3, [1, 1])}))).all()
    for s in (s420, strip_streams(bgr, 16, SF, SAMPLING["422"])):
        data = encode_tiff(rgb, compression="jpeg", photometric=2, streams=s, rows_per_strip=16)
        assert assert_as_cv2(data) == "both refuse"


@pytest.mark.parametrize("photometric", [0, 1], ids=["min_is_white", "min_is_black"])
def test_grey(photometric):
    for k, (h, w) in enumerate(ODD):
        g = panel(h, w, k)
        for layout, streams in (({"rows_per_strip": 8}, strip_streams(g, 8)),
                                ({"tile": (16, 32)}, tile_streams(g, 16, 32)), ({}, [cv2_jpeg(g)])):
            for tables in ("own", "tables"):
                s, jt = with_tables(streams, tables)
                data = grey_tiff(g, s, photometric, jpeg_tables=jt, **layout)
                assert assert_as_cv2(data) == "same"


@pytest.mark.parametrize("params", [(cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
                                    (cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_OPTIMIZE, 1),
                                    (cv2.IMWRITE_JPEG_RST_INTERVAL, 1),
                                    (cv2.IMWRITE_JPEG_RST_INTERVAL, 3, SF, SAMPLING["422"])],
                         ids=["progressive", "progressive_optimized", "restart_1", "restart_3_422"])
def test_progressive_and_restart_streams(params):
    bgr, g = colour(37, 53, 2), panel(37, 53, 2)
    sampling = (2, 1) if SAMPLING["422"] in params else (2, 2)
    data = ycbcr_tiff(bgr, strip_streams(bgr, 16, *params), rows_per_strip=16,
                      tags={530: (3, list(sampling))})
    assert assert_as_cv2(data) == "same"
    assert assert_as_cv2(grey_tiff(g, tile_streams(g, 16, 32, *params), tile=(16, 32))) == "same"


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_on_tiles(orientation):
    """libtiff's flips of each tile (a horizontal flip mirrors a tile within
    its width), then OpenCV's transpose, on YCbCr and grey tiles."""
    for k, (h, w) in enumerate(ODD):
        bgr, g = colour(h, w, k), panel(h, w, k)
        tags = {274: (3, orientation)}
        assert assert_as_cv2(ycbcr_tiff(bgr, tile_streams(bgr, 16, 32), tile=(16, 32),
                                        tags=tags)) == "same"
        assert assert_as_cv2(grey_tiff(g, tile_streams(g, 16, 32), tile=(16, 32),
                                       tags=tags)) == "same"


@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
def test_bigtiff(order):
    bgr, g = colour(37, 53, 4), panel(37, 53, 4)
    streams, jt = with_tables(tile_streams(bgr, 16, 32), "tables")
    for ifd_first in (False, True):
        assert assert_as_cv2(ycbcr_tiff(bgr, streams, tile=(16, 32), jpeg_tables=jt, order=order,
                                        bigtiff=True, ifd_first=ifd_first)) == "same"
        assert assert_as_cv2(grey_tiff(g, strip_streams(g, 8), rows_per_strip=8, order=order,
                                       bigtiff=True, ifd_first=ifd_first)) == "same"


def test_separate_planes_and_palette():
    """RGB in separate planes (a grey stream a plane) and a palette image's
    indices are read; both as cv2."""
    bgr = colour(37, 53, 5)
    planes = [s for c in (2, 1, 0) for s in strip_streams(np.ascontiguousarray(bgr[..., c]), 16)]
    data = encode_tiff(bgr[..., ::-1], compression="jpeg", photometric=2, planar=2,
                       streams=planes, rows_per_strip=16)
    assert assert_as_cv2(data) == "same"
    cmap = list(np.random.default_rng(5).integers(0, 65536, 768))
    g = panel(37, 53, 5)
    data = encode_tiff(g, compression="jpeg", photometric=3, streams=strip_streams(g, 16),
                       rows_per_strip=16, tags={320: (3, cmap)})
    assert assert_as_cv2(data) == "same"


# --------------------------------------------------------------------------- #
# libtiff's checks, cut streams, variants not read yet
# --------------------------------------------------------------------------- #
def test_stream_checks_as_libtiff():
    """A stream taller than its strip is read only as the last strip; a tile
    stream larger than its tile is refused, a smaller one leaves zeros; the
    component count must be SamplesPerPixel, the precision 8 bits; quant
    tables must come from somewhere; JPEGTables must hold tables only;
    FillOrder does not reverse JPEG data; a stream's tables serve the later
    strips."""
    g, bgr = panel(37, 53, 6), colour(37, 53, 6)
    strips = strip_streams(g, 16)
    tiles = tile_streams(g, 16, 32)
    n = len(tiles)
    tall_last = strip_streams(np.vstack([g, g[:11]]), 16)
    bare = [split_tables(s)[1] for s in strips]
    cases = {
        "tall last strip": (grey_tiff(g, tall_last, rows_per_strip=16), "same"),
        "tall middle strips": (grey_tiff(g[:21], [cv2_jpeg(g[y:y + 16]) for y in (0, 8, 16)],
                                         rows_per_strip=8), "both refuse"),
        "narrow strips": (grey_tiff(g, strip_streams(g[:, :40], 16), rows_per_strip=16), "same"),
        "short strips": (grey_tiff(g, strip_streams(g, 8)[:3], rows_per_strip=16), "same"),
        "tall tiles": (grey_tiff(g, [cv2_jpeg(np.full((40, 16), k, np.uint8)) for k in range(n)],
                                 tile=(16, 32)), "both refuse"),
        "small tiles": (grey_tiff(g, [cv2_jpeg(np.full((24, 16), 20 * k, np.uint8))
                                      for k in range(n)], tile=(16, 32)), "same"),
        "colour streams, grey tags": (grey_tiff(g, strip_streams(bgr, 16), rows_per_strip=16),
                                      "both refuse"),
        "12 bits": (grey_tiff(g, strips, rows_per_strip=16, tags={258: (3, 12)}), "both refuse"),
        "16 bits": (grey_tiff(g, strips, rows_per_strip=16, tags={258: (3, 16)}), "both refuse"),
        "no quant tables": (grey_tiff(g, bare, rows_per_strip=16), "both refuse"),
        "empty JPEGTables": (grey_tiff(g, strips, rows_per_strip=16,
                                       jpeg_tables=b"\xff\xd8\xff\xd9"), "same"),
        "a whole stream as JPEGTables": (grey_tiff(g, strips, rows_per_strip=16,
                                                   jpeg_tables=strips[0]), "both refuse"),
        "FillOrder 2": (grey_tiff(g, strips, rows_per_strip=16, tags={266: (3, 2)}), "same"),
        "tables in strip 0 only": (grey_tiff(g, strips[:1] + bare[1:], rows_per_strip=16), "same"),
        "JPEGTables as SBYTE": (grey_tiff(g, bare, rows_per_strip=16,
                                          tags={347: (6, np.frombuffer(split_tables(strips[0])[0], np.int8))}),
                                "both refuse"),
    }
    got = {name: assert_as_cv2(data) for name, (data, _) in cases.items()}
    assert got == {name: want for name, (_, want) in cases.items()}


@pytest.mark.parametrize("where", ["stream", "bare_stream", "tables"])
def test_cut_streams_as_cv2(where):
    """A strip's stream, or JPEGTables, cut short: libtiff's source feeds a
    fake EOI marker past the end, so libjpeg reads on with zero bits where
    the header is whole; where it is not, both refuse."""
    g = panel(37, 53, 7)
    strips = strip_streams(g, 16)
    tables, bare = split_tables(strips[0])[0], [split_tables(s)[1] for s in strips]
    outcomes = []
    size = len(tables) if where == "tables" else len(strips[1])
    for cut in sorted({1, 2, 3, 5, 20, 100, 150, 200, 250, 300, 350, 400, 450, size - 2, size - 1}):
        if where == "stream":
            data = grey_tiff(g, [strips[0], strips[1][:cut], strips[2]], rows_per_strip=16)
        elif where == "bare_stream":
            data = grey_tiff(g, [bare[0], bare[1][:cut], bare[2]], rows_per_strip=16,
                             jpeg_tables=tables)
        else:
            data = grey_tiff(g, bare, rows_per_strip=16, jpeg_tables=tables[:cut])
        outcomes.append(assert_as_cv2(data))
    assert "same" in outcomes and "both refuse" in outcomes


def test_variants_not_read_raise_naming_them():
    """JPEG of 4 samples (PIL's CMYK), YCbCr JPEG in separate planes of
    subsampling 1, 1 and uncompressed YCbCr are read now
    (tests/test_torch_image_colour.py): each as cv2 reads it.  A CIELab
    JPEG-TIFF, which cv2 reads, raises naming CIELab."""
    rgb = colour(37, 53, 8)[..., ::-1].copy()
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(buf, "TIFF", compression="jpeg")
    planes = [s for c in range(3) for s in strip_streams(np.ascontiguousarray(rgb[..., c]), 16)]
    separate = encode_tiff(rgb, compression="jpeg", photometric=6, planar=2, streams=planes,
                           rows_per_strip=16, tags={530: (3, [1, 1])})
    for data in (buf.getvalue(), separate, encode_tiff(rgb, photometric=6)):
        assert assert_as_cv2(data) == "same"
    lab = encode_tiff(rgb, compression="jpeg", photometric=8,
                      streams=strip_streams(rgb, 16, SF, SAMPLING["444"]),
                      rows_per_strip=16)
    assert cv2_decode(lab) is not None
    with pytest.raises(ValueError, match="CIELab"):
        timage.decode_image(lab)
    # Separate YCbCr planes that libtiff's own conversion does not read: refused by both.
    assert assert_as_cv2(encode_tiff(rgb, compression="jpeg", photometric=6, planar=2,
                                     streams=planes, rows_per_strip=16)) == "both refuse"


def _ifd_range(data: bytes):
    e = "<" if data[:2] == b"II" else ">"
    if data[2:4] in (b"+\0", b"\0+"):
        (off,) = struct.unpack(e + "Q", data[8:16])
        (n,) = struct.unpack(e + "Q", data[off:off + 8])
        return off, off + 16 + 20 * n
    (off,) = struct.unpack(e + "I", data[4:8])
    (n,) = struct.unpack(e + "H", data[off:off + 2])
    return off, off + 6 + 12 * n


def corruption_sources(seed: int) -> list:
    """JPEG-TIFFs only: YCbCr tiles with JPEGTables and Orientation 6, cv2's
    RGB strips, grey strips (MM), progressive MinIsWhite strips (BigTIFF),
    4:2:2 restart-interval strips, PIL's YCbCr."""
    g, bgr = panel(29, 41, seed), colour(29, 41, seed)
    tiles, tables = with_tables(tile_streams(bgr, 16, 16), "tables")
    buf = io.BytesIO()
    Image.fromarray(bgr[..., ::-1].copy()).save(buf, "TIFF", compression="jpeg")
    return [
        ycbcr_tiff(bgr, tiles, tile=(16, 16), jpeg_tables=tables, tags={274: (3, 6)},
                   ifd_first=True),
        cv2.imencode(".tiff", bgr, [cv2.IMWRITE_TIFF_COMPRESSION, 7,
                                    cv2.IMWRITE_TIFF_ROWSPERSTRIP, 8])[1].tobytes(),
        grey_tiff(g, strip_streams(g, 8), rows_per_strip=8, ifd_first=True, order=">"),
        grey_tiff(g, strip_streams(g, 16, cv2.IMWRITE_JPEG_PROGRESSIVE, 1), 0, rows_per_strip=16,
                  bigtiff=True),
        ycbcr_tiff(bgr, strip_streams(bgr, 16, cv2.IMWRITE_JPEG_RST_INTERVAL, 1, SF,
                                      SAMPLING["422"]), rows_per_strip=16,
                   tags={530: (3, [2, 1])}, ifd_first=True),
        buf.getvalue(),
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jpeg_tiff_seeded_corruptions_as_cv2(seed):
    """80 corruptions a seed, 240 in all, of 6 JPEG-TIFFs: a cut anywhere,
    bytes changed or a bit flipped in the IFD, bytes changed in the streams
    or tables.  Each is cv2's pixels or refused by both, but for at most 2
    a seed that raise naming a variant not read yet (ROADMAP.md Queue 3)."""
    rng = np.random.default_rng(seed)
    sources = corruption_sources(seed)
    outcomes = []
    for it in range(80):
        data = bytearray(sources[it % len(sources)])
        lo, hi = _ifd_range(bytes(data))
        kind = it % 4
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
    assert outcomes.count("same") > 20 and outcomes.count("both refuse") > 20
    assert sum(o not in ("same", "both refuse") for o in outcomes) <= 2, outcomes


@pytest.mark.parametrize("layout", [{"rows_per_strip": 16}, {"tile": (16, 32)}],
                         ids=["strips", "tiles"])
def test_get_image_matches_jax_on_jpeg_tiff(layout, tmp_path, monkeypatch):
    """A typed dataset of JPEG-TIFF panels (grey, YCbCr 4:2:0 with
    JPEGTables, one with Orientation 6) read by both packages' get_image."""
    rels = []
    for k in range(3):
        for img_type in ("enhanced_topo_grey", "topo_grey"):
            rel = f"data/{img_type}/train/p{k}.tif"
            (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
            h, w = 45 + k, 70
            tags = {274: (3, 6)} if k == 2 else {}
            if k == 0:
                g = panel(h, w, k)
                streams = (strip_streams(g, 16) if "rows_per_strip" in layout
                           else tile_streams(g, 16, 32))
                data = grey_tiff(g, streams, tags=tags, **layout)
            else:
                bgr = colour(h, w, k)
                streams = (strip_streams(bgr, 16) if "rows_per_strip" in layout
                           else tile_streams(bgr, 16, 32))
                streams, jt = with_tables(streams, "tables")
                data = ycbcr_tiff(bgr, streams, jpeg_tables=jt, tags=tags, **layout)
            (tmp_path / rel).write_bytes(data)
        rels.append(f"data/train/p{k}.tif")
    monkeypatch.chdir(tmp_path)
    for rel in rels:
        for types in (["enhanced_topo_grey"], ["topo_grey", "enhanced_topo_grey"]):
            got = tdataset.get_image(rel, types)
            want = jdataset.get_image(rel, types)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)
