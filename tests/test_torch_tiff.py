"""The port's TIFF reader against ``cv2.imdecode(..., cv2.IMREAD_COLOR)``.

``radnet_torch.data.image.decode_image`` on a TIFF (``data/tiff.py`` and
``csrc/tiff_decode.cpp``) must give cv2's BGR uint8 array, shape included,
with 0 differing pixels; where cv2 returns no image the port raises
``ValueError``.  The files are written by ``scripts/tiff_writer.py`` (and
some by PIL): both byte orders, classic TIFF and BigTIFF, strips and tiles
with edge tiles, compression none, LZW, Deflate (8, 32946) and PackBits,
Predictor 2 at 8 and 16 bits, grey at 1-16 bits (OpenCV refuses 2 and 4),
RGB at 8 and 16 bits in both planar configurations, palette at 1, 4 and 8
bits with 16-bit and "8-bit" colormaps, CMYK, associated, unassociated and
unspecified alpha, Orientation 1-8 on strips and on tiles of odd sizes, a
multi-page file, FillOrder 2, and the byte-count repairs libtiff makes.
The variants not read yet raise naming themselves; seeded corruptions hold
the port to cv2 file by file, but for the departures ROADMAP.md Queue 3
lists.  The port's ``get_image`` is held against the JAX package's on TIFF
panels.  The reference is cv2 5.0.0 with its libtiff 4.7.1
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
from radnet_torch.data import tiff as ttiff
from radnet_tpu.data import dataset as jdataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from tiff_writer import encode_tiff  # noqa: E402

torch.set_num_threads(1)

# The port's departures from cv2 that ROADMAP.md Queue 3 accepts: variants
# not read yet (a corrupt tag can make one).
DEPARTURE = "is not read yet"
ODD = [(37, 53), (53, 37), (1, 1), (17, 33)]


def cv2_decode(data: bytes):
    try:
        return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:  # validateInputImageSize raises where others give None
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


def samples(h, w, spp, bits, seed):
    rng = np.random.default_rng(seed)
    top = 1 << min(bits, 16)
    img = rng.integers(0, top, (h, w, spp))
    return img.astype(np.uint16 if bits == 16 else np.uint8)


def panel(h, w, seed):
    """Smooth grey content (compressible): a cumulative random walk."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.integers(0, 24, (h, w)), axis=1).astype(np.uint8)


# --------------------------------------------------------------------------- #
# The writer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("compression,predictor", [("none", 1), ("lzw", 1), ("lzw", 2),
                                                   ("deflate", 2), ("packbits", 1)])
@pytest.mark.parametrize("layout", [{"rows_per_strip": 5}, {"tile": (16, 32)}])
def test_writer_output_is_what_cv2_reads(compression, predictor, layout):
    """What scripts/tiff_writer.py writes, cv2 decodes to the samples written
    (tiles of 32 rows: cv2 refuses uncompressed tiles of other sizes)."""
    img = samples(37, 45, 3, 8, 0)
    if compression == "none" and "tile" in layout:
        layout = {"tile": (32, 32)}
    for order in "<>":
        for big in (False, True):
            for ifd_first in (False, True):
                data = encode_tiff(img, compression=compression, predictor=predictor, order=order,
                                   bigtiff=big, ifd_first=ifd_first, **layout)
                np.testing.assert_array_equal(cv2_decode(data), img[..., ::-1])
                # 32 columns: libtiff's put16bitbwtile misaligns an edge tile's rows
                g16 = samples(20, 32, 1, 16, 1)
                data = encode_tiff(g16, bits=16, compression=compression, order=order, bigtiff=big,
                                   predictor=predictor, **layout)
                np.testing.assert_array_equal(cv2_decode(data)[..., 0], g16[..., 0] >> 8)


# --------------------------------------------------------------------------- #
# The container and the codecs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("bigtiff", [False, True], ids=["classic", "bigtiff"])
@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
def test_byte_order_and_bigtiff(order, bigtiff):
    for k, (h, w) in enumerate(ODD):
        for bits, spp in ((8, 1), (16, 1), (8, 3), (16, 3)):
            img = samples(h, w, spp, bits, k)
            for ifd_first in (False, True):
                data = encode_tiff(img, bits=bits, order=order, bigtiff=bigtiff,
                                   ifd_first=ifd_first, compression="lzw", rows_per_strip=7,
                                   pages=[{"img": samples(5, 6, 1, 8, 9)}])
                assert assert_as_cv2(data) == "same"


CODECS = [("none", 1), ("lzw", 1), ("lzw", 2), ("deflate", 1), ("deflate", 2),
          ("deflate_32946", 1), ("deflate_32946", 2), ("packbits", 1)]


@pytest.mark.parametrize("compression,predictor", CODECS,
                         ids=[f"{c}-pred{p}" for c, p in CODECS])
@pytest.mark.parametrize("layout", [{"rows_per_strip": 7}, {"rows_per_strip": 1}, {},
                                   {"tile": (16, 16)}, {"tile": (32, 48)}, {"tile": (32, 32)}],
                         ids=["strips7", "strips1", "one_strip", "tiles16", "tiles32x48",
                              "tiles32"])
def test_compression_strips_and_tiles(layout, compression, predictor):
    """Every codec on strips (a short last strip) and tiles (edge tiles
    padded past the image), 8 and 16 bits; cv2 reads uncompressed tiles only
    when their size is a multiple of 1 KiB, and the port refuses the others."""
    for k, (h, w) in enumerate(ODD[:2] + [(70, 35)]):
        for bits, spp in ((8, 1), (8, 3), (16, 1), (16, 3)):
            img = samples(h, w, spp, bits, 10 * k + bits)
            data = encode_tiff(img, bits=bits, compression=compression, predictor=predictor,
                               order="<>"[k % 2], **layout)
            assert assert_as_cv2(data) in ("same", "both refuse")


@pytest.mark.parametrize("photometric", [0, 1], ids=["min_is_white", "min_is_black"])
@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_grey_depths(bits, photometric):
    """Grey as setupMap / makebwmap scale it (Photometric 0 inverted), 16 bits
    by the high byte; OpenCV refuses 2- and 4-bit grey."""
    for k, (h, w) in enumerate(ODD):
        img = samples(h, w, 1, bits, k)
        for layout in ({"rows_per_strip": 3}, {"tile": (16, 16)}):
            data = encode_tiff(img, bits=bits, photometric=photometric, compression="packbits",
                               **layout)
            assert assert_as_cv2(data) == ("both refuse" if bits in (2, 4) else "same")
    if bits == 16:
        img = np.arange(4096, dtype=np.uint16).reshape(64, 64) * 16 + 7
        got = timage.decode_image(encode_tiff(img, bits=16, photometric=photometric))
        want = (img >> 8) if photometric else 255 - (img >> 8)
        np.testing.assert_array_equal(got[..., 0], want)


@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("bits", [8, 16])
def test_rgb(bits, planar):
    """RGB contiguous and separate; 16 -> 8 bits as (v + 128) // 257."""
    for k, (h, w) in enumerate(ODD):
        img = samples(h, w, 3, bits, k)
        for layout in ({"rows_per_strip": 4}, {"tile": (16, 32)}):
            for compression in ("none", "lzw", "deflate"):
                data = encode_tiff(img, bits=bits, planar=planar, compression=compression, **layout)
                assert assert_as_cv2(data) in ("same", "both refuse")
        got = timage.decode_image(encode_tiff(img, bits=bits, planar=planar))
        want = img if bits == 8 else (img.astype(np.int64) + 128) // 257
        np.testing.assert_array_equal(got, want[..., ::-1])


@pytest.mark.parametrize("cmap_bits", [16, 8], ids=["cmap16", "cmap8"])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_palette(bits, cmap_bits):
    """Palette at 1, 4 and 8 bits (OpenCV refuses 2); a colormap with no entry
    above 255 is read as 8-bit (checkcmap), else by its high bytes."""
    rng = np.random.default_rng(bits)
    for k, (h, w) in enumerate(ODD):
        img = samples(h, w, 1, bits, k)
        cmap = rng.integers(0, 1 << cmap_bits, 3 * (1 << bits))
        for layout in ({"rows_per_strip": 5}, {"tile": (16, 16)}):
            data = encode_tiff(img, bits=bits, photometric=3, compression="lzw",
                               tags={320: (3, cmap)}, **layout)
            assert assert_as_cv2(data) == ("both refuse" if bits == 2 else "same")


@pytest.mark.parametrize("planar", [1, 2])
def test_cmyk(planar):
    """Photometric 5, InkSet 1: R = (255 - K) * (255 - C) // 255."""
    for k, (h, w) in enumerate(ODD):
        img = samples(h, w, 4, 8, k)
        for layout in ({"rows_per_strip": 6}, {"tile": (16, 16)}):
            assert assert_as_cv2(encode_tiff(img, photometric=5, planar=planar,
                                             compression="deflate", **layout)) == "same"
        got = timage.decode_image(encode_tiff(img, photometric=5, planar=planar)).astype(int)
        kk = 255 - img[..., 3].astype(int)
        np.testing.assert_array_equal(got[..., 2], kk * (255 - img[..., 0]) // 255)
    assert assert_as_cv2(encode_tiff(samples(9, 9, 4, 8, 0), photometric=5,
                                     tags={332: (3, 2)})) == "both refuse"


@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("extra", [None, 0, 1, 2], ids=["none", "unspecified", "associated",
                                                          "unassociated"])
def test_alpha(extra, bits, planar):
    """RGBA and grey + alpha: associated or unspecified alpha kept out of the
    colours, unassociated alpha premultiplied as (a * c + 127) // 255 (not
    for contiguous grey, putagreytile)."""
    tags = {} if extra is None else {338: (3, [extra])}
    for k, (h, w) in enumerate(ODD):
        for spp in (2, 4):
            img = samples(h, w, spp, bits, k)
            for layout in ({"rows_per_strip": 5}, {"tile": (16, 32)}):
                data = encode_tiff(img, bits=bits, planar=planar, compression="lzw", tags=tags,
                                   **layout)
                assert assert_as_cv2(data) == "same"
    if extra == 2 and bits == 8:
        img = samples(23, 19, 4, 8, 5)
        got = timage.decode_image(encode_tiff(img, planar=planar, tags=tags)).astype(int)
        a = img[..., 3].astype(int)
        np.testing.assert_array_equal(got[..., 2], (img[..., 0] * a + 127) // 255)


@pytest.mark.parametrize("layout", [{"rows_per_strip": 7}, {"tile": (16, 32)},
                                    {"tile": (32, 16)}], ids=["strips", "tiles16x32", "tiles32x16"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation(orientation, layout):
    """The Orientation tag: libtiff flips each strip or tile (a horizontal
    flip mirrors each tile within its width), OpenCV places them and
    transposes 5-8.  On strips the result is image.orient's."""
    for k, (h, w) in enumerate(ODD + [(70, 35)]):
        for bits, spp, ph in ((8, 3, 2), (16, 1, 1), (1, 1, 0), (8, 2, 1)):
            img = samples(h, w, spp, bits, k)
            data = encode_tiff(img, bits=bits, photometric=ph, compression="lzw",
                               tags={274: (3, orientation)}, **layout)
            assert assert_as_cv2(data) == "same"
        if "rows_per_strip" in layout:
            img = samples(h, w, 3, 8, k)
            got = timage.decode_image(encode_tiff(img, tags={274: (3, orientation)}, **layout))
            np.testing.assert_array_equal(got, timage.orient(img[..., ::-1], orientation))
    for bad in (0, 9):  # libtiff refuses the value and keeps 1
        assert assert_as_cv2(encode_tiff(samples(5, 7, 1, 8, 0), tags={274: (3, bad)})) == "same"


def test_multipage_reads_the_first_page():
    first, second = samples(20, 30, 3, 8, 0), samples(10, 12, 1, 8, 1)
    for big in (False, True):
        data = encode_tiff(first, bigtiff=big, pages=[{"img": second, "compression": "lzw"}])
        assert assert_as_cv2(data) == "same"
        np.testing.assert_array_equal(timage.decode_image(data), first[..., ::-1])


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "I;16", "1", "CMYK", "RGBA", "LA"])
def test_tiff_from_pil(mode):
    for k, (h, w) in enumerate(ODD):
        img = Image.fromarray(samples(h, w, 3, 8, k))
        img = img.convert("L").convert(mode) if mode == "I;16" else img.convert(mode)
        for compression in (None, "tiff_lzw", "tiff_adobe_deflate", "packbits"):
            out = io.BytesIO()
            img.save(out, "TIFF", compression=compression)
            assert assert_as_cv2(out.getvalue()) == "same"


def test_fill_order_and_unknown_compression():
    """FillOrder 2 reverses each byte's bits before decoding; a compression
    code libtiff does not know decodes to zeros there."""
    img = samples(21, 19, 1, 8, 0)
    for bits in (1, 8):
        for compression in ("none", "lzw", "packbits", "deflate"):
            data = encode_tiff(img % 2 if bits == 1 else img, bits=bits, compression=compression,
                               tags={266: (3, 2)})
            assert assert_as_cv2(data) == "same"
    for code in (0, 9, 10, 12345, 32908, 34712):
        data = encode_tiff(img, rows_per_strip=5, tags={259: (3, code)})
        assert assert_as_cv2(data) == "same"
        assert not timage.decode_image(data).any()
    for code in (6, 34887, 34925, 50000, 50001):  # not configured in OpenCV's libtiff
        assert assert_as_cv2(encode_tiff(img, tags={259: (3, code)})) == "both refuse"


def test_byte_count_repairs_as_libtiff():
    """libtiff's repairs: one uncompressed strip chopped into ~8 KiB strips
    when its RowsPerStrip is not past the image, a missing or bad count
    estimated, unequal uncompressed counts recomputed, short counts leaving
    zeros, uncompressed tiles read only at multiples of 1 KiB, the later
    planes of uncompressed separate strips read whatever their counts say."""
    g = panel(300, 100, 0)
    rgb = np.stack([g, g[::-1], g[:, ::-1]], -1)
    cases = [
        encode_tiff(g),
        encode_tiff(g, tags={278: (4, 1 << 24)}),
        encode_tiff(g, tags={278: (4, (1 << 24) + 1)}),
        encode_tiff(g, tags={278: None}),
        encode_tiff(g, tags={279: None}),
        encode_tiff(g, compression="lzw", tags={279: None}),
        encode_tiff(g, tags={279: (4, 100)}),
        encode_tiff(g, tags={279: (4, 0)}),
        encode_tiff(g, rows_per_strip=40, tags={279: (4, [4000, 4001] + [4000] * 6)}),
        encode_tiff(g, rows_per_strip=40, tags={279: (4, [4000, 100] + [4000] * 6)}),
        encode_tiff(g, rows_per_strip=40, compression="lzw", tags={279: (4, [0] * 8)}),
        encode_tiff(g[:64], tile=(32, 32), tags={325: (4, [1000] * 8)}),
        encode_tiff(g[:64], tile=(32, 32), tags={325: (4, [1030] * 8)}),
        encode_tiff(g[:64], tile=(16, 16)),
        encode_tiff(rgb, planar=2, rows_per_strip=50,
                    tags={279: (4, [5000] * 6 + [10] * 6 + [0] * 6)}),
        encode_tiff(rgb, planar=2, rows_per_strip=50, tags={279: (4, [10] * 18)}),
        encode_tiff(g, tags={273: (4, 10 ** 9)}),
        encode_tiff(g, rows_per_strip=7, tags={273: (4, [8] * 3)}),
    ]
    outcomes = [assert_as_cv2(data) for data in cases]
    assert outcomes.count("same") >= 10 and "both refuse" in outcomes


@pytest.mark.parametrize("variant,make", [
    ("JPEG-compressed", lambda: encode_tiff(samples(16, 16, 3, 8, 0), tags={259: (3, 7)})),
    ("old-style JPEG", lambda: encode_tiff(samples(16, 16, 3, 8, 0), tags={259: (3, 6)})),
    ("YCbCr", lambda: encode_tiff(samples(16, 16, 3, 8, 0), photometric=6)),
    ("CCITT Group 4 fax", lambda: encode_tiff(samples(16, 16, 1, 1, 0), bits=1,
                                               tags={259: (3, 4)})),
    ("CCITT Group 3 fax", lambda: encode_tiff(samples(16, 16, 1, 1, 0), bits=1,
                                               tags={259: (3, 3)})),
    ("CIELab", lambda: encode_tiff(samples(16, 16, 3, 8, 0), photometric=8)),
    ("LogLuv", lambda: encode_tiff(samples(16, 16, 3, 8, 0), photometric=32845)),
    ("signed samples", lambda: encode_tiff(samples(16, 16, 1, 8, 0), tags={339: (3, 2)})),
    ("floating-point samples", lambda: encode_tiff(samples(16, 16, 1, 16, 0).astype(np.float32),
                                                    bits=32)),
    ("Predictor 3", lambda: encode_tiff(samples(16, 16, 1, 8, 0), compression="lzw",
                                         tags={317: (3, 3)})),
    ("old-style (pre-TIFF 6.0, bit-reversed) LZW", lambda: _compat_lzw()),
])
def test_variants_not_read_raise_naming_them(variant, make):
    """CCITT, CIELab, LogLuv, signed and floating-point samples, old-style
    LZW: the port raises naming the variant, whether cv2 reads the file or
    (float samples, OJPEG) refuses it too.  JPEG and YCbCr are read now
    (tests/test_torch_tiff_jpeg.py, tests/test_torch_image_colour.py): their
    files here are held to cv2, which refuses raw samples marked Compression
    7 as the port does, and reads 3 samples a pixel marked YCbCr as packed
    blocks of the default subsampling 2, 2."""
    if variant in ("JPEG-compressed", "YCbCr"):
        assert assert_as_cv2(make()) == ("both refuse" if variant == "JPEG-compressed" else "same")
        return
    with pytest.raises(ValueError, match=variant.split(" (")[0]):
        timage.decode_image(make())


def _compat_lzw() -> bytes:
    """An LZW strip whose first bytes look like pre-5.0 LZW (0x00, odd)."""
    data = bytearray(encode_tiff(samples(16, 16, 1, 8, 0), compression="lzw"))
    data[8:10] = b"\x00\x01"
    return bytes(data)


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
    g = panel(29, 41, seed)
    rgb = np.stack([g, g[::-1], g[:, ::-1]], -1)
    rgba = np.concatenate([rgb, g[..., None]], -1)
    cmap = list(np.random.default_rng(seed).integers(0, 65536, 768))
    out = [
        encode_tiff(g, compression="lzw", predictor=2, rows_per_strip=8, ifd_first=True),
        encode_tiff(rgb, compression="deflate", tile=(16, 16), ifd_first=True, tags={274: (3, 6)}),
        encode_tiff(g, compression="packbits", rows_per_strip=10, order=">", ifd_first=True),
        encode_tiff(rgb, ifd_first=True, bigtiff=True, tags={274: (3, 3)}),
        encode_tiff(rgb, compression="lzw", planar=2, rows_per_strip=16, ifd_first=True),
        encode_tiff(g.astype(np.uint16) * 257, bits=16, compression="deflate", predictor=2,
                    order=">", tile=(32, 16), ifd_first=True),
        encode_tiff(rgba, tile=(32, 32), tags={338: (3, [2])}, ifd_first=True),
        encode_tiff(g, photometric=3, compression="lzw", tags={320: (3, cmap)}, rows_per_strip=3),
        encode_tiff(rgba, photometric=5, compression="packbits", planar=2, tile=(16, 16),
                    ifd_first=True),
        encode_tiff(g > 100, bits=1, photometric=0, compression="packbits", rows_per_strip=5,
                    ifd_first=True),
        encode_tiff(rgb, planar=2, ifd_first=True),
        encode_tiff(rgb, compression="lzw", rows_per_strip=4),
    ]
    for mode, compression in (("RGB", "tiff_lzw"), ("L", None), ("P", "packbits"),
                              ("RGBA", "tiff_adobe_deflate")):
        buf = io.BytesIO()
        Image.fromarray(rgb).convert(mode).save(buf, "TIFF", compression=compression)
        out.append(buf.getvalue())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiff_seeded_corruptions_as_cv2(seed):
    """80 corruptions a seed, 240 in all, of 16 files (strips and tiles, every
    codec, planar 2, BigTIFF, palette, CMYK, 1-bit, PIL's): a cut anywhere,
    bytes changed or a bit flipped in the IFD, bytes changed in the strip or
    tile data.  Each is cv2's pixels or refused by both."""
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


def test_corrupt_deflate_stops_where_zlib_does():
    """A corrupt Deflate strip: libtiff keeps what zlib wrote before its
    error and skips the predictor; the zlib module drops it, so the port
    finds it symbol by symbol (distance too far back, bad codes, a bad
    check value), bit-equal to cv2."""
    rng = np.random.default_rng(3)
    g = panel(40, 64, 3)
    for predictor in (1, 2):
        base = bytearray(encode_tiff(g, compression="deflate", predictor=predictor,
                                     rows_per_strip=20, ifd_first=True))
        first = ttiff._Dir(bytes(base)).offsets[0]
        seen = set()
        for _ in range(40):
            data = bytearray(base)
            p = rng.integers(first, len(data))
            data[p] = rng.integers(0, 256)
            seen.add(assert_as_cv2(bytes(data)))
        assert seen == {"same"}


def test_size_limits_as_cv2():
    data = encode_tiff(np.zeros((1, 1), np.uint8), tags={256: (4, 32769), 257: (4, 32768)})
    with pytest.raises(cv2.error):
        cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    with pytest.raises(ValueError, match="size limits"):
        timage.decode_image(data)


@pytest.mark.parametrize("layout", [{"rows_per_strip": 8}, {"tile": (16, 16)}],
                         ids=["strips", "tiles"])
def test_get_image_matches_jax_on_tiff(layout, tmp_path, monkeypatch):
    """A typed dataset of TIFF panels (grey LZW + Predictor 2, colour Deflate,
    one with Orientation 6) read by both packages' get_image."""
    rels = []
    for k in range(3):
        for img_type in ("enhanced_topo_grey", "topo_grey"):
            rel = f"data/{img_type}/train/p{k}.tif"
            (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
            g = panel(45 + k, 70, k)
            img = g if k == 0 else np.stack([g, g[::-1], g[:, ::-1]], -1)
            tags = {274: (3, 6)} if k == 2 else {}
            (tmp_path / rel).write_bytes(encode_tiff(
                img, compression="lzw" if k == 0 else "deflate", predictor=2, tags=tags, **layout))
        rels.append(f"data/train/p{k}.tif")
    monkeypatch.chdir(tmp_path)
    for rel in rels:
        for types in (["enhanced_topo_grey"], ["topo_grey", "enhanced_topo_grey"]):
            got = tdataset.get_image(rel, types)
            want = jdataset.get_image(rel, types)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)
