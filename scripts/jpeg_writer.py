"""A baseline JPEG encoder for test tooling: numpy and the standard library only.

The card's host has neither OpenCV nor PIL, so ``chip_smoke.py`` writes its
JPEG-compressed TIFF panel with this file (and ``scripts/tiff_writer.py``),
and ``scripts/make_image_fixtures.py`` writes one fixture with it.

:func:`encode_jpeg` writes one sequential Huffman-coded 8-bit stream of 1
component (grey) or 3 (YCbCr converted from RGB as JFIF does), the first
component sampled ``(h, v)`` times the others, with the quantization tables of JPEG Annex K scaled to a quality
as libjpeg scales them and the Huffman tables of Annex K.3.  With
``tables=False`` the stream is abbreviated (no DQT or DHT): a TIFF's
``JPEGTables`` stream (:func:`tables_stream`) then holds them.
:func:`encode_tiles` cuts an image into a TIFF's tiles and encodes each so.
:func:`split_tables` moves the tables of any stream (cv2's, say) before its
frame into a tables-only stream.  The coefficients are rounded from a float
DCT; nothing here tries to match another encoder's bytes.  The bits of a
stream are packed by numpy, one stream at a time, so a 4400 x 3000 panel is
written in seconds.
"""

from __future__ import annotations

import struct

import numpy as np

# JPEG Annex K.1: the luminance and chrominance tables at quality 50, natural order.
_QUANT = [np.array(t, np.int64).reshape(8, 8) for t in (
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69,
     56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81,
     104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99, 99,
     99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)]
# Annex K.3: (code counts by length 1-16, symbols) of DC 0, AC 0, DC 1, AC 1.
_DC_VALS = list(range(12))
_HUFF = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], _DC_VALS),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], _DC_VALS),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718"
        "191a25262728292a3435363738393a434445464748494a535455565758595a636465666768696a737475"
        "767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e1"
        "25f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a73"
        "7475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9"
        "bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}
_ZIGZAG = np.array([  # zigzag index -> natural index
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_DCT = np.array([[(np.sqrt(0.125) if u == 0 else 0.5) * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def quant_tables(quality: int) -> list[np.ndarray]:
    """Annex K's tables scaled as libjpeg's jpeg_quality_scaling, 1-255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [np.clip((t * scale + 50) // 100, 1, 255) for t in _QUANT]


def _codes(kind: int, table: int) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) by symbol of an Annex K.3 table, canonical as JPEG's."""
    counts, vals = _HUFF[(kind, table)]
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            code_of[vals[k]], len_of[vals[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_CODES = {key: _codes(*key) for key in _HUFF}


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _table_segments(ntables: int, quality: int) -> bytes:
    """DQT and DHT of tables 0 (luminance) to ``ntables - 1`` (chrominance)."""
    q = quant_tables(quality)[:ntables]
    dqt = b"".join(bytes([t]) + bytes(q[t].reshape(-1)[_ZIGZAG].astype(np.uint8))
                   for t in range(len(q)))
    dht = b""
    for t in range(len(q)):
        for kind in (0, 1):
            counts, vals = _HUFF[(kind, t)]
            dht += bytes([kind << 4 | t]) + bytes(counts) + bytes(vals)
    return _segment(0xDB, dqt) + _segment(0xC4, dht)


def tables_stream(ncomp: int, quality: int = 90) -> bytes:
    """A tables-only stream (SOI, DQT, DHT, EOI) for :func:`encode_jpeg`'s
    abbreviated streams: a TIFF's ``JPEGTables``."""
    return b"\xff\xd8" + _table_segments(1 if ncomp == 1 else 2, quality) + b"\xff\xd9"


def _ycbcr(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., k].astype(np.float64) for k in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    return np.clip(np.round(np.stack([y, cb, cr], -1)), 0, 255)


def _blocks(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(H, W) samples, both multiples of 8 -> quantized coefficients, one
    block a row in row-major block order, zigzag order."""
    h, w = plane.shape
    b = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8) - 128.0
    coef = np.round(_DCT @ b @ _DCT.T / q).astype(np.int64)
    return coef.reshape(-1, 64)[:, _ZIGZAG]


def _bit_size(v: np.ndarray) -> np.ndarray:
    a = np.abs(v)
    size = np.zeros(a.shape, np.int64)
    while (a >> size).any():
        size += (a >> size) > 0
    return size


def _entropy(zz: np.ndarray, comp: np.ndarray, table: np.ndarray) -> bytes:
    """Blocks in scan order (zigzag coefficients), each block's component
    and its Huffman tables (0 luminance, 1 chrominance) -> the entropy-coded
    bytes of one scan, or of one restart interval of it."""
    n = len(zz)
    diff = np.zeros(n, np.int64)
    for c in np.unique(comp):  # one DC predictor a component
        idx = np.flatnonzero(comp == c)
        diff[idx] = np.diff(zz[idx, 0], prepend=0)
    vals, lens, order = [], [], []

    def add(block, slot, kind, sym, extra, size):
        """Symbols of blocks at slots of their block (DC 0, a coefficient k's
        ZRLs 4k..4k+2 and itself 4k+3, EOB 256), each with its extra bits."""
        t = table[block]
        code = np.where(t == 0, _CODES[(kind, 0)][0][sym], _CODES[(kind, 1)][0][sym])
        clen = np.where(t == 0, _CODES[(kind, 0)][1][sym], _CODES[(kind, 1)][1][sym])
        vals.append((code << size) | (extra & ((1 << size) - 1)))
        lens.append(clen + size)
        order.append(block * 260 + slot)

    size = _bit_size(diff)
    add(np.arange(n), 0, 0, size, np.where(diff < 0, diff - 1, diff), size)
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[b, k]
    first = np.r_[True, b[1:] != b[:-1]] if len(b) else np.zeros(0, bool)
    run = k - np.where(first, 0, np.r_[0, k[:-1]]) - 1
    for j in range(3):  # a ZRL (16 zeros) for each 16 of the run
        zb, zk = b[run >= 16 * (j + 1)], k[run >= 16 * (j + 1)]
        add(zb, 4 * zk + j, 1, np.full(len(zb), 0xF0), np.zeros_like(zb), np.zeros_like(zb))
    s = _bit_size(v)
    add(b, 4 * k + 3, 1, (run % 16) << 4 | s, np.where(v < 0, v - 1, v), s)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, k)
    eob = np.flatnonzero(last < 63)
    add(eob, np.full(len(eob), 256), 1, np.zeros_like(eob), np.zeros_like(eob),
        np.zeros_like(eob))
    vals, lens, order = (np.concatenate(a) for a in (vals, lens, order))
    perm = np.argsort(order, kind="stable")
    vals, lens = vals[perm], lens[perm]
    total = int(lens.sum())
    idx = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    bits = (np.repeat(vals, lens) >> (np.repeat(lens, lens) - 1 - idx)) & 1
    bits = np.concatenate([bits, np.ones(-total % 8, np.int64)])  # padded with 1 bits
    out = np.packbits(bits.astype(np.uint8))
    return np.insert(out, np.flatnonzero(out == 0xFF) + 1, 0).tobytes()  # byte stuffing


def _encode_planes(planes: list, factors: list, table_of: list, quality: int, tables: bool,
                   size: tuple[int, int], restart: int = 0, app: bytes = b"") -> bytes:
    """Components already padded to whole MCUs (component c sampled
    ``factors[c]`` = (h, v), coded with tables ``table_of[c]``) -> one
    stream, a restart marker every ``restart`` MCUs (0: none), ``app``'s
    segments after SOI."""
    ncomp = len(planes)
    qs = quant_tables(quality)
    zz = [_blocks(p.astype(np.float64), qs[table_of[c]]) for c, p in enumerate(planes)]
    if ncomp == 1:
        order_zz, comp = zz[0], np.zeros(len(zz[0]), np.int64)
        per_mcu = 1
    else:
        h0, v0 = factors[0]
        my_n, mx_n = planes[0].shape[0] // (8 * v0), planes[0].shape[1] // (8 * h0)
        my, mx = np.meshgrid(np.arange(my_n), np.arange(mx_n), indexing="ij")
        parts, comp = [], []
        for c, (h, v) in enumerate(factors):
            y0 = my[..., None, None] * v + np.arange(v)[:, None]
            x0 = mx[..., None, None] * h + np.arange(h)[None, :]
            parts.append(zz[c][(y0 * (mx_n * h) + x0).reshape(my_n * mx_n, h * v)])
            comp += [c] * (h * v)
        order_zz = np.concatenate(parts, 1).reshape(-1, 64)
        per_mcu = len(comp)
        comp = np.tile(np.array(comp, np.int64), my_n * mx_n)
    table = np.array(table_of, np.int64)[comp]
    step = restart * per_mcu if restart else len(order_zz)
    data = b"".join((b"\xff" + bytes([0xD0 + (k // step - 1) % 8]) if k else b"")
                    + _entropy(order_zz[k: k + step], comp[k: k + step], table[k: k + step])
                    for k in range(0, len(order_zz), step))
    width, height = size
    sof = struct.pack(">BHHB", 8, height, width, ncomp) + b"".join(
        bytes([c + 1, h << 4 | v, table_of[c]]) for c, (h, v) in enumerate(factors))
    sos = bytes([ncomp]) + b"".join(bytes([c + 1, table_of[c] * 0x11])
                                    for c in range(ncomp)) + b"\x00\x3f\x00"
    dri = _segment(0xDD, struct.pack(">H", restart)) if restart else b""
    return (b"\xff\xd8" + app + (_table_segments(max(table_of) + 1, quality) if tables else b"")
            + _segment(0xC0, sof) + dri + _segment(0xDA, sos) + data + b"\xff\xd9")


def _padded(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """Edge samples repeated out to h x w."""
    return np.pad(plane, ((0, h - plane.shape[0]), (0, w - plane.shape[1])), mode="edge")


def encode_jpeg(img: np.ndarray, quality: int = 90, sampling: tuple[int, int] = (2, 2),
                tables: bool = True) -> bytes:
    """``(H, W)`` grey or ``(H, W, 3)`` RGB uint8 -> a baseline JPEG stream.

    Colour is converted to YCbCr, its first component sampled ``sampling``
    = (h, v) times the others (grey: 1 x 1).  ``tables=False`` leaves out
    DQT and DHT."""
    img = np.asarray(img)
    height, width = img.shape[:2]
    if img.ndim == 2 or img.shape[2] == 1:
        planes, hv = [img.reshape(height, width)], (1, 1)
    else:
        planes = list(np.moveaxis(_ycbcr(img), -1, 0))
        hv = tuple(sampling)
    factors = [hv] + [(1, 1)] * (len(planes) - 1)
    return _encode_planes(_sampled(planes, factors), factors, [0, 1, 1][: len(planes)], quality,
                          tables, (width, height))


def _sampled(planes: list, factors: list) -> list:
    """Full-size planes -> each padded to whole MCUs with edge samples and
    averaged down to its own sampling (h, v) of the largest."""
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    height, width = planes[0].shape
    mh, mw = -(-height // (8 * vmax)) * 8 * vmax, -(-width // (8 * hmax)) * 8 * hmax
    out = []
    for p, (h, v) in zip(planes, factors):
        p = _padded(p, mh, mw).astype(np.float64)
        rh, rv = hmax // h, vmax // v
        out.append(np.round(p.reshape(mh // rv, rv, mw // rh, rh).mean((1, 3))))
    return out


def encode_cmyk(cmyk: np.ndarray, quality: int = 90, factors=((1, 1),) * 4,
                transform: int | None = 0, restart: int = 0) -> bytes:
    """``(H, W, 4)`` uint8 samples, as the file is to hold them (Adobe's
    CMYK, in which 255 is no ink) -> a baseline 4-component stream with an
    Adobe APP14 segment of colour transform ``transform``: 0 stores C, M, Y,
    K as they are, 2 stores YCCK (Y, Cb, Cr of 255 - C, 255 - M, 255 - Y as
    JFIF converts R, G, B, then K), None writes no Adobe segment (readers
    then take CMYK).  ``factors``: each component's (h, v); ``restart``: a
    restart marker every so many MCUs.  Tables as libjpeg's: for CMYK table
    0 for all, for YCCK 0, 1, 1, 0."""
    cmyk = np.asarray(cmyk)
    height, width = cmyk.shape[:2]
    planes = list(np.moveaxis(cmyk.astype(np.float64), -1, 0))
    table_of = [0, 0, 0, 0]
    if transform == 2:
        planes[:3] = list(np.moveaxis(_ycbcr(255 - cmyk[..., :3]), -1, 0))
        table_of = [0, 1, 1, 0]
    elif transform not in (0, None):
        raise ValueError("the writer stores Adobe transforms 0 and 2")
    app = b"" if transform is None else _segment(
        0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform))
    return _encode_planes(_sampled(planes, list(factors)), list(factors), table_of, quality, True,
                          (width, height), restart, app)


def encode_tiles(img: np.ndarray, tile: tuple[int, int], quality: int = 90,
                 sampling: tuple[int, int] = (2, 2)) -> tuple[bytes, list]:
    """An image cut into TIFF tiles of ``tile`` = (width, length), edge tiles
    padded with edge samples -> (the tables-only stream, each tile's
    abbreviated stream in the TIFF's order: rows of tiles, left to right)."""
    img = np.asarray(img)
    height, width = img.shape[:2]
    tw, tl = tile
    th, tw_n = -(-height // tl), -(-width // tw)
    pad = ((0, th * tl - height), (0, tw_n * tw - width)) + ((0, 0),) * (img.ndim - 2)
    full = np.pad(img, pad, mode="edge")
    streams = [encode_jpeg(full[y:y + tl, x:x + tw], quality, sampling, tables=False)
               for y in range(0, th * tl, tl) for x in range(0, tw_n * tw, tw)]
    return tables_stream(1 if img.ndim == 2 else 3, quality), streams


def split_tables(stream: bytes) -> tuple[bytes, bytes]:
    """A stream -> (a tables-only stream of its DQT and DHT segments before
    its first frame or scan header, the stream without them)."""
    pos, tables, rest = 2, b"", bytearray(stream[:2])
    while stream[pos + 1] not in (0xC0, 0xC1, 0xC2, 0xDA):
        (length,) = struct.unpack(">H", stream[pos + 2: pos + 4])
        seg = stream[pos: pos + 2 + length]
        if stream[pos + 1] in (0xDB, 0xC4):
            tables += seg
        else:
            rest += seg
        pos += 2 + length
    return b"\xff\xd8" + tables + b"\xff\xd9", bytes(rest + stream[pos:])


def join_tables(tables: bytes, stream: bytes) -> bytes:
    """A tables-only stream and an abbreviated one -> one whole stream."""
    return tables[:-2] + stream[2:]
