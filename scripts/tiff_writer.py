"""A TIFF writer for test tooling: numpy and the standard library only.

:func:`encode_tiff` writes one page, or several, of integer samples as
strips or tiles, in either byte order, classic TIFF or BigTIFF, with
compression none (1), LZW (5), Deflate (8 or 32946), PackBits (32773) or
JPEG (7: streams encoded beforehand, one a strip or tile, and an optional
``JPEGTables`` stream; ``scripts/jpeg_writer.py`` encodes both), Predictor
2 (horizontal differencing) at 8 and 16 bits, planar configuration 1 or 2,
and any tag added, replaced or left out.  PIL cannot write tiles or
BigTIFF, and the card's host has neither PIL nor OpenCV:
``scripts/make_image_fixtures.py`` and ``chip_smoke.py`` write their TIFFs
with this file, and the tests hold what it writes, decoded by cv2, equal to
the samples written.

Samples are given as the file holds them: ``(H, W)`` or ``(H, W, S)``, grey
or RGB order, at ``bits`` 1, 2, 4, 8, 16 or 32 (32 as uint32 or float32).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# field type -> (struct code, size)
TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
         7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
         16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
COMPRESSIONS = {"none": 1, "lzw": 5, "deflate": 8, "adobe_deflate": 8, "deflate_32946": 32946,
                "packbits": 32773, "jpeg": 7}


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (libtiff's encoder): a Clear code first, codes of 9 to 12
    bits MSB first, the width raised one code early, a Clear when the table
    is full, EOI last."""
    out = bytearray()
    acc = nacc = 0
    nbits, maxcode, free_ent = 9, 511, 258

    def put(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    put(256)
    table: dict = {}
    ent = -1
    for c in data:
        if ent < 0:
            ent = c
            continue
        key = (ent << 8) | c
        code = table.get(key)
        if code is not None:
            ent = code
            continue
        put(ent)
        ent = c
        table[key] = free_ent
        free_ent += 1
        if free_ent == 4094:
            put(256)
            table.clear()
            nbits, maxcode, free_ent = 9, 511, 258
        elif free_ent > maxcode:
            nbits += 1
            maxcode = (1 << nbits) - 1
    if ent >= 0:
        put(ent)
        free_ent += 1
        if free_ent == 4094:
            put(256)
            nbits = 9
        elif free_ent > maxcode:
            nbits += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 2 to 128 equal bytes, literals of up to 128."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([(257 - (j - i + 1)) & 0xFF, data[i]])
            i = j + 1
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
            j += 1
        out.append(j - i - 1)
        out += data[i:j]
        i = j
    return bytes(out)


def compress(raw: bytes, compression: int) -> bytes:
    if compression == 1:
        return raw
    if compression == 5:
        return lzw_encode(raw)
    if compression in (8, 32946):
        return zlib.compress(raw, 6)
    if compression == 32773:
        return packbits_encode(raw)
    raise ValueError(f"the writer does not compress with {compression}")


def ycbcr_blocks(block: np.ndarray, subsampling: tuple[int, int]) -> np.ndarray:
    """``(rows, cols, 3)`` Y, Cb, Cr samples -> the bytes of packed YCbCr
    (TIFF 6.0 section 21): rows and columns cut into blocks of ``subsampling``
    = (hs, vs) pixels, edge samples repeated past the edges; each block's hs
    x vs luma samples row by row, then the means of its Cb and of its Cr."""
    hs, vs = subsampling
    rows, cols, _ = block.shape
    br, bc = -(-rows // vs), -(-cols // hs)
    full = np.pad(block, ((0, br * vs - rows), (0, bc * hs - cols), (0, 0)), mode="edge")
    b = full.reshape(br, vs, bc, hs, 3).transpose(0, 2, 1, 3, 4).reshape(br, bc, vs * hs, 3)
    chroma = np.round(b[..., 1:].astype(np.float64).mean(2))
    return np.concatenate([b[..., 0], chroma], -1).astype(np.uint8).reshape(-1)


def _packed_bytes(block: np.ndarray, subsampling: tuple[int, int], predictor: int,
                  rowsize: int) -> bytes:
    """Packed YCbCr bytes of a strip or tile, differenced first under
    Predictor 2 as libtiff undoes it: in rows of ``rowsize`` bytes (its
    scanline size of packed data, or a tile's row of 3 samples a pixel),
    each byte less the one 3 before it."""
    data = ycbcr_blocks(block, subsampling)
    if predictor == 2:
        whole = len(data) - len(data) % rowsize
        rows = data[:whole].reshape(-1, rowsize).astype(np.int64)
        rows[:, 3:] -= data[:whole].reshape(-1, rowsize)[:, :-3]
        data = np.concatenate([(rows % 256).astype(np.uint8).reshape(-1), data[whole:]])
    return data.tobytes()


def _rows_bytes(block: np.ndarray, bits: int, predictor: int, order: str) -> bytes:
    """(rows, cols, samples) -> the rows' bytes, each row padded to a byte,
    differenced first under Predictor 2."""
    if predictor == 2:
        if bits not in (8, 16, 32):
            raise ValueError("Predictor 2 needs 8, 16 or 32 bits")
        d = block.astype(np.int64)
        d[:, 1:] -= block[:, :-1].astype(np.int64)
        block = (d % (1 << bits)).astype(block.dtype)
    rows, cols, spp = block.shape
    if bits >= 8:
        dt = {8: "u1", 16: "u2", 32: "u4"}[bits] if block.dtype.kind != "f" else "f4"
        return np.ascontiguousarray(block.astype(order + dt)).tobytes()
    vals = block.reshape(rows, cols * spp).astype(np.uint8)
    shifts = np.arange(8 // bits - 1, -1, -1) * bits
    per = 8 // bits
    pad = (-vals.shape[1]) % per
    vals = np.pad(vals, ((0, 0), (0, pad))).reshape(rows, -1, per)
    return (vals << shifts).sum(-1).astype(np.uint8).tobytes()


class _Ifd:
    def __init__(self, order: str, big: bool):
        self.order, self.big, self.entries = order, big, {}

    def set(self, tag: int, typ: int, values) -> None:
        if typ == 2:
            values = values.encode("latin-1") + b"\0" if isinstance(values, str) else values
        elif not isinstance(values, (list, tuple, np.ndarray, bytes, bytearray)):
            values = [values]
        self.entries[tag] = (typ, values)


def _value_bytes(order: str, typ: int, values) -> tuple[bytes, int]:
    if typ == 2 or typ == 7:
        data = bytes(values)
        return data, len(data)
    code, _ = TYPES[typ]
    if typ in (5, 10):
        flat = [int(v) for pair in values for v in pair]
        return struct.pack(order + code[0] * len(flat), *flat), len(values)
    vals = [float(v) if typ in (11, 12) else int(v) for v in values]
    return struct.pack(order + code * len(vals), *vals), len(vals)


def _ifd_bytes(ifd: _Ifd, start: int, order: str, big: bool) -> bytes:
    """The IFD at ``start``: its entries, a zero next-IFD offset, then the
    values that do not fit in an entry."""
    entry_fmt, ptr_fmt = ("HHQ", "Q") if big else ("HHI", "I")
    inline = 8 if big else 4
    n = len(ifd.entries)
    extra_at = start + (8 if big else 2) + n * (20 if big else 12) + (8 if big else 4)
    extra, entries = bytearray(), bytearray()
    for tag in sorted(ifd.entries):
        typ, values = ifd.entries[tag]
        data, count = _value_bytes(order, typ, values)
        if len(data) <= inline:
            field = data + b"\0" * (inline - len(data))
        else:
            field = struct.pack(order + ptr_fmt, extra_at + len(extra))
            extra += data + b"\0" * (len(data) % 2)
        entries += struct.pack(order + entry_fmt, tag, typ, count) + field
    return (struct.pack(order + ("Q" if big else "H"), n) + entries + b"\0" * (8 if big else 4)
            + extra)


def _layout(pages: list, order: str, big: bool, ifd_first: bool) -> bytes:
    """Header, then each page: its blocks and then its IFD, or (ifd_first)
    its IFD and then its blocks."""
    head = b"II" if order == "<" else b"MM"
    out = bytearray(head + (struct.pack(order + "HHHQ", 43, 8, 0, 0) if big
                            else struct.pack(order + "HI", 42, 0)))
    ptr_fmt = "Q" if big else "I"
    prev_ptr = 8 if big else 4
    long_t = 16 if big else 4
    for ifd, blocks, offsets_tag, counts_tag, tags in pages:
        out += b"\0" * (len(out) % 2)

        def place(first: int) -> None:
            offsets, at = [], first
            for b in blocks:
                offsets.append(at)
                at += len(b) + len(b) % 2
            ifd.set(offsets_tag, long_t, offsets)
            ifd.set(counts_tag, long_t, [len(b) for b in blocks])
            for tag in (273, 279, 324, 325):  # given offsets or counts replace the true ones
                if tag in tags:
                    ifd.entries.pop(tag) if tags[tag] is None else ifd.set(tag, *tags[tag])

        data = b"".join(b + b"\0" * (len(b) % 2) for b in blocks)
        if ifd_first:
            start = len(out)
            place(0)
            size = len(_ifd_bytes(ifd, start, order, big))
            place(start + size)
            body = _ifd_bytes(ifd, start, order, big)
            out += body
            next_ptr = start + (8 if big else 2) + len(ifd.entries) * (20 if big else 12)
            out += data
        else:
            place(len(out))
            out += data
            start = len(out)
            out += _ifd_bytes(ifd, start, order, big)
            next_ptr = start + (8 if big else 2) + len(ifd.entries) * (20 if big else 12)
        struct.pack_into(order + ptr_fmt, out, prev_ptr, start)
        prev_ptr = next_ptr
    return bytes(out)


def _page(img, bits=8, photometric=None, compression=1, predictor=1, planar=1, tile=None,
          rows_per_strip=None, tags=None, order="<", big=False, streams=None, jpeg_tables=None,
          subsampling=None):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, spp = img.shape
    compression = COMPRESSIONS.get(compression, compression)
    if photometric is None:
        photometric = 1 if spp in (1, 2) else 2
    ifd = _Ifd(order, big)
    ifd.set(256, 4, w)
    ifd.set(257, 4, h)
    ifd.set(258, 3, [bits] * spp)
    ifd.set(259, 3, compression)
    ifd.set(262, 3, photometric)
    ifd.set(277, 3, spp)
    ifd.set(284, 3, planar)
    if img.dtype.kind == "f":
        ifd.set(339, 3, [3] * spp)
    if predictor != 1:
        ifd.set(317, 3, predictor)
    if jpeg_tables is not None:
        ifd.set(347, 7, jpeg_tables)
    packed = subsampling is not None and planar == 1 and compression != 7
    if subsampling is not None:
        ifd.set(530, 3, list(subsampling))

    def encoded(block, rowsize):
        if packed:
            return compress(_packed_bytes(block, subsampling, predictor, rowsize), compression)
        return compress(_rows_bytes(block, bits, predictor, order), compression)

    planes = [img] if planar == 1 or spp == 1 else [img[..., k:k + 1] for k in range(spp)]
    blocks = []
    if tile is not None:
        tw, tl = tile
        ifd.set(322, 4, tw)
        ifd.set(323, 4, tl)
        for plane in planes:
            for y in range(0, h, tl):
                for x in range(0, w, tw):
                    if compression == 7:  # the streams given take the blocks' places
                        blocks.append(None)
                        continue
                    block = np.zeros((tl, tw, plane.shape[2]), plane.dtype)
                    part = plane[y:y + tl, x:x + tw]
                    block[:part.shape[0], :part.shape[1]] = part
                    blocks.append(encoded(block, 3 * tw))
        offsets_tag, counts_tag = 324, 325
    else:
        rps = rows_per_strip or h
        ifd.set(278, 4, rps)
        if packed:  # libtiff's scanline of packed YCbCr: a row of blocks over vs
            hs, vs = subsampling
            scanline = -(-w // hs) * (hs * vs + 2) // vs
        for plane in planes:
            for y in range(0, h, rps):
                blocks.append(None if compression == 7 else
                              encoded(plane[y:y + rps], scanline if packed else 0))
        offsets_tag, counts_tag = 273, 279
    if compression == 7:
        if streams is None or len(streams) != len(blocks):
            raise ValueError(f"JPEG compression takes {len(blocks)} encoded streams")
        blocks = [bytes(s) for s in streams]
    for tag, value in (tags or {}).items():
        if value is None:
            ifd.entries.pop(tag, None)
        else:
            ifd.set(tag, *value)
    return ifd, blocks, offsets_tag, counts_tag, tags or {}


def encode_tiff(img, *, order: str = "<", bigtiff: bool = False, ifd_first: bool = False, pages=(),
                **page) -> bytes:
    """One page of samples ``img`` (and a further page for each dict of
    :func:`_page` arguments in ``pages``) -> TIFF bytes.

    ``page`` takes ``bits``, ``photometric`` (default: 1 for 1 or 2 samples,
    else 2), ``compression`` (a code or a name of ``COMPRESSIONS``),
    ``predictor``, ``planar``, ``tile=(width, length)`` or
    ``rows_per_strip``, ``streams`` (compression ``"jpeg"``: a JPEG stream a
    strip or tile, in the file's block order) and ``jpeg_tables``,
    ``subsampling=(hs, vs)`` (YCbCrSubsampling; with Photometric 6 in
    contiguous planes and another compression than JPEG, ``img``'s Y, Cb, Cr
    samples are stored packed in blocks, :func:`ycbcr_blocks`), and
    ``tags``: {tag: (type, values)} to add or replace, or {tag: None} to
    leave one out.  ``order`` is ``"<"`` (II) or
    ``">"`` (MM); ``ifd_first`` puts each IFD before its data, as PIL does,
    instead of after it, as libtiff does."""
    made = [_page(img, order=order, big=bigtiff, **page)]
    for more in pages:
        more = dict(more)
        made.append(_page(more.pop("img"), order=order, big=bigtiff, **more))
    return _layout(made, order, bigtiff, ifd_first)


def write_tiff(path: str, img, **kw) -> None:
    with open(path, "wb") as f:
        f.write(encode_tiff(img, **kw))
