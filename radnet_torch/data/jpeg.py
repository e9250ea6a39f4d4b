"""JPEG decode as ``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` gives it (OpenCV's
libjpeg-turbo, default settings: ISLOW IDCT, fancy upsampling).

The markers, tables and frame and scan headers are parsed here (``_read``);
each scan's entropy-coded data and the output pass (IDCT, upsampling, colour
conversion) run in ``radnet_torch/csrc/jpeg_decode.cpp`` through
:mod:`radnet_torch.ops.host_kernels` (``_output``).  :func:`decode_jpeg`
reads a JPEG file as cv2 does; :func:`read_tables` and
:func:`decode_tiff_stream` read a JPEG-compressed TIFF's JPEGTables and its
strips' or tiles' streams as libtiff's JPEG codec has libjpeg-turbo read
them (``data/tiff.py``): the table slots kept from stream to stream, the
colour taken from the TIFF (YCbCr converted to R, G, B, other samples, 4
included, as they are), and data that ends read on as libtiff's fake EOI markers.

Read: baseline and extended sequential (SOF0, SOF1) and progressive (SOF2)
Huffman-coded 8-bit JPEGs of 1 component (grey), 3 (YCbCr, or RGB where
libjpeg-turbo's rules say so) or 4 (CMYK where the Adobe segment's
transform is 0 or there is none, else YCCK, which libjpeg-turbo converts to
CMYK; then OpenCV's CMYK to BGR), any integral sampling factors, restart
intervals, tables anywhere before the scan that uses them, and data that
ends early as libjpeg-turbo reads it (zero bits fed, the rest of a restart
segment left as it was).  Raised as ``ValueError`` naming the variant:
12-bit or other precisions, lossless (SOF3), hierarchical (SOF5-7) and
arithmetic-coded (SOF9-15) JPEGs, and a progressive JPEG whose refinement
scans are missing, which libjpeg-turbo would fill by block smoothing (not
ported).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from radnet_torch.data.png import check_image_size
from radnet_torch.ops.host_kernels import JPEG_DECODE

# Zigzag index -> natural (row-major) index.
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_UNREAD = {
    0xC3: "lossless JPEG (SOF3)", 0xC5: "hierarchical JPEG (SOF5)",
    0xC6: "hierarchical JPEG (SOF6)", 0xC7: "hierarchical JPEG (SOF7)",
    0xC9: "arithmetic-coded JPEG (SOF9)", 0xCA: "arithmetic-coded progressive JPEG (SOF10)",
    0xCB: "arithmetic-coded lossless JPEG (SOF11)", 0xCD: "arithmetic-coded JPEG (SOF13)",
    0xCE: "arithmetic-coded JPEG (SOF14)", 0xCF: "arithmetic-coded JPEG (SOF15)",
}
_HUFF_SPEC = 273  # 16 counts, a defined flag, 256 symbols
# A DHT body of the standard tables of JPEG Annex K.3 (DC 0, AC 0, DC 1, AC 1):
# libjpeg-turbo's sequential decoder (jdhuff.c jinit_huff_decoder) puts them
# in those slots where they are still undefined at its first scan, as a
# Motion-JPEG frame leaves them; its progressive decoder does not.
_STD_DHT = bytes.fromhex(
    "000001050101010101010000000000000000010203040506070809"
    "0a0b100002010303020403050504040000017d0102030004110512"
    "2131410613516107227114328191a1082342b1c11552d1f0243362"
    "7282090a161718191a25262728292a3435363738393a4344454647"
    "48494a535455565758595a636465666768696a737475767778797a"
    "838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2"
    "b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1"
    "e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa0100030101010101"
    "010101010000000000000102030405060708090a0b110002010204"
    "040304070504040001027700010203110405213106124151076171"
    "1322328108144291a1b1c109233352f0156272d10a162434e125f1"
    "1718191a262728292a35363738393a434445464748494a53545556"
    "5758595a636465666768696a737475767778797a82838485868788"
    "898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8"
    "b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8"
    "e9eaf2f3f4f5f6f7f8f9fa")
_MAX_BLOCKS_IN_MCU = 10  # libjpeg-turbo's D_MAX_BLOCKS_IN_MCU


class JpegError(ValueError):
    """Where libjpeg-turbo stops with an error: the stream is refused."""


class Tables:
    """The Huffman and quantization table slots of one libjpeg decompressor.
    A stream's DHT and DQT segments fill them, and they live on from stream
    to stream: libtiff's JPEG codec reads a TIFF's JPEGTables and then each
    strip or tile through one decompressor."""

    def __init__(self):
        self.huff = np.zeros((8, _HUFF_SPEC), np.uint8)
        self.quant: dict = {}


class _Frame:
    """A SOF segment.  ``tiff``: read for libtiff's codec, which refuses
    other precisions than its BitsPerSample (8), and leaves the component
    count to its own check; OpenCV's size limits do not apply there."""

    def __init__(self, body: bytes, progressive: bool, tiff: bool = False):
        if len(body) < 6:
            raise JpegError("corrupt JPEG: short SOF segment")
        precision, h, w, n = struct.unpack(">BHHB", body[:6])
        if precision != 8:
            if tiff:
                raise JpegError("Improper JPEG data precision")
            raise ValueError(f"{precision}-bit JPEG is not read yet")
        if not tiff:
            if n not in (1, 3, 4):
                raise ValueError(f"JPEG with {n} components is not read")
        elif not 1 <= n <= 10:  # MAX_COMPONENTS
            raise JpegError("corrupt JPEG: bad component count")
        if w == 0 or h == 0:
            if tiff:
                raise JpegError("corrupt JPEG: empty image")
            raise ValueError("JPEG with an empty frame (or a DNL marker) is not read")
        if not tiff:
            check_image_size(w, h)
        if len(body) != 6 + 3 * n:
            raise JpegError("corrupt JPEG: bad SOF length")
        self.width, self.height, self.progressive = w, h, progressive
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i: 9 + 3 * i]
            hs, vs = hv >> 4, hv & 15
            if not (1 <= hs <= 4 and 1 <= vs <= 4) or tq > 3:
                raise JpegError("corrupt JPEG: bad sampling factor or table")
            self.ids.append(cid)
            self.h.append(hs)
            self.v.append(vs)
            self.tq.append(tq)
        self.hmax, self.vmax = max(self.h), max(self.v)
        if any(self.hmax % hs or self.vmax % vs for hs, vs in zip(self.h, self.v)):
            raise ValueError("JPEG with fractional sampling ratios is not read")
        self.mcus_x = -(-w // (8 * self.hmax))
        self.mcus_y = -(-h // (8 * self.vmax))
        self.coefs = None
        self.quant = [None] * n  # latched at a component's first scan
        # libjpeg's coef_bits: the bit position each coefficient is known to (-1: none).
        self.coef_bits = np.full((n, 64), -1, np.int32)

    def allocate(self) -> None:
        self.coefs = [np.zeros((self.mcus_y * vs * self.mcus_x * hs, 64), np.int16)
                      for hs, vs in zip(self.h, self.v)]

    def blocks(self, i: int) -> tuple[int, int]:
        """Component i's own extent in blocks (a non-interleaved scan's)."""
        cw = -(-self.width * self.h[i] // self.hmax)
        ch = -(-self.height * self.v[i] // self.vmax)
        return -(-cw // 8), -(-ch // 8)


def _smoothing(frame: _Frame) -> bool:
    """Whether libjpeg-turbo would smooth the blocks (jdcoefct.c
    smoothing_ok): a progressive file, every component's DC known and its
    quantizers of the first 10 zigzag places non-zero, and some of those
    places' bits still unsent."""
    if not frame.progressive:
        return False
    useful = False
    for q, bits in zip(frame.quant, frame.coef_bits):
        if q is None or not q[_NATURAL[:10]].all() or bits[0] < 0:
            return False
        useful |= bool((bits[1:10] != 0).any())
    return useful


def _dht(body: bytes, tables: np.ndarray) -> None:
    pos = 0
    while pos < len(body):
        if pos + 17 > len(body):
            raise JpegError("corrupt JPEG: short DHT segment")
        tc, th = body[pos] >> 4, body[pos] & 15
        counts = body[pos + 1: pos + 17]
        n = sum(counts)
        if tc > 1 or th > 3 or n > 256 or pos + 17 + n > len(body):
            raise JpegError("corrupt JPEG: bad Huffman table")
        spec = tables[4 * tc + th]
        spec[:] = 0
        spec[:16] = np.frombuffer(counts, np.uint8)
        spec[16] = 1
        spec[17: 17 + n] = np.frombuffer(body[pos + 17: pos + 17 + n], np.uint8)
        pos += 17 + n


def _check_huff(spec: np.ndarray, dc: bool) -> None:
    """jdhuff.c jpeg_make_d_derived_tbl's checks: codes fit their lengths,
    DC symbols at most 15."""
    code = 0
    for length in range(1, 17):
        code += int(spec[length - 1])
        if spec[length - 1] and code >= (1 << length):  # an all-ones code is not allowed
            raise JpegError("corrupt JPEG: bad Huffman table")
        code <<= 1
    n = int(spec[:16].sum())
    if dc and (spec[17: 17 + n] > 15).any():
        raise JpegError("corrupt JPEG: bad Huffman table")


def _dqt(body: bytes, quant: dict) -> None:
    pos = 0
    while pos < len(body):
        pq, tq = body[pos] >> 4, body[pos] & 15
        size = 128 if pq else 64
        if tq > 3 or pq > 1 or pos + 1 + size > len(body):
            raise JpegError("corrupt JPEG: bad quantization table")
        zz = np.frombuffer(body[pos + 1: pos + 1 + size], ">u2" if pq else np.uint8)
        table = np.zeros(64, np.uint16)
        table[_NATURAL] = zz
        quant[tq] = table.view(np.int16)  # libjpeg-turbo's ISLOW multipliers are short
        pos += 1 + size


def _scan(src: "_Src", pos: int, body: bytes, frame: _Frame, tables: np.ndarray,
          quant: dict, restart_interval: int) -> int:
    """One SOS: check its header, decode its data.  Returns where the reader
    goes on after it."""
    if frame is None:
        raise JpegError("corrupt JPEG: SOS before SOF")
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
        raise JpegError("corrupt JPEG: bad SOS segment")
    comps, used = [], []
    for k in range(ns):
        cid, td_ta = body[1 + 2 * k], body[2 + 2 * k]
        if cid not in frame.ids or any(frame.ids[i] == cid for i, _, _ in comps):
            raise JpegError("corrupt JPEG: scan names an unknown or repeated component")
        comps.append((frame.ids.index(cid), td_ta >> 4, td_ta & 15))
    ss, se, ahal = body[1 + 2 * ns: 4 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    if frame.progressive:
        bad = (se != 0) if ss == 0 else (se < ss or se > 63 or ns != 1)
        if bad or (ah and al != ah - 1) or al > 13:
            raise JpegError("corrupt JPEG: bad progression parameters")
    else:
        ss, se, ah, al = 0, 63, 0, 0
    blocks = 1 if ns == 1 else sum(frame.h[i] * frame.v[i] for i, _, _ in comps)
    if blocks > _MAX_BLOCKS_IN_MCU:
        raise JpegError("corrupt JPEG: too many blocks in an MCU")
    params = np.zeros(10 + 8 * ns, np.int32)
    params[:10] = [ns, ss, se, ah, al, frame.progressive, restart_interval,
                   frame.mcus_x, frame.mcus_y, src.fake]
    for k, (i, td, ta) in enumerate(comps):
        need_dc = ss == 0 and ah == 0  # DC refinement reads raw bits
        need_ac = ss > 0 or not frame.progressive
        for t, need, dc in ((td, need_dc, True), (ta, need_ac, False)):
            if need:
                if t > 3 or not tables[t + 4 * (not dc), 16]:
                    raise JpegError("corrupt JPEG: scan uses an undefined Huffman table")
                _check_huff(tables[t + 4 * (not dc)], dc)
        if frame.quant[i] is None:
            if frame.tq[i] not in quant:
                raise JpegError("corrupt JPEG: component uses an undefined quantization table")
            frame.quant[i] = quant[frame.tq[i]].copy()
        bw, bh = frame.blocks(i)
        params[10 + 8 * k: 18 + 8 * k] = [frame.h[i], frame.v[i], frame.mcus_x * frame.h[i],
                                          bw, bh, td if need_dc else -1, ta if need_ac else -1, 0]
        frame.coef_bits[i, ss: se + 1] = al
        used.append(i)
    coef_ptrs = (ctypes.c_void_p * ns)(*(frame.coefs[i].ctypes.data for i in used))
    end = JPEG_DECODE.fn("radnet_jpeg_scan")(
        src.data, src.n, pos, params.ctypes.data, tables.ctypes.data, coef_ptrs)
    if end < 0:
        raise JpegError("truncated JPEG: the data ends inside a scan")
    return int(end)


class _Src:
    """A stream's bytes as a libjpeg data source hands them over.  OpenCV's
    memory source suspends where the data ends, and cv2 then gives no image:
    with ``fake_eoi`` False, reading past the end raises.  libtiff's
    (tif_jpeg.c ``std_fill_input_buffer``) hands over a fake EOI marker,
    FF D9, each time it is asked for more, so past the end the bytes read
    FF D9 FF D9 ..., and a skip past what is left lands on a fresh FF D9
    (``std_skip_input_data``).  Positions past the end count on: the bytes
    at even offsets from the end are FF."""

    def __init__(self, data: bytes, fake_eoi: bool):
        self.data, self.n, self.fake = data, len(data), fake_eoi

    def read(self, pos: int, k: int) -> bytes:
        if pos + k <= self.n:
            return self.data[pos: pos + k]
        if not self.fake:
            raise JpegError("truncated JPEG: the data ends in a marker segment")
        start = max(pos, self.n)
        phase = (start - self.n) % 2
        tail = b"\xff\xd9" * ((pos + k - start) // 2 + 2)
        return self.data[pos: self.n] + tail[phase: phase + pos + k - start]

    def skip(self, pos: int, k: int) -> int:
        if k <= 0:
            return pos
        left = self.n - pos if pos < self.n else 2 - (pos - self.n) % 2
        return pos + k if k <= left else pos + left


def _next_marker(src: _Src, pos: int) -> tuple[int, int]:
    """jdmarker.c next_marker: skip to an FF, then past fill FFs.  Returns
    (marker, offset after it); a truncated file raises."""
    data, n = src.data, src.n
    while True:
        f = data.find(b"\xff", pos) if pos < n else -1
        q = f + 1
        while 0 < q < n and data[q] == 0xFF:
            q += 1
        if f < 0 or q >= n:
            if not src.fake:
                raise JpegError("truncated JPEG: the data ends before EOI")
            # The fake EOI: its FF (any fill FFs before it swallowed), then D9.
            at = max(q if f >= 0 else pos, n)
            at += (at - n) % 2
            return 0xD9, at + 2
        if data[q] != 0:
            return data[q], q + 1
        pos = q + 1


class _Parsed:
    def __init__(self, frame, exif, jfif, adobe_transform):
        self.frame, self.exif, self.jfif, self.adobe_transform = frame, exif, jfif, adobe_transform


def _read(src: _Src, tables: Tables, mode: str, on_frame=None) -> _Parsed | None:
    """A stream's markers and scans, read as libjpeg-turbo reads them until
    it can write the image: every scan of a progressive or multi-scan frame,
    the first of a single-scan one.  ``mode``: "file" (cv2.imdecode of a JPEG
    file), "tiff" (a TIFF strip's or tile's stream through libtiff's codec:
    the colour markers are not read, the segments libjpeg skips are skipped
    as its source skips them) or "tables" (a TIFF's JPEGTables, which
    libtiff reads with jpeg_read_header(FALSE): only tables until EOI, else
    "Bogus JPEGTables field").  ``on_frame(frame)`` runs at the frame header,
    before its coefficients are allocated."""
    tiff = mode != "file"
    huff, quant = tables.huff, tables.quant
    frame = None
    restart_interval = 0
    exif = None
    jfif = False
    adobe_transform = None
    scans = 0
    if tiff and src.read(0, 2) != b"\xff\xd8":
        raise JpegError("corrupt JPEG: no SOI marker")
    pos = 2
    while True:
        marker, pos = _next_marker(src, pos)
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # no parameters
            continue
        if marker == 0xD8:
            raise JpegError("corrupt JPEG: two SOI markers")
        (length,) = struct.unpack(">H", src.read(pos, 2))
        if tiff and (0xE0 <= marker <= 0xEF or marker in (0xDC, 0xFE)):
            # APPn, DNL and COM: skipped, but for the 14 bytes libjpeg's
            # get_interesting_appn reads of APP0 and APP14.
            keep = min(max(length - 2, 0), 14) if marker in (0xE0, 0xEE) else 0
            pos = src.skip(pos + 2 + keep, length - 2 - keep)
            continue
        if length < 2:
            raise JpegError("corrupt JPEG: bad marker length")
        body = src.read(pos + 2, length - 2)
        pos += length
        if mode == "tables" and (0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC)):
            continue  # a frame header among the tables is read and forgotten
        if marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise JpegError("corrupt JPEG: two SOF markers")
            frame = _Frame(body, progressive=marker == 0xC2, tiff=tiff)
            if on_frame is not None:
                on_frame(frame)
            frame.allocate()
        elif marker in _SOF_UNREAD:
            raise ValueError(f"{_SOF_UNREAD[marker]} is not read yet")
        elif marker == 0xC4:
            _dht(body, huff)
        elif marker == 0xDB:
            _dqt(body, quant)
        elif marker == 0xDD:
            if len(body) != 2:
                raise JpegError("corrupt JPEG: bad DRI length")
            (restart_interval,) = struct.unpack(">H", body[:2])
        elif marker == 0xDA:
            if mode == "tables":
                raise JpegError("Bogus JPEGTables field: it holds image data")
            if scans == 0 and frame is not None and not frame.progressive:
                std = np.zeros_like(huff)
                _dht(_STD_DHT, std)
                undefined = huff[:, 16] == 0
                huff[undefined] = std[undefined]
            pos = _scan(src, pos, body, frame, huff, quant, restart_interval)
            scans += 1
            if scans == 1 and not frame.progressive and body[0] == len(frame.ids):
                # One sequential scan of every component: libjpeg-turbo
                # writes the image from it and reads nothing after it.
                break
        # The markers OpenCV and libjpeg-turbo read the colour space and
        # the orientation from are those before the first scan.
        elif marker == 0xE0 and scans == 0 and body.startswith(b"JFIF\0"):
            jfif = True
        elif marker == 0xE1 and scans == 0 and exif is None and body.startswith(b"Exif\0\0"):
            exif = body[6:]
        elif marker == 0xEE and scans == 0 and body.startswith(b"Adobe") and len(body) >= 12:
            adobe_transform = body[11]
        elif marker in (0xDE, 0xDF) or 0xF0 <= marker <= 0xFD or marker < 0xC0:
            raise JpegError(f"JPEG marker 0x{marker:02X} is not read")
    if mode == "tables":
        return None
    if frame is None or scans == 0:
        raise JpegError("corrupt JPEG: no image data")
    if _smoothing(frame):
        raise ValueError("progressive JPEG with missing refinement scans is not read yet "
                         "(libjpeg-turbo fills them by block smoothing)")
    return _Parsed(frame, exif, jfif, adobe_transform)


# radnet_jpeg_output's colour modes: YCbCr or R, G, B components written as
# B, G, R (cv2's image); YCbCr written as R, G, B (libtiff's buffer under
# JPEGCOLORMODE_RGB); the components as they are, interleaved; CMYK, and
# YCCK converted to CMYK, written as B, G, R as OpenCV converts CMYK.
YCC_BGR, RGB_BGR, YCC_RGB, AS_IS, CMYK_BGR, YCCK_BGR = 0, 1, 2, 3, 4, 5


def _output(frame: _Frame, colour: int, out: np.ndarray, stride: int, rows: int) -> None:
    """IDCT, upsampling and the colour mode into ``out``: its first
    ``rows`` rows (at most the frame's), ``stride`` bytes apart."""
    n = len(frame.ids)
    params = np.zeros(8 + 4 * n, np.int32)
    params[:8] = [n, frame.width, frame.height, frame.hmax, frame.vmax, colour, stride,
                  min(rows, frame.height)]
    for i in range(n):
        params[8 + 4 * i: 12 + 4 * i] = [frame.h[i], frame.v[i], frame.mcus_x * frame.h[i], 0]
    quant_all = np.stack([q if q is not None else np.zeros(64, np.int16) for q in frame.quant])
    coef_ptrs = (ctypes.c_void_p * n)(*(c.ctypes.data for c in frame.coefs))
    JPEG_DECODE.fn("radnet_jpeg_output")(params.ctypes.data, coef_ptrs,
                                         quant_all.ctypes.data, out.ctypes.data)


def decode_jpeg(data: bytes) -> tuple[np.ndarray, bytes | None]:
    """JPEG bytes -> (BGR ``(H, W, 3)`` uint8, the TIFF bytes of its first
    ``Exif`` APP1 segment or None).  The orientation is not applied here."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError("not a JPEG file")
    parsed = _read(_Src(bytes(data), fake_eoi=False), Tables(), "file")
    frame = parsed.frame
    colour = YCC_BGR
    if len(frame.ids) == 4:
        # jdapimin.c default_decompression_parms: Adobe transform 0 is CMYK,
        # any other YCCK (libjpeg-turbo warns of codes other than 2); no
        # Adobe marker, CMYK.  OpenCV asks for CMYK out.
        colour = YCCK_BGR if parsed.adobe_transform not in (None, 0) else CMYK_BGR
    elif len(frame.ids) == 3 and not parsed.jfif:
        if parsed.adobe_transform is not None:
            colour = RGB_BGR if parsed.adobe_transform == 0 else YCC_BGR
        elif frame.ids == [82, 71, 66]:  # 'R', 'G', 'B'
            colour = RGB_BGR
    out = np.empty((frame.height, frame.width, 3), np.uint8)
    _output(frame, colour, out, 3 * frame.width, frame.height)
    return out, parsed.exif


def read_tables(tables: Tables, data: bytes) -> None:
    """A TIFF's JPEGTables stream into the table slots, as libtiff's
    JPEGSetupDecode reads it; JpegError where libtiff refuses it."""
    _read(_Src(bytes(data), fake_eoi=True), tables, "tables")


def decode_tiff_stream(tables: Tables, data: bytes, on_frame, colour: int, out: np.ndarray,
                       stride: int, rows: int) -> None:
    """One TIFF strip's or tile's stream through libtiff's JPEG codec, the
    tables kept in ``tables``: its header and the scans libjpeg reads before
    it writes (JPEGPreDecode; ``on_frame`` makes libtiff's checks of the
    frame), then up to ``rows`` rows written into ``out`` as JPEGDecode asks
    libjpeg for them (``colour`` YCC_RGB or AS_IS).  JpegError where libtiff
    or libjpeg refuses the stream; ValueError naming a variant not read yet."""
    frame = _read(_Src(bytes(data), fake_eoi=True), tables, "tiff", on_frame).frame
    _output(frame, colour, out, stride, rows)
