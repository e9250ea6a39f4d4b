"""TIFF decode as ``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` gives it: OpenCV
5.0.0's TIFF decoder over libtiff 4.7.1, which reads every 8-bit output
through libtiff's RGBA interface (``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile``,
``tif_getimage.c``).

The first page (IFD0) is read, classic TIFF or BigTIFF, in either byte order:
strips or tiles (edge tiles padded past the image), planar configuration 1
or 2, compression none, LZW, Deflate (8 and 32946), PackBits and JPEG (7),
Predictor 2 at 8 and 16 bits, FillOrder 2; grey (Photometric 0 and 1) at 1, 8 and 16
bits, RGB at 8 and 16 bits, palette at 1, 4 and 8 bits (a colormap with no
entry above 255 is read as 8-bit, ``checkcmap``), CMYK (Photometric 5,
InkSet 1); an alpha sample kept when associated and premultiplied into the
colours when not; YCbCr (Photometric 6) of 3 samples of 8 bits converted by
libtiff's tables (``TIFFYCbCrToRGBInit`` from ``YCbCrCoefficients`` and
``ReferenceBlackWhite``, ``_ycbcr_tables``), packed in blocks of hs x vs
luma samples and their Cb and Cr at the subsamplings ``tif_getimage.c``
puts (1,1, 1,2, 2,1, 2,2, 4,1, 4,2, 4,4; libtiff's sizes of packed rows),
or in separate planes at 1,1; and the Orientation tag, including
libtiff's mirroring of each tile under a horizontal flip.  A
JPEG-compressed TIFF is read as libtiff's JPEG codec reads it
(``_JpegCodec``): each strip or tile a JPEG stream decoded by
``data/jpeg.py`` through one decompressor whose tables ``JPEGTables``
fills first; grey, RGB and 4 samples (CMYK, RGB and an extra sample) with
no colour conversion, YCbCr in contiguous planes converted to RGB by
libjpeg (under ``YCbCrSubsampling`` or, without it, the first stream's
sampling), palette, and grey, RGB or YCbCr (libtiff's tables) in separate
planes; libtiff's checks of each stream's size, component count,
precision and sampling refuse what cv2 refuses.  The file structure is
read here as libtiff's ``TIFFReadDirectory`` reads it (defaults, the tags
it ignores or refuses, ``ChopUpSingleUncompressedStrip``, its fixes of bad
byte counts), and OpenCV's checks are applied; the byte-by-byte work runs
in ``radnet_torch/csrc/tiff_decode.cpp``
(:mod:`radnet_torch.ops.host_kernels`), and Deflate is ``zlib``.  As under
libtiff, a strip that fails to decode leaves what was decoded and zeros
after it; a strip that cannot be read at all, or any file cv2 refuses,
raises ``ValueError`` saying why.

Raised as ``ValueError`` naming the variant ("... is not read yet"): old-style
JPEG compression, CCITT fax and the other libtiff codecs, CIELab, ICCLab,
ITULab, LogLuv and LogL, signed or floating-point samples, old-style
(bit-reversed) LZW, and the few malformed directories whose libtiff fix-ups
are not ported (``ROADMAP.md`` Queue 3).
"""

from __future__ import annotations

import ctypes
import struct
import sys
import zlib

import numpy as np

from radnet_torch.data import jpeg
from radnet_torch.data.png import check_image_size
from radnet_torch.ops.host_kernels import TIFF_DECODE

# field type -> bytes a value
_WIDTH = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4,
          16: 8, 17: 8, 18: 8}
_INT_CODES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 16: "Q", 17: "q"}  # not IFD, IFD8
# Codecs libtiff has under OpenCV that the port does not run; they name
# the variant.  A code libtiff does not know decodes to zeros there.
_NOT_YET = {2: "CCITT RLE", 3: "CCITT Group 3 fax", 4: "CCITT Group 4 fax",
            32766: "NeXT 2-bit RLE", 32771: "CCITT RLEW", 32809: "ThunderScan",
            34676: "SGILog", 34677: "SGILog24"}
_NOT_CONFIGURED = {6: "old-style JPEG", 34661: "JBIG", 34887: "LERC", 34925: "LZMA",
                   50000: "ZSTD", 50001: "WebP"}
_PHOTOMETRIC_NOT_YET = {8: "CIELab", 9: "ICCLab", 10: "ITULab", 32844: "LogL", 32845: "LogLuv"}
_FLOAT_CODES = {**_INT_CODES, 11: "f", 12: "d"}
_FLT_MAX = float(np.finfo(np.float32).max)
# The contiguous YCbCr subsamplings tif_getimage.c has a put routine for.
_YCBCR_PUTS = {(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)}
_HOST_SWAPS = sys.byteorder != "little"
STRIP_SIZE_DEFAULT = 8192  # libtiff's chop size for one uncompressed strip
_MAX_COLOR = {0: 1, 1: 1, 3: 1, 4: 1, 32844: 1, 2: 3, 6: 3, 8: 3, 9: 3, 10: 3, 32845: 3, 5: 4}
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)  # FillOrder 2


class _Refused(Exception):
    """libtiff or OpenCV refuses the file: cv2 gives no image."""


def _refuse(why: str):
    raise _Refused(why)


class _Entry:
    __slots__ = ("tag", "type", "count", "field")

    def __init__(self, tag, typ, count, field):
        self.tag, self.type, self.count, self.field = tag, typ, count, field


class _File:
    """The bytes and the byte order; reads an entry's values as libtiff's
    TIFFReadDirEntry* functions do."""

    def __init__(self, data: bytes, e: str, big: bool):
        self.data, self.e, self.big = data, e, big

    def raw(self, ent: _Entry, count: int | None = None) -> bytes | None:
        """The first ``count`` values' bytes (all by default): inline when the
        whole entry fits in the field, else at its offset; None where they
        are past the end of the file (TIFFReadDirEntryErrIo)."""
        width = _WIDTH.get(ent.type)
        if width is None:
            return None
        size = width * (ent.count if count is None else count)
        if width * ent.count <= (8 if self.big else 4):
            return ent.field[:size]
        (off,) = struct.unpack(self.e + ("Q" if self.big else "I"), ent.field)
        if off + size > len(self.data):
            return None
        return self.data[off: off + size]

    def ints(self, ent: _Entry, limit: int | None = None) -> list | str:
        """Integer values (at most ``limit``), or the error's name: "type",
        "io", "range"."""
        code = _INT_CODES.get(ent.type)
        if code is None:
            return "type"
        if _WIDTH[ent.type] * ent.count >= 1 << 64:
            return "io"  # EvaluateIFDdatasizeReading: "Too large IFD data size"
        count = ent.count if limit is None else min(ent.count, limit)
        whole = self.raw(ent, count)
        if whole is None:
            return "io"
        vals = list(struct.unpack(self.e + code * count, whole))
        if ent.type in (6, 8, 9, 17) and any(v < 0 for v in vals):
            return "range"
        return vals

    def one(self, ent: _Entry, top: int) -> int | str:
        """One value up to ``top`` (TIFFReadDirEntryShort / Long)."""
        if ent.count != 1:
            return "count" if ent.type in _INT_CODES else "type"
        v = self.ints(ent)
        if isinstance(v, str):
            return v
        return v[0] if v[0] <= top else "range"

    def floats(self, ent: _Entry) -> list | str:
        """float32 values as TIFFReadDirEntryFloatArray gives them (a
        rational of denominator 0 is 0, a double clamped to float's range),
        or the error's name."""
        if ent.type not in _FLOAT_CODES and ent.type not in (5, 10):
            return "type"
        if _WIDTH[ent.type] * ent.count >= 1 << 64:
            return "io"
        whole = self.raw(ent)
        if whole is None:
            return "io"
        if ent.type in (5, 10):
            pairs = struct.unpack(self.e + ("II" if ent.type == 5 else "iI") * ent.count, whole)
            return [np.float32(0) if den == 0 else np.float32(num) / np.float32(den)
                    for num, den in zip(pairs[::2], pairs[1::2])]
        vals = struct.unpack(self.e + _FLOAT_CODES[ent.type] * ent.count, whole)
        if ent.type == 12:
            vals = [min(max(v, -_FLT_MAX), _FLT_MAX) if v == v else v for v in vals]
        return [np.float32(v) for v in vals]


class _Dir:
    """IFD0's fields after libtiff's TIFFReadDirectory."""

    def __init__(self, data: bytes):
        if len(data) < 8 or data[:2] not in (b"II", b"MM"):
            _refuse("not a TIFF file")
        e = "<" if data[:2] == b"II" else ">"
        (version,) = struct.unpack(e + "H", data[2:4])
        big = version == 43
        if version not in (42, 43):
            _refuse(f"not a TIFF file, bad version number {version}")
        if big:
            if len(data) < 16:
                _refuse("cannot read the BigTIFF header")
            offsize, unused, ifd = struct.unpack(e + "HHQ", data[4:16])
            if offsize != 8 or unused != 0:
                _refuse("not a TIFF file, bad BigTIFF header")
        else:
            (ifd,) = struct.unpack(e + "I", data[4:8])
        self.f = f = _File(data, e, big)
        self.swab = (e == ">") != _HOST_SWAPS
        entries = self._fetch(ifd)
        by_tag = {}
        for ent in entries:  # a repeated tag's later entries are ignored
            by_tag.setdefault(ent.tag, ent)
        self.tags = by_tag
        self.filesize = len(data)
        self.entries = entries

        # Defaults (TIFFDefaultDirectory).
        self.width = self.height = 0
        self.bits = 1
        self.spp = 1
        self.compression = 1
        self.photometric = None
        self.planar = 1
        self.rps = 0xFFFFFFFF
        self.rps_set = False
        self.tile = None  # (width, length)
        self.extrasamples, self.sampleinfo = 0, []
        self.sampleformat = 1
        self.orientation = 1
        self.fillorder = 1
        self.inkset = 1
        self.predictor = 1
        self.colormap = None
        self.jpeg_tables = None
        self.ycbcr_sampling = (2, 2)
        self.ycbcr_coefficients = None  # the defaults of TIFFGetFieldDefaulted where None
        self.reference_black_white = None
        sampling_set = False

        # SamplesPerPixel, then Compression, before the other tags.
        if 277 in by_tag:
            v = f.one(by_tag[277], 0xFFFF)
            if isinstance(v, str) or v == 0:
                _refuse("bad SamplesPerPixel")
            self.spp = v
        if 259 in by_tag:
            v = self._persample(by_tag[259])
            if isinstance(v, str):
                _refuse("bad Compression tag")
            self.compression = v
        # First pass: the tags that size the data structures.
        dims = set()
        for tag in (256, 257, 322, 323, 284, 278, 338, 32997, 32998):
            if tag not in by_tag:
                continue
            ent = by_tag[tag]
            if tag == 338:
                self._extrasamples(ent)
                continue
            if tag in (32997, 32998):  # ImageDepth, TileDepth
                v = f.one(ent, 0xFFFFFFFF)
                if isinstance(v, str) or (tag == 32998 and v == 0):
                    _refuse(f"bad tag {tag}")
                if v != 1:
                    raise ValueError("a TIFF of more than one image plane (ImageDepth, TileDepth) "
                                     "is not read yet")
                continue
            v = f.one(ent, 0xFFFF if tag == 284 else 0xFFFFFFFF)
            if isinstance(v, str):
                _refuse(f"bad tag {tag}")
            if tag == 256:
                self.width = v
                dims.add("image")
            elif tag == 257:
                self.height = v
                dims.add("image")
            elif tag in (322, 323):
                t = list(self.tile or (0, 0))
                t[tag - 322] = v
                self.tile = tuple(t)
            elif tag == 284:
                if v not in (1, 2):
                    _refuse("bad PlanarConfiguration")
                self.planar = v
            elif tag == 278:
                if v == 0:
                    _refuse("RowsPerStrip of zero")
                self.rps, self.rps_set = v, True
        if "image" not in dims:
            _refuse('missing required "ImageLength" field')
        if self.tile is not None and 0 in self.tile and (322 not in by_tag or 323 not in by_tag):
            raise ValueError("a TIFF with only one of TileWidth and TileLength is not read yet")
        # Second pass.
        for ent in entries:
            tag = ent.tag
            if by_tag[tag] is not ent:
                continue
            if tag in (258, 339, 280, 281, 32996):  # refused where they do not read
                v = self._persample(ent)
                if isinstance(v, str):
                    _refuse(f"bad tag {tag}")
                if tag == 258:
                    self.bits = v
                elif tag == 339:
                    if not 1 <= v <= 6:
                        _refuse("bad SampleFormat")
                    self.sampleformat = v
                elif tag == 32996:  # DataType: SampleFormat by its old name
                    if v > 3:
                        _refuse("bad DataType")
                    self.sampleformat = (4, 2, 1, 3)[v]
            elif tag in (340, 341):  # SMinSampleValue, SMaxSampleValue
                numeric = ent.type in _INT_CODES or ent.type in (5, 10, 11, 12)
                if (ent.count != self.spp or not numeric or _WIDTH[ent.type] * ent.count >= 1 << 64
                        or f.raw(ent) is None):
                    _refuse(f"bad tag {tag}")
            elif tag == 262:
                v = f.one(ent, 0xFFFF)
                if not isinstance(v, str):
                    self.photometric = v
            elif tag == 274:
                v = f.one(ent, 0xFFFF)
                if not isinstance(v, str) and 1 <= v <= 8:
                    self.orientation = v
            elif tag == 266:
                v = f.one(ent, 0xFFFF)
                if not isinstance(v, str) and v in (1, 2):
                    self.fillorder = v
            elif tag == 332:
                v = f.one(ent, 0xFFFF)
                if not isinstance(v, str):
                    self.inkset = v
            elif tag == 317 and self.compression in (5, 8, 32946):
                v = f.one(ent, 0xFFFF)
                if not isinstance(v, str):
                    self.predictor = v
            elif tag == 347 and self.compression == 7 and ent.count:  # JPEGTables
                if ent.type in (1, 2, 7):
                    self.jpeg_tables = f.raw(ent)
                else:  # read as bytes where every value is one, else ignored
                    v = f.ints(ent)
                    if not isinstance(v, str) and max(v) <= 255:
                        self.jpeg_tables = bytes(v)
            elif tag == 530 and ent.count == 2:  # YCbCrSubsampling
                v = f.ints(ent)
                if not isinstance(v, str) and max(v) <= 0xFFFF:
                    self.ycbcr_sampling, sampling_set = tuple(v), True
            elif tag in (529, 532) and ent.count == (3 if tag == 529 else 6):
                v = f.floats(ent)  # a count other than the tag's is ignored
                if not isinstance(v, str):
                    if tag == 529:
                        self.ycbcr_coefficients = v
                    else:
                        self.reference_black_white = v
        # Strips or tiles.
        tiled = self.tile is not None
        if tiled:
            tw, tl = self.tile
            tw = self.width if tw == 0xFFFFFFFF else tw
            tl = self.height if tl == 0xFFFFFFFF else tl
            n = 0 if tw == 0 or tl == 0 else -(-self.width // tw) * -(-self.height // tl)
            self.tile = (tw, tl)
        else:
            n = 1 if self.rps == 0xFFFFFFFF else -(-self.height // self.rps)
        if self.planar == 2:
            n *= self.spp
        if n == 0:
            _refuse(f"cannot handle zero number of {'tiles' if tiled else 'strips'}")
        self.nblocks = n
        offsets_tag, counts_tag = (324, 325) if tiled else (273, 279)
        if offsets_tag not in by_tag:
            _refuse(f"missing required {'TileOffsets' if tiled else 'StripOffsets'} field")
        self.offsets = self._strip_thing(by_tag[offsets_tag], n)
        self.counts = self._strip_thing(by_tag[counts_tag], n) if counts_tag in by_tag else None
        if 320 in by_tag and self.bits <= 16:
            ent = by_tag[320]
            need = 3 * (1 << self.bits)
            v = f.ints(ent) if ent.count == need else "count"  # else ignored
            if not isinstance(v, str) and max(v) <= 0xFFFF:
                self.colormap = np.array(v, np.int64).reshape(3, -1)
        if self.photometric is not None:
            # Non-colour samples are extra samples (unspecified).
            color = _MAX_COLOR.get(self.photometric, 0)
            if color and self.spp - self.extrasamples > color:
                extra = self.spp - color
                self.sampleinfo = (self.sampleinfo + [0] * extra)[:extra]
                self.extrasamples = extra
            if self.photometric == 3 and self.colormap is None:
                if self.bits >= 8 and self.spp == 3:
                    self.photometric = 2
                elif self.bits >= 8:
                    self.photometric = 1
                else:
                    _refuse('missing required "Colormap" field')
        self._fix_counts(tiled)
        if (self.compression == 7 and self.photometric == 6 and self.planar == 1
                and self.spp == 3 and not sampling_set):
            self._fix_sampling()

    def _fix_sampling(self) -> None:
        """libtiff's JPEGFixupTagsSubsampling: with no YCbCrSubsampling tag,
        the first strip's or tile's frame header gives it, where its first
        component's factors are 1, 2 or 4 and the others' 1."""
        start = self.offsets[0]
        if start == 0:
            return
        block = self.f.data[start: start + self.counts[0]]
        pos, n = 0, len(block)
        while True:
            while pos < n and block[pos] != 0xFF:
                pos += 1
            while pos < n and block[pos] == 0xFF:
                pos += 1
            if pos >= n:
                return
            m, pos = block[pos], pos + 1
            if m == 0xD8:
                continue
            if pos + 2 > n:
                return
            (length,) = struct.unpack(">H", block[pos: pos + 2])
            if m in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
                if length != 8 + 3 * self.spp or pos + length > n:
                    return
                factors = block[pos + 9: pos + length: 3]
                hs, vs = factors[0] >> 4, factors[0] & 15
                if any(f != 0x11 for f in factors[1:]) or hs not in (1, 2, 4) or vs not in (1, 2, 4):
                    return
                self.ycbcr_sampling = (hs, vs)
                return
            if not (0xE0 <= m <= 0xEF or m in (0xFE, 0xDB, 0xDA, 0xC4, 0xDD)) or length < 2:
                return
            pos += length

    def _fetch(self, ifd: int) -> list:
        f, data = self.f, self.f.data
        head, esize = (8, 20) if f.big else (2, 12)
        if ifd == 0 or ifd + head > len(data):
            _refuse("cannot read the TIFF directory")
        (n,) = struct.unpack(f.e + ("Q" if f.big else "H"), data[ifd: ifd + head])
        if n > 4096:
            _refuse("sanity check on the directory count failed")
        if ifd + head + n * esize > len(data):
            _refuse("cannot read the TIFF directory")
        out = []
        for k in range(n):
            at = ifd + head + k * esize
            if f.big:
                tag, typ, count = struct.unpack(f.e + "HHQ", data[at: at + 12])
                field = data[at + 12: at + 20]
            else:
                tag, typ, count = struct.unpack(f.e + "HHI", data[at: at + 8])
                field = data[at + 8: at + 12]
            out.append(_Entry(tag, typ, count, field))
        return out

    def _persample(self, ent: _Entry):
        """TIFFReadDirEntryShort, else TIFFReadDirEntryPersampleShort."""
        v = self.f.one(ent, 0xFFFF)
        if v != "count":
            return v
        if ent.count < self.spp:
            return "count"
        vals = self.f.ints(ent)
        if isinstance(vals, str):
            return vals
        if any(x > 0xFFFF for x in vals[: self.spp]):
            return "range"
        if len(set(vals[: self.spp])) != 1:
            return "psdif"
        return vals[0]

    def _extrasamples(self, ent: _Entry) -> None:
        vals = self.f.ints(ent)
        if isinstance(vals, str) or ent.type not in (1, 3, 4, 6, 8, 9, 16, 17):
            _refuse("bad ExtraSamples")
        if any(v > 0xFFFF for v in vals):
            _refuse("bad ExtraSamples")
        vals = [2 if v == 999 else v for v in vals]
        if len(vals) > self.spp or any(v > 2 for v in vals):
            _refuse("bad ExtraSamples")
        self.extrasamples, self.sampleinfo = len(vals), vals

    def _strip_thing(self, ent: _Entry, n: int) -> list:
        if ent.type not in _INT_CODES:
            _refuse("bad strip or tile array type")
        vals = self.f.ints(ent, limit=n)
        if isinstance(vals, str):
            _refuse("cannot read the strip or tile arrays")
        if len(vals) < n and n > 1_000_000:  # libtiff pads a short array up to 10^6
            _refuse(f"a strip or tile array of {len(vals)} for {n} blocks")
        return vals + [0] * (n - len(vals))

    def _fix_counts(self, tiled: bool) -> None:
        """libtiff's fixes of missing or bad byte counts, and its chop of
        one uncompressed strip into strips of about 8 KiB."""
        contig = self.planar == 1
        if self.counts is None:
            if (contig and self.nblocks > 1) or (not contig and self.nblocks != self.spp):
                _refuse('missing required "StripByteCounts" field')
            self._estimate(tiled)
        elif self.nblocks == 1 and not tiled and self._count_looks_bad():
            self._estimate(tiled)
        elif (contig and self.nblocks > 2 and self.compression == 1
              and self.counts[0] != self.counts[1] and self.counts[0] and self.counts[1]):
            self._estimate(tiled)
        # Under OpenCV, libtiff chops only a strip of the whole image whose
        # RowsPerStrip is not past the image's end (or is unset, 2^32 - 1).
        if (contig and self.nblocks == 1 and self.compression == 1 and not tiled
                and (self.rps <= self.height or self.rps == 0xFFFFFFFF)):
            self._chop()

    def packed_ycbcr(self) -> bool:
        """YCbCr stored in blocks of hs x vs luma samples and their Cb and
        Cr, which libtiff's sizes count in blocks: three samples in
        contiguous planes, not JPEG-compressed (the JPEG codec upsamples)."""
        return self.planar == 1 and self.photometric == 6 and self.spp == 3 and self.compression != 7

    def _block_rows(self, width: int, nrows: int) -> int:
        """Bytes of the rows of sampling blocks that cover width x nrows
        pixels (TIFFVStripSize64's packed YCbCr; 0 where the subsampling is
        not 1, 2 or 4, where libtiff's size is 0)."""
        hs, vs = self.ycbcr_sampling
        if hs not in (1, 2, 4) or vs not in (1, 2, 4):
            return 0
        row = (-(-width // hs) * (hs * vs + 2) * self.bits + 7) // 8
        return row * -(-nrows // vs)

    def scanline(self) -> int:
        """TIFFScanlineSize64: packed YCbCr's one row of blocks over vs."""
        if self.packed_ycbcr():
            return self._block_rows(self.width, 1) // self.ycbcr_sampling[1]
        spp = self.spp if self.planar == 1 else 1
        return (self.width * spp * self.bits + 7) // 8

    def strip_size(self, nrows: int) -> int:
        """TIFFVStripSize64."""
        if self.packed_ycbcr():
            return self._block_rows(self.width, nrows)
        return nrows * self.scanline()

    def tile_size(self, nrows: int) -> int:
        """TIFFVTileSize64 (a tile's rows of TIFFTileRowSize64 bytes, which
        counts 3 samples a pixel for packed YCbCr too)."""
        tw = self.tile[0]
        if self.packed_ycbcr():
            return self._block_rows(tw, nrows)
        spp = self.spp if self.planar == 1 else 1
        return nrows * ((tw * spp * self.bits + 7) // 8)

    def _count_looks_bad(self) -> bool:
        count, offset = self.counts[0], self.offsets[0]
        if offset == 0:
            return False
        if count == 0:
            return True
        if self.compression != 1:
            return False
        if offset <= self.filesize and count > self.filesize - offset:
            return True
        return count < self.scanline() * self.height

    def _estimate(self, tiled: bool) -> None:
        """EstimateStripByteCounts."""
        if self.compression != 1:
            # The file's size less the header, the directory and the values
            # stored outside it, for every strip; the last cut at the end.
            n = len(self.entries)
            space = (16 + 8 + 20 * n + 8) if self.f.big else (8 + 2 + 12 * n + 4)
            for ent in self.entries:
                width = _WIDTH.get(ent.type)
                if width is None:
                    _refuse(f"cannot determine the size of tag type {ent.type}")
                size = width * ent.count
                space += size if size > (8 if self.f.big else 4) else 0
                if space >= 1 << 64:
                    _refuse("too large IFD data size")
            space = self.filesize - space if self.filesize >= space else self.filesize
            if self.planar == 2:
                space //= self.spp
            self.counts = [space] * self.nblocks
            last = self.offsets[-1]
            if last + space > self.filesize:
                self.counts[-1] = 0 if last >= self.filesize else self.filesize - last
        elif tiled:
            self.counts = [self.tile_size(self.tile[1])] * self.nblocks
        else:
            per_image = self.nblocks // (self.spp if self.planar == 2 else 1)
            rows = self.height // per_image
            self.counts = [self.scanline() * rows] * self.nblocks
        if not self.rps_set:
            self.rps = self.height

    def _chop(self) -> None:
        # Whole rows of sampling blocks for packed YCbCr, else rows.
        rowblock = self.ycbcr_sampling[1] if self.packed_ycbcr() else 1
        rowbytes = self.strip_size(rowblock)
        if rowbytes == 0:
            return
        if rowbytes > STRIP_SIZE_DEFAULT:
            stripbytes, rps = rowbytes, rowblock
        else:
            rps = STRIP_SIZE_DEFAULT // rowbytes * rowblock
            stripbytes = STRIP_SIZE_DEFAULT // rowbytes * rowbytes
        if rps >= min(self.rps, 0xFFFFFFFF) or rps == 0:
            return
        nstrips = -(-self.height // rps)
        if nstrips == 0:
            return
        offset = self.offsets[0]
        if nstrips > 1_000_000 and (offset >= self.filesize
                                    or stripbytes > (self.filesize - offset) // (nstrips - 1)):
            return
        bytecount = self.offsets[-1] + self.counts[-1] - offset
        if bytecount < 0:
            return
        counts, offsets = [], []
        for _ in range(nstrips):
            stripbytes = min(stripbytes, bytecount)
            counts.append(stripbytes)
            offsets.append(offset if stripbytes else 0)
            offset += stripbytes
            bytecount -= stripbytes
        self.counts, self.offsets = counts, offsets
        self.nblocks, self.rps, self.rps_set = nstrips, rps, True


class _Reader:
    """Reads, decompresses and undoes the predictor of one strip or tile, as
    libtiff's TIFFFillStrip / TIFFFillTile and the codecs do."""

    def __init__(self, d: _Dir, data: bytes):
        self.d, self.data = d, data
        self.lzw_checked = False
        self.jpeg = _JpegCodec(d) if d.compression == 7 else None

    def raw(self, k: int, tiled: bool, block_size: int) -> bytes:
        """Block k's bytes, or _Refused where libtiff cannot read them."""
        d = self.d
        count, offset = d.counts[k], d.offsets[k]
        if count == 0:
            raise _Refused(f"invalid byte count 0, block {k}")
        if count > 1024 * 1024 and block_size and (count - 4096) // 10 > block_size:
            count = block_size * 10 + 4096
        if offset + count > len(self.data):
            raise _Refused(f"read error on block {k}")
        if tiled:  # libtiff's checks of a tile's count, rounded up to 1 KiB
            rounded = -(-count // 1024) * 1024
            if d.compression == 1 and rounded != block_size:
                raise _Refused(f"invalid tile byte count for tile {k}")
            if d.compression != 1 and block_size > 100_000_000 and 1000 * rounded < block_size:
                raise _Refused(f"likely invalid tile byte count for tile {k}")
        raw = self.data[offset: offset + count]
        if d.fillorder == 2 and d.compression != 7:  # the JPEG codec sets TIFF_NOBITREV
            return _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
        return raw

    def uncompressed_plane(self, k: int, out: np.ndarray) -> None:
        """TIFFReadEncodedStrip's shortcut for an uncompressed strip read
        into a caller's buffer (the later planes of separate strips): the
        strip's size is read at its offset whatever its byte count says;
        what a short read gets stays, without the bit order or byte swap."""
        d, offset = self.d, self.d.offsets[k]
        got = self.data[offset: offset + len(out)] if offset <= len(self.data) else b""
        out[: len(got)] = np.frombuffer(got, np.uint8)
        if len(got) == len(out):
            if d.fillorder == 2:
                out[:] = _REVERSED[out]
            TIFF_DECODE.fn("radnet_tiff_postdecode")(out.ctypes.data, len(out), len(out), d.bits,
                                                       1, 1, int(d.swab))

    def decode(self, raw: bytes, out: np.ndarray, rowsize: int, y: int = 0) -> None:
        """Decode into out (zeroed, its length the bytes wanted), then the
        predictor and byte swap where the decode succeeded.  y: the block's
        first row, which the JPEG codec checks a strip's stream against;
        where it refuses the stream, _Refused."""
        d = self.d
        occ = len(out)
        ptr = out.ctypes.data
        if d.compression == 7:
            self.jpeg.decode(raw, out, rowsize, y)
            return
        if d.compression == 1:
            ok = len(raw) >= occ
            if ok:
                out[:] = np.frombuffer(raw, np.uint8, occ)
        elif d.compression == 5:
            if not self.lzw_checked:
                self.lzw_checked = True
                if len(raw) >= 2 and raw[0] == 0 and raw[1] & 1:
                    raise ValueError("old-style (pre-TIFF 6.0, bit-reversed) LZW is not read yet")
            ok = TIFF_DECODE.fn("radnet_tiff_lzw")(raw, len(raw), ptr, occ) == 1
        elif d.compression == 32773:
            ok = TIFF_DECODE.fn("radnet_tiff_packbits")(raw, len(raw), ptr, occ) == 1
        elif d.compression in (8, 32946):
            got, ok = _inflate(raw, occ)
            out[: len(got)] = np.frombuffer(got, np.uint8)
        else:
            ok = False  # a codec libtiff does not know: "not implemented"
        if ok:
            predictor = d.predictor if d.compression in (5, 8, 32946) else 1
            stride = d.spp if d.planar == 1 else 1
            TIFF_DECODE.fn("radnet_tiff_postdecode")(ptr, occ, rowsize, d.bits, stride, predictor,
                                                       int(d.swab))


class _JpegCodec:
    """libtiff's JPEG codec (tif_jpeg.c) as TIFFReadRGBAStrip and
    TIFFReadRGBATile drive it: one libjpeg decompressor for the file, whose
    table slots JPEGTables fills first (JPEGSetupDecode) and each stream's
    own tables then replace; JPEGPreDecode's checks of each strip's or
    tile's frame; JPEGDecode's rows, YCbCr converted to R, G, B by libjpeg
    (JPEGCOLORMODE_RGB, which TIFFRGBAImageBegin sets for contiguous YCbCr)
    and other samples as they are."""

    def __init__(self, d: _Dir):
        self.d = d
        self.tables = jpeg.Tables()
        self.set_up = False
        self.contig = d.planar == 1 or d.spp == 1
        self.ycbcr = d.photometric == 6 and self.contig
        # JPEGSetupDecode: YCbCr's sampling from its tag, none for the rest;
        # JPEGPreDecode holds a separate plane's one component to 1, 1.
        self.sampling = d.ycbcr_sampling if self.ycbcr else (1, 1)

    def decode(self, raw: bytes, out: np.ndarray, rowsize: int, y: int) -> None:
        d = self.d
        try:
            if not self.set_up:
                if d.jpeg_tables is not None:
                    jpeg.read_tables(self.tables, d.jpeg_tables)
                self.set_up = True
            if d.tile is not None:
                seg_w, seg_h = d.tile
            else:
                seg_w, seg_h = d.width, min(d.rps, d.height - y)
            last_strip = d.tile is None and y + seg_h == d.height
            ncomp = d.spp if self.contig else 1

            def check(frame) -> None:
                w, h, n = frame.width, frame.height, len(frame.ids)
                if (w > seg_w or h > seg_h) and not (w == seg_w and last_strip):
                    raise jpeg.JpegError("JPEG strip/tile size exceeds expected dimensions")
                if n != ncomp:
                    raise jpeg.JpegError("Improper JPEG component count")
                if d.bits != 8:
                    raise jpeg.JpegError("Improper JPEG data precision")
                if (frame.h[0], frame.v[0]) != self.sampling or any(
                        (hs, vs) != (1, 1) for hs, vs in zip(frame.h[1:], frame.v[1:])):
                    raise jpeg.JpegError("Improper JPEG sampling factors")
                if self.ycbcr and n != 3:
                    raise jpeg.JpegError("bogus colour space for YCbCr")

            jpeg.decode_tiff_stream(self.tables, raw, check, jpeg.YCC_RGB if self.ycbcr else
                                    jpeg.AS_IS, out, rowsize, len(out) // rowsize)
        except jpeg.JpegError as e:
            raise _Refused(f"JPEG strip or tile: {e}") from None


def _inflate(raw: bytes, occ: int) -> tuple[bytes, bool]:
    """The first occ bytes a zlib stream inflates to, as libtiff's ZIPDecode
    leaves them: (bytes, whether all occ came out with no zlib error).  zlib
    writes every symbol decoded before a bad one, which the zlib module
    drops when it raises: then :func:`_inflate_to_error` finds them."""
    try:
        got = zlib.decompressobj().decompress(raw, occ)
    except zlib.error:
        return _inflate_to_error(raw, occ), False
    return got, len(got) == occ


_LEN_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59, 67, 83, 99,
             115, 131, 163, 195, 227, 258]
_LEN_EXTRA = [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0]
_DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513, 769, 1025,
              1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577]
_DIST_EXTRA = [0, 0, 0, 0] + [k for k in range(1, 14) for _ in (0, 1)]
_CL_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]


class _ZlibStop(Exception):
    """Where zlib's inflate reports an error, or the input ends."""


def _huffman(lengths: list, kind: str):
    """(counts, symbols) of a canonical code, or _ZlibStop where zlib's
    inflate_table refuses it: over-subscribed, or incomplete unless it is one
    code of one bit ("codes" must be complete)."""
    counts = [0] * 16
    for n in lengths:
        counts[n] += 1
    counts[0] = 0
    left, top = 1, max(lengths) if lengths else 0
    for n in range(1, 16):
        left = 2 * left - counts[n]
        if left < 0:
            raise _ZlibStop
    if top and left > 0 and (kind == "codes" or top != 1):
        raise _ZlibStop
    offs = [0] * 16
    for n in range(1, 15):
        offs[n + 1] = offs[n] + counts[n]
    symbols = [0] * len(lengths)
    for sym, n in enumerate(lengths):
        if n:
            symbols[offs[n]] = sym
            offs[n] += 1
    return counts, symbols


def _inflate_to_error(raw: bytes, occ: int) -> bytes:
    """Inflate symbol by symbol, stopping where zlib's inflate reports an
    error (its checks: the zlib header, block types, stored lengths, code
    sets, repeats, codes 286-287 and 30-31, distances past the output) or the
    input ends: the bytes zlib has written by then, at most occ."""
    out = bytearray()
    state = {"pos": 2 * 8}

    def bits(n):
        pos = state["pos"]
        if pos + n > 8 * len(raw):
            raise _ZlibStop
        v = 0
        for k in range(n):
            v |= ((raw[(pos + k) >> 3] >> ((pos + k) & 7)) & 1) << k
        state["pos"] = pos + n
        return v

    def decode(code):
        counts, symbols = code
        c = first = index = 0
        for n in range(1, 16):
            c |= bits(1)
            count = counts[n]
            if c - count < first:
                return symbols[index + (c - first)]
            index += count
            first = (first + count) << 1
            c <<= 1
        raise _ZlibStop  # an unused code of an incomplete set

    def emit(b):
        out.append(b)
        if len(out) >= occ:
            raise _ZlibStop

    if (len(raw) < 2 or (raw[0] * 256 + raw[1]) % 31 or raw[0] & 15 != 8 or raw[0] >> 4 > 7
            or raw[1] & 0x20):  # the zlib header: check, method, window, no dictionary
        return b""
    try:
        while True:
            last, typ = bits(1), bits(2)
            if typ == 0:
                state["pos"] = -(-state["pos"] // 8) * 8
                n, nn = bits(16), bits(16)
                if n != nn ^ 0xFFFF:
                    raise _ZlibStop
                for _ in range(n):
                    emit(bits(8))
            elif typ == 3:
                raise _ZlibStop
            else:
                if typ == 1:
                    lit = _huffman([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8, "lens")
                    dist = _huffman([5] * 32, "dists")
                else:
                    nlen, ndist, ncode = bits(5) + 257, bits(5) + 1, bits(4) + 4
                    if nlen > 286 or ndist > 30:
                        raise _ZlibStop
                    cl = [0] * 19
                    for k in range(ncode):
                        cl[_CL_ORDER[k]] = bits(3)
                    clcode = _huffman(cl, "codes")
                    lens = []
                    while len(lens) < nlen + ndist:
                        sym = decode(clcode)
                        if sym < 16:
                            lens.append(sym)
                            continue
                        if sym == 16:
                            if not lens:
                                raise _ZlibStop
                            val, rep = lens[-1], 3 + bits(2)
                        else:
                            val, rep = 0, (3 + bits(3)) if sym == 17 else (11 + bits(7))
                        if len(lens) + rep > nlen + ndist:
                            raise _ZlibStop
                        lens += [val] * rep
                    if lens[256] == 0:
                        raise _ZlibStop
                    lit = _huffman(lens[:nlen], "lens")
                    dist = _huffman(lens[nlen:], "dists")
                while True:
                    sym = decode(lit)
                    if sym < 256:
                        emit(sym)
                    elif sym == 256:
                        break
                    else:
                        sym -= 257
                        if sym >= 29:
                            raise _ZlibStop
                        length = _LEN_BASE[sym] + bits(_LEN_EXTRA[sym])
                        dsym = decode(dist)
                        if dsym >= 30:
                            raise _ZlibStop
                        d = _DIST_BASE[dsym] + bits(_DIST_EXTRA[dsym])
                        if d > len(out):
                            raise _ZlibStop
                        for _ in range(length):
                            emit(out[-d])
            if last:
                break
    except _ZlibStop:
        pass
    return bytes(out[:occ])


def _ycbcr_tables(d: _Dir) -> np.ndarray:
    """TIFFYCbCrToRGBInit's tables (tif_color.c), float arithmetic in
    float32 as there, from YCbCrCoefficients and ReferenceBlackWhite or
    their defaults: Y_tab, Cr_r_tab, Cb_b_tab, Cr_g_tab, Cb_g_tab as int32
    (5, 256).  _Refused where initYCbCrConversion refuses the tags."""
    f32 = np.float32
    luma = d.ycbcr_coefficients or [f32(0.299), f32(0.587), f32(0.114)]
    rbw = d.reference_black_white or [f32(v) for v in (0, 255, 128, 255, 128, 255)]
    if np.isnan(luma[0]) or np.isnan(luma[1]) or luma[1] == 0 or np.isnan(luma[2]):
        _refuse("invalid values for YCbCrCoefficients")
    if not all(-2147483520 < v <= 2147483520 for v in rbw):  # NaN fails too
        _refuse("invalid values for ReferenceBlackWhite")

    # The C casts to int32 truncate: every value cast fits, the bounds above
    # and the clamps below see to it.
    def fix(f):  # FIX(CLAMP(f, 0, 2)), NaN to 0
        f = f if f >= 0 else f32(0)
        f = f32(2) if f > 2 else f
        return int(np.float64(f * f32(65536)) + 0.5)

    def code2v(c, rb, rw, cr):  # Code2V, then CLAMPw to +-4096 and the cast to int32
        num = (c - int(rb)).astype(np.float32) * f32(cr)
        den = f32(rw - rb)
        v = num / (den if den != 0 else f32(1))
        return np.trunc(np.where(~(v >= -4096), -4096, np.where(v > 4096, 4096, v))).astype(np.int64)

    with np.errstate(all="ignore"):
        lr, lg, lb = (f32(v) for v in luma)
        f1, f3 = f32(2) - f32(2) * lr, f32(2) - f32(2) * lb
        d1, d2, d3, d4 = fix(f1), -fix(lr * f1 / lg), fix(f3), -fix(lb * f3 / lg)
        x = np.arange(-128, 128, dtype=np.int64)
        cr = code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127)
        cb = code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127)
        y_tab = code2v(x + 128, rbw[0], rbw[1], 255)
    return np.stack([y_tab, (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16, d2 * cr,
                     d4 * cb + 32768]).astype(np.int32)


def _tables(d: _Dir):
    """(mode, alpha, table) of radnet_tiff_put for TIFFRGBAImageBegin's
    choice of put routine (mode 3: radnet_tiff_put_ycbcr, table its
    conversion tables); _Refused where it has none."""
    ph, bits, contig = d.photometric, d.bits, d.planar == 1 or d.spp == 1
    alpha = 0
    if d.extrasamples >= 1:
        info = d.sampleinfo[0]
        if info == 0:
            alpha = 1 if d.spp > 3 else 0
        else:
            alpha = info
    if d.extrasamples == 0 and d.spp == 4 and ph == 2:
        alpha = 1  # DEFAULT_EXTRASAMPLE_AS_ALPHA
    table = np.zeros((256, 3), np.uint8)
    if ph == 6 and d.compression == 7 and contig:  # converted by libjpeg: RGB's put
        if d.spp < 3:
            _refuse("can not handle format")
        return 1, 0, table
    if ph == 6:  # PickContigCase / PickSeparateCase: 8 bits, 3 samples
        if bits != 8 or d.spp != 3:
            _refuse("can not handle YCbCr of other than 3 samples of 8 bits")
        if d.ycbcr_sampling not in (_YCBCR_PUTS if contig else {(1, 1)}):
            _refuse(f"can not handle YCbCr subsampling {d.ycbcr_sampling}"
                    + ("" if contig else " in separate planes"))
        return 3, 0, _ycbcr_tables(d)
    if ph in (0, 1, 3):
        if contig and d.spp != 1 and bits < 8:
            _refuse("can not handle contiguous data with Bits/Sample below 8")
    if ph == 2 and d.spp - d.extrasamples < 3:
        _refuse("can not handle RGB image with fewer than 3 colour channels")
    if ph == 5 and (d.inkset != 1 or d.spp < 4):
        _refuse("can not handle this separated image")
    if not contig:
        if ph in (0, 1, 2) and bits in (8, 16):
            return 1, alpha, table
        if ph == 5 and bits == 8 and d.spp == 4:
            return 2, 0, table
        _refuse("can not handle image")
    if ph == 2 and bits in (8, 16) and d.spp >= 3:
        return 1, alpha, table
    if ph == 5 and bits == 8:
        return 2, 0, table
    if ph in (0, 1) and bits in (1, 2, 4, 8, 16):
        rng = 255 if bits == 16 else (1 << bits) - 1
        x = np.arange(rng + 1)
        m = ((rng - x) * 255 // rng) if ph == 0 else (x * 255 // rng)
        table[: rng + 1] = m[:, None].astype(np.uint8)
        return 0, 0, table
    if ph == 3 and bits in (1, 2, 4, 8):
        cmap = d.colormap[:, : 1 << bits]
        if (cmap >= 256).any():
            cmap = cmap >> 8
        table[: 1 << bits] = (cmap.T & 0xFF).astype(np.uint8)
        return 0, 0, table
    _refuse("can not handle image")


def _check(d: _Dir) -> None:
    """OpenCV's readHeader and readData checks, then TIFFRGBAImageOK."""
    if d.photometric is None:
        _refuse("no Photometric tag (OpenCV requires it)")
    if d.sampleformat == 3 and d.bits in (16, 24, 32, 64):
        _refuse("floating-point samples (libtiff's RGBA interface reads none)")
    bits, fmt = (d.bits if 258 in d.tags else 1), d.sampleformat
    if bits in (1, 8):
        if fmt not in (1, 2):
            _refuse(f"OpenCV reads {bits}-bit samples only as integers")
    elif bits == 4:
        if d.photometric != 3:
            _refuse("bitsperpixel value is 4 should be palette")
        if fmt not in (1, 2):
            _refuse("OpenCV reads 4-bit samples only as integers")
    elif bits in (10, 12, 14, 16):
        if fmt not in (1, 2):
            _refuse(f"OpenCV reads {bits}-bit samples only as integers")
    elif bits == 32:
        if fmt not in (2, 3):
            _refuse("OpenCV reads 32-bit samples only as float or signed")
    elif bits == 64:
        if fmt != 3:
            _refuse("OpenCV reads 64-bit samples only as float")
    else:
        _refuse(f"invalid bitsperpixel value {bits}")
    check_image_size(d.width, d.height)
    if d.tile is not None:
        tw, tl = d.tile
    else:
        tw, tl = d.width, (d.rps if d.rps_set else 0)
        if tl == 0 or tl == 0xFFFFFFFF:
            tl = d.height
    if not (0 < tw <= 1 << 24 and 0 < tl <= 1 << 24):
        _refuse("tile size out of OpenCV's range")
    if d.spp > 4:
        _refuse("more than 4 samples a pixel")
    # TIFFRGBAImageOK
    if d.compression in _NOT_CONFIGURED:
        _refuse(f"{_NOT_CONFIGURED[d.compression]} compression support is not configured")
    if d.bits not in (1, 2, 4, 8, 16):
        _refuse(f"can not handle images with {d.bits}-bit samples")
    if d.sampleformat == 3:
        _refuse("can not handle images with IEEE floating-point samples")
    ph = d.photometric
    if ph in _PHOTOMETRIC_NOT_YET:
        raise ValueError(f"{_PHOTOMETRIC_NOT_YET[ph]} TIFF is not read yet")
    if ph not in (0, 1, 2, 3, 5, 6):
        _refuse(f"can not handle image with Photometric {ph}")
    if 4 * tw * tl >= 1 << 30:
        _refuse("buffer_size is too large: >= 1Gb")
    if d.compression in _NOT_YET:
        raise ValueError(f"{_NOT_YET[d.compression]}-compressed TIFF is not read yet")
    if d.sampleformat == 2:
        raise ValueError("TIFF of signed samples is not read yet")
    if d.compression in (5, 8, 32946):
        if d.predictor == 2 and d.bits not in (8, 16, 32, 64):
            _refuse(f'horizontal differencing "Predictor" not supported with {d.bits}-bit samples')
        if d.predictor == 3:
            raise ValueError("floating-point Predictor 3 is not read yet")
        if d.predictor not in (1, 2):
            _refuse(f'"Predictor" value {d.predictor} not supported')


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> BGR ``(H, W, 3)`` uint8, its Orientation tag applied as
    libtiff and OpenCV apply it: libtiff flips each strip or tile, OpenCV
    places them and then transposes orientations 5-8 (6 and 8 turned by 180
    degrees as well)."""
    try:
        d = _Dir(data)
        _check(d)
        mode, alpha, table = _tables(d)
        img = _read(d, data, mode, alpha, table)
    except _Refused as e:
        raise ValueError(f"TIFF that OpenCV does not read: {e}") from None
    if d.orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
        if d.orientation in (6, 8):
            img = img[::-1, ::-1]
        img = np.ascontiguousarray(img)
    return img


def _read(d: _Dir, data: bytes, mode: int, alpha: int, table: np.ndarray) -> np.ndarray:
    put = TIFF_DECODE.fn("radnet_tiff_put")
    h, w, spp = d.height, d.width, d.spp
    contig = d.planar == 1 or spp == 1
    bps = (d.bits + 7) // 8
    hflip = int(d.orientation in (2, 3, 6, 7))
    vflip = int(d.orientation in (3, 4, 7, 8))
    out = np.zeros((h, w, 3), np.uint8)
    reader = _Reader(d, data)
    tiled = d.tile is not None
    if tiled:
        bw, bl = d.tile
        across = -(-w // bw)
        per_plane = across * -(-h // bl)
    else:
        bw, bl = w, min(d.rps, h)
        across, per_plane = 1, -(-h // bl)
    row_bytes = (bw * (spp if contig else 1) * d.bits + 7) // 8
    packed = d.packed_ycbcr()
    if packed:  # TIFFTileSize / TIFFStripSize count rows of sampling blocks
        hs, vs = d.ycbcr_sampling
        block_size = d.tile_size(bl) if tiled else d.strip_size(bl)
    else:
        block_size = row_bytes * bl
    # A decoded row for the predictor and the JPEG codec: TIFFTileRowSize of
    # a tile, TIFFScanlineSize of a strip (a row of blocks over vs, packed).
    pred_row = row_bytes if tiled else d.scanline()
    # Separate planes: the colour planes, then alpha (grey's one plane three times).
    if contig:
        planes_read = [0]
    else:
        colour = 1 if d.photometric in (0, 1) else 3 if d.photometric in (2, 6) else 4
        planes_read = list(range(colour)) + ([colour] if alpha and mode == 1 else [])
    ptrs = (ctypes.c_void_p * 4)()
    if contig and not tiled and d.compression == 1 and not packed:
        # Uncompressed strips: each read whole or, if its count is short,
        # left zero (DumpModeDecode); then put as one block.
        parts = []
        for k in range(-(-h // bl)):
            raw, size = reader.raw(k, False, block_size), row_bytes * min(bl, h - k * bl)
            parts.append(raw[:size] if len(raw) >= size else bytes(size))
        buf = np.frombuffer(b"".join(parts), np.uint8).copy()
        TIFF_DECODE.fn("radnet_tiff_postdecode")(buf.ctypes.data, len(buf), row_bytes, d.bits, 1, 1,
                                                   int(d.swab))
        for c in range(4):
            ptrs[c] = buf.ctypes.data + min(c, spp - 1) * bps
        put(ptrs, spp * bps, row_bytes, d.bits, mode, alpha, table.ctypes.data, w, h, 0, 0, hflip,
            vflip, out.ctypes.data, w, h)
        return out
    for y in range(0, h, bl):
        nrow = min(bl, h - y)
        for x in range(0, w, bw):
            ncol = min(bw, w - x)
            k = (y // bl) * across + x // bw
            if tiled:
                size = block_size
            elif packed:  # gtStripContig reads whole sampling rows, of its scanline size
                size = min(-(-nrow // vs) * vs * d.scanline(), d.strip_size(nrow))
            else:
                size = row_bytes * nrow
            bufs = []
            for p in planes_read:
                buf = np.zeros(block_size, np.uint8)
                bufs.append(buf)
                if p != planes_read[0] and not tiled and d.compression == 1:
                    reader.uncompressed_plane(k + p * per_plane, buf[:size])
                    continue
                try:
                    raw = reader.raw(k + p * per_plane, tiled, block_size)
                    reader.decode(raw, buf[:size], pred_row, y)
                except _Refused:
                    if p == planes_read[0]:
                        raise
                    continue  # TIFFReadEncodedStrip / TIFFReadTile fail: zeros
            if mode == 3:
                if contig:  # the put routine's step from a row of blocks to the next
                    ptrs[0], ptrs[1] = bufs[0].ctypes.data, None
                    bsize = hs * vs + 2
                    # putcontig8bitYCbCr44tile skips a clipped tile's rest at
                    # 10 bytes a block, its 4,2 sibling's size, not 18.
                    skip = 10 if (hs, vs) == (4, 4) else bsize
                    stride = -(-ncol // hs) * bsize + (bw - ncol) // hs * skip
                else:
                    for c in range(3):
                        ptrs[c] = bufs[c].ctypes.data
                    stride = row_bytes
                TIFF_DECODE.fn("radnet_tiff_put_ycbcr")(
                    ptrs, *(d.ycbcr_sampling if contig else (1, 1)), stride, table.ctypes.data,
                    ncol, nrow, x, y, hflip, vflip, out.ctypes.data, w, h)
                continue
            if contig:
                base = bufs[0].ctypes.data
                for c in range(4):
                    ptrs[c] = base + min(c, spp - 1) * bps
                step = spp * bps
            else:
                if d.photometric in (0, 1):
                    bufs = [bufs[0]] * 3 + bufs[1:]
                for c in range(4):
                    ptrs[c] = bufs[min(c, len(bufs) - 1)].ctypes.data
                step = bps
            advance = row_bytes
            if mode == 0:  # the put routine's own count of a row
                skip = bw - ncol
                if d.bits < 8:
                    advance = (ncol * d.bits + 7) // 8 + skip // (8 // d.bits)
                else:
                    advance = ncol * step + skip
            put(ptrs, step, advance, d.bits, mode, alpha, table.ctypes.data, ncol, nrow, x, y,
                hflip, vflip, out.ctypes.data, w, h)
    return out
