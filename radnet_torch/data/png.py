"""PNG decode and encode with the standard library (``zlib``) and numpy.

:func:`decode_png` is the counterpart of ``cv2.imdecode(buf,
cv2.IMREAD_COLOR)`` for every PNG the standard allows: colour types grey,
RGB, palette, grey + alpha and RGBA at each of their bit depths (1, 2, 4, 8,
16), interlaced or not.  It returns BGR ``(H, W, 3)`` uint8 as libpng's
transforms under OpenCV make it: grey scaled to 8 bits and replicated to
three channels, 16-bit samples reduced to their high byte, palette indices
looked up, alpha and ``tRNS`` dropped.  Inflate is ``zlib``; the row filters,
Adam7 passes and sample unpacking run in ``radnet_torch/csrc/png_unfilter.cpp``
(:mod:`radnet_torch.ops.host_kernels`).  EXIF orientation is applied by
``radnet_torch/data/image.py``, which takes the ``eXIf`` chunk from
:func:`decode_png_exif`.

:func:`encode_png` writes grey or BGR uint8 images with filter 0 (None).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from radnet_torch.ops.host_kernels import PNG_UNFILTER

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_ADAM7 = [(0, 8, 0, 8), (4, 8, 0, 8), (0, 4, 4, 8), (2, 4, 0, 4), (0, 2, 2, 4), (1, 2, 0, 2),
          (0, 1, 1, 2)]  # (x0, dx, y0, dy) of each pass
# colour type -> the bit depths the standard allows
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def check_image_size(width: int, height: int) -> None:
    """OpenCV's validateInputImageSize, which cv2.imdecode applies before it
    decodes: at most 2^20 pixels a side and 2^30 in all."""
    if not (0 < width <= 1 << 20 and 0 < height <= 1 << 20 and width * height <= 1 << 30):
        raise ValueError(f"a {width} x {height} image is beyond OpenCV's size limits")


def _chunks(data: bytes):
    """(type, body) of each chunk up to IEND; a critical chunk whose CRC is
    wrong raises, an ancillary one is skipped (libpng's defaults), and IEND's
    is not read (OpenCV's reader stops there)."""
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError("truncated PNG chunk")
        body = data[pos + 8 : end]
        (crc,) = struct.unpack(">I", data[end : end + 4])
        pos = end + 4
        if ctype != b"IEND" and zlib.crc32(body, zlib.crc32(ctype)) != crc:
            if ctype[0] & 0x20 == 0:
                raise ValueError(f"PNG {ctype.decode('latin-1')} chunk with a bad CRC")
            continue
        yield ctype, body
        if ctype == b"IEND":
            return
    raise ValueError("PNG without IEND")


def _image_bytes(width: int, height: int, depth: int, color: int, interlace: int) -> int:
    """The length of the inflated image data: each pass's rows, a filter byte
    and the packed samples each."""
    bits = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color] * depth
    passes = _ADAM7 if interlace else [(0, 1, 0, 1)]
    total = 0
    for x0, dx, y0, dy in passes:
        pw, ph = max(0, -(-(width - x0) // dx)), max(0, -(-(height - y0) // dy))
        if pw and ph:
            total += ph * (1 + (pw * bits + 7) // 8)
    return total


def _inflate(stream: bytes, n: int) -> bytes:
    """The first n bytes the zlib stream inflates to, as libpng takes them:
    an error before they are out, or a stream that ends or runs out of IDAT
    data before it ends, raises; an error or more data after them is only a
    warning in libpng."""
    d = zlib.decompressobj()
    try:
        raw = d.decompress(stream, n)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from None
    if len(raw) < n:
        raise ValueError("PNG image data is too short")
    try:
        while not d.eof and d.unconsumed_tail:
            d.decompress(d.unconsumed_tail, 1 << 20)
    except zlib.error:
        return raw
    if not d.eof:
        raise ValueError("PNG image data ends before its zlib stream does")
    return raw


def decode_png_exif(data: bytes) -> tuple[np.ndarray, bytes | None]:
    """PNG bytes -> (BGR ``(H, W, 3)`` uint8, the body of its ``eXIf`` chunk
    or None)."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    header = palette = exif = None
    idat = []
    for ctype, body in _chunks(data):
        if (header is None) != (ctype == b"IHDR"):
            raise ValueError("PNG without IHDR first, or with two")
        if ctype == b"IHDR":
            if len(body) != 13:
                raise ValueError("bad PNG IHDR")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            if palette is not None or idat or len(body) % 3 or not 0 < len(body) <= 768:
                raise ValueError("bad PNG PLTE: repeated, after IDAT or of a bad length")
            palette = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"eXIf" and exif is None:
            exif = body
        elif ctype[0] & 0x20 == 0 and ctype != b"IEND":
            raise ValueError(f"unknown critical PNG chunk {ctype!r}")
    width, height, depth, color, comp, filt, interlace = header
    if (color not in _DEPTHS or depth not in _DEPTHS[color] or comp != 0 or filt != 0
            or interlace > 1):
        raise ValueError(f"bad PNG header: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace}")
    if width > 1_000_000 or height > 1_000_000:  # libpng's default user limits
        raise ValueError(f"a {width} x {height} PNG is beyond libpng's size limits")
    check_image_size(width, height)
    if color == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    if not idat:
        raise ValueError("PNG without IDAT")
    raw = _inflate(b"".join(idat), _image_bytes(width, height, depth, color, interlace))
    table = np.zeros((256, 3), np.uint8)  # indices past PLTE read black
    if palette is not None:
        table[: len(palette) // 3] = np.frombuffer(palette, np.uint8).reshape(-1, 3)
    out = np.empty((height, width, 3), np.uint8)
    rc = PNG_UNFILTER.fn("radnet_png_unfilter")(
        raw, len(raw), width, height, depth, color, interlace, table.ctypes.data, out.ctypes.data)
    if rc:
        raise ValueError("bad PNG filter type")
    return out, exif


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> BGR ``(H, W, 3)`` uint8 (EXIF orientation not applied)."""
    return decode_png_exif(data)[0]


def _chunk(ctype: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """Grey ``(H, W)`` or BGR ``(H, W, 3)`` uint8 -> PNG bytes (filter 0)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3) uint8, not {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    if img.ndim == 2:
        color, pix = 0, img
    else:
        color, pix = 2, img[..., ::-1]  # BGR -> RGB
    rows = np.ascontiguousarray(pix).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
