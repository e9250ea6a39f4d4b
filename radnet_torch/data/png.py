"""PNG decode and encode with the standard library (``zlib``) and numpy.

:func:`decode_png` is the counterpart of ``cv2.imdecode(buf,
cv2.IMREAD_COLOR)`` for 8-bit, non-interlaced PNGs of colour type grey,
grey + alpha, RGB and RGBA, with all five row filters.  It returns BGR
``(H, W, 3)`` uint8: grey is replicated to three channels and alpha is
dropped.  Any other PNG raises ``ValueError``.

The Sub and Up filters are undone with numpy; Average and Paeth depend on
the pixel to the left, so they run as a Python loop over the row and are
slow on giga-pixel panels written with them.

:func:`encode_png` writes grey or BGR uint8 images with filter 0 (None).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield ctype, body
        pos += 12 + length
        if ctype == b"IEND":
            return
    raise ValueError("PNG without IEND")


def _unfilter_slow(ftype: int, raw: bytearray, prev: bytes, bpp: int) -> bytearray:
    """Average (3) and Paeth (4): each byte depends on the one to its left."""
    out = raw
    n = len(out)
    if ftype == 3:
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + prev[i]) >> 1)) & 0xFF
        return out
    for i in range(n):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> BGR ``(H, W, 3)`` uint8."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    header = None
    idat = []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, comp, filt, interlace = header
    if depth != 8 or color not in _CHANNELS or comp != 0 or filt != 0 or interlace != 0:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {color}, interlace {interlace}"
        )
    bpp = _CHANNELS[color]
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    ftypes = rows[:, 0]
    pix = rows[:, 1:]
    if not (ftypes == 0).all():
        pix = pix.copy()
        prev = np.zeros(stride, np.uint8)
        for y in range(height):
            f = int(ftypes[y])
            row = pix[y]
            if f == 1:
                row[:] = np.cumsum(row.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
            elif f == 2:
                row += prev
            elif f in (3, 4):
                row[:] = np.frombuffer(
                    _unfilter_slow(f, bytearray(row.tobytes()), prev.tobytes(), bpp), np.uint8
                )
            elif f != 0:
                raise ValueError(f"bad PNG filter type {f}")
            prev = row
    img = pix.reshape(height, width, bpp)
    if bpp <= 2:  # grey, grey + alpha
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., 2::-1])  # RGB(A) -> BGR


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


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
