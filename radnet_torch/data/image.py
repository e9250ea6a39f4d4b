"""The port's image reader: ``cv2.imdecode(np.fromfile(path, np.uint8),
cv2.IMREAD_COLOR)`` without OpenCV.

:func:`decode_image` tells the format from its first bytes, decodes PNG
(``data/png.py``), JPEG (``data/jpeg.py``: grey, YCbCr, and 4-component
CMYK or YCCK converted as OpenCV converts CMYK) and TIFF or BigTIFF
(``data/tiff.py``: uncompressed, LZW, Deflate, PackBits and
JPEG-compressed, the last through ``data/jpeg.py``'s decoder; grey, RGB,
palette, CMYK and YCbCr, the last through libtiff's own conversion where
libjpeg does not convert it) to BGR ``(H, W, 3)`` uint8, and applies the
orientation:
for PNG and JPEG the EXIF orientation (tag 0x0112 of IFD0, from a JPEG's
``Exif`` APP1 segment or a PNG's ``eXIf`` chunk, either byte order) as
OpenCV's ``ApplyExifOrientation`` does; for TIFF the Orientation tag of IFD0,
whose flips libtiff applies strip by strip or tile by tile and whose
transpose OpenCV applies after.  A format OpenCV reads that the port does not
read yet raises ``ValueError`` naming it; :func:`read_image` raises
``FileNotFoundError`` for a missing file, as the JAX package's readers do.
"""

from __future__ import annotations

import struct

import numpy as np

from radnet_torch.data.jpeg import decode_jpeg
from radnet_torch.data.png import decode_png_exif
from radnet_torch.data.tiff import decode_tiff

_TIFF = [b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"]  # TIFF, BigTIFF
# First bytes of the formats OpenCV reads that the port does not read yet.
_NOT_YET = [
    (b"BM", "BMP"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
    (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"), (b"\xff\x4f\xff\x51", "JPEG 2000"),
    (b"#?RADIANCE", "Radiance HDR"), (b"#?RGBE", "Radiance HDR"),
    (b"\x59\xa6\x6a\x95", "Sun raster"), (b"\x76\x2f\x31\x01", "OpenEXR"),
    (b"\xff\x0a", "JPEG XL"), (b"\x00\x00\x00\x0cJXL \r\n\x87\n", "JPEG XL"),
]


def _format_of(data: bytes) -> str:
    if data.startswith(b"\x89PNG\r\n\x1a\n"):
        return "PNG"
    if data.startswith(b"\xff\xd8\xff"):  # OpenCV's JPEG signature
        return "JPEG"
    if data[:4] in _TIFF:
        return "TIFF"
    for magic, name in _NOT_YET:
        if data.startswith(magic):
            return name
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis"):
        return "AVIF"
    if data[:1] == b"P" and len(data) > 2 and data[1:2] in b"1234567fF":
        return {b"7": "PAM", b"f": "PFM", b"F": "PFM"}.get(data[1:2], "PNM")
    return "unknown"


def exif_orientation(tiff: bytes | None) -> int:
    """Tag 0x0112 of IFD0 in EXIF's TIFF bytes, 1 where there is none or the
    bytes do not parse."""
    if not tiff or len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    try:
        (ifd,) = struct.unpack(e + "I", tiff[4:8])
        (n,) = struct.unpack(e + "H", tiff[ifd: ifd + 2])
        for k in range(n):
            at = ifd + 2 + 12 * k
            tag, _, _ = struct.unpack(e + "HHI", tiff[at: at + 8])
            if tag == 0x0112:
                return struct.unpack(e + "H", tiff[at + 8: at + 10])[0]
    except struct.error:
        pass
    return 1


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ApplyExifOrientation: 2-4 flip, 5-8 transpose and flip; any
    other value leaves the image as it is."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation)
    if flip:
        img = np.flip(img, flip)
    return np.ascontiguousarray(img)


def decode_image(data: bytes) -> np.ndarray:
    """Image file bytes -> BGR ``(H, W, 3)`` uint8, its orientation applied."""
    kind = _format_of(data)
    if kind == "PNG":
        img, exif = decode_png_exif(data)
    elif kind == "JPEG":
        img, exif = decode_jpeg(data)
    elif kind == "TIFF":
        return decode_tiff(data)  # its Orientation tag applied
    elif kind == "unknown":
        raise ValueError("not an image file the port or OpenCV reads")
    else:
        raise ValueError(f"{kind} images are not read yet (PNG, JPEG and TIFF are)")
    return orient(img, exif_orientation(exif))


def read_image(path: str) -> np.ndarray:
    """Decode the image file at ``path``; ``FileNotFoundError`` if it is missing."""
    with open(path, "rb") as f:
        return decode_image(f.read())
