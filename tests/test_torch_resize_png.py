"""The port's replacements for OpenCV on the serving path: the bicubic
prescale and the PNG decoder.

Resize: OpenCV's vectorised INTER_CUBIC loops may fuse a multiply and an
add, the port sums each tap separately, so outputs differ by at most one
level, on at most 0.5% of the pixels.  Measured with OpenCV 5.0.0 on the
four cases below, in order: 1269 of 540000 pixels (0.235%), 2 of 15982
(0.013%), 6 of 17280 (0.035%), 4 of 32400 (0.012%).  PNG: decoded pixels
are byte-equal to ``cv2.imdecode(..., IMREAD_COLOR)``.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from radnet_torch.data import png
from radnet_torch.ops.resize import resize_cubic_u8

torch.set_num_threads(1)

MAX_DIFF_FRACTION = 0.005


@pytest.mark.parametrize("shape,out_wh", [
    ((3000, 2000), (600, 900)),  # the prescale factor of the default config
    ((130, 140), (131, 122)),
    ((64, 300, 3), (90, 64)),
    ((50, 70, 3), (90, 120)),  # upscale
])
def test_bicubic_matches_opencv(shape, out_wh):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[: shape[0] // 2] //= 4  # a hard edge, where cubic overshoots
    want = cv2.resize(img, out_wh, interpolation=cv2.INTER_CUBIC)
    got = resize_cubic_u8(torch.from_numpy(img), *out_wh).numpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= MAX_DIFF_FRACTION


def _png_with_filters(h, w, color, seed):
    """A PNG whose rows use all five filter types on random filtered bytes
    (any byte string is a valid filtered stream)."""
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (h, w * bpp + 1), dtype=np.uint8)
    raw[:, 0] = np.arange(h) % 5
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (png._SIGNATURE + png._chunk(b"IHDR", header)
            + png._chunk(b"IDAT", zlib.compress(raw.tobytes())) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("color", [0, 2, 4, 6])
def test_png_decode_all_filters_equals_opencv(color):
    data = _png_with_filters(17, 23, color, seed=color)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    got = png.decode_png(data)
    assert got.shape == (17, 23, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(40, 50), (40, 50, 3)])
def test_png_decode_opencv_written_and_writer(shape):
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[10:20] = 7  # flat rows make the encoder pick other filters
    ok, buf = cv2.imencode(".png", img)
    assert ok
    want = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(png.decode_png(buf.tobytes()), want)
    ours = png.encode_png(img)
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(ours, np.uint8), cv2.IMREAD_COLOR), want)


def test_png_unsupported_raises():
    header = struct.pack(">IIBBBBB", 4, 4, 16, 0, 0, 0, 0)  # 16-bit grey
    data = png._SIGNATURE + png._chunk(b"IHDR", header) + png._chunk(b"IEND", b"")
    with pytest.raises(ValueError):
        png.decode_png(data)
    with pytest.raises(ValueError):
        png.decode_png(b"GIF89a....")
