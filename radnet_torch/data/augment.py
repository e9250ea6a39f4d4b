"""Host augmentation of training tiles, with boxes kept consistent.

The JAX package's ``data/augment.py`` with numpy in place of OpenCV: the
same ops, probabilities, parameter ranges and ``np.random.Generator`` calls
in the same order, so one seed gives the same coin flips, angles and boxes.
Flips and 90-degree rotations are exact index operations.  The rotation
and shear warps are :func:`warp_affine`, a numpy copy of OpenCV's
``warpAffine`` (bilinear, constant-zero border) as OpenCV 5 computes it,
in float32: it matches that version's pixels, and OpenCV 4's 5-bit
fixed-point interpolation within one grey level.  ``bboxes`` is a list of
dicts with keys ``class, x1, y1, x2, y2``, transformed in place.
"""

from __future__ import annotations

import copy
import math
from typing import Any

import numpy as np

def get_truncated_normal(mean=0.0, sd=1.0, low=0.0, upp=1.0):
    from scipy.stats import truncnorm

    return truncnorm((low - mean) / sd, (upp - mean) / sd, loc=mean, scale=sd)


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """OpenCV's ``getRotationMatrix2D``: (2, 3) float64, angle in degrees,
    counter-clockwise."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], dtype=np.float64)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """OpenCV's ``invertAffineTransform``."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def warp_affine(img: np.ndarray, mat: np.ndarray, dsize: tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, mat, dsize)`` for uint8 ``(H, W, C)`` images:
    each output pixel samples the source at ``mat``'s inverse (float32),
    bilinear as two row lerps and a column lerp in float32, rounded to
    nearest even, with zero outside the source."""
    w_out, h_out = int(dsize[0]), int(dsize[1])
    h, w = img.shape[:2]
    m = _invert_affine(np.asarray(mat, dtype=np.float64)).astype(np.float32)
    ys, xs = np.mgrid[0:h_out, 0:w_out].astype(np.float32)
    sx = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    sy = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    x0f, y0f = np.floor(sx), np.floor(sy)
    ax, ay = sx - x0f, sy - y0f
    # A zero ring around the source: taps outside it read 0.
    pad = np.zeros((h + 2, w + 2) + img.shape[2:], dtype=np.float32)
    pad[1:-1, 1:-1] = img
    x0 = np.clip(x0f, -1, w).astype(np.int64) + 1
    y0 = np.clip(y0f, -1, h).astype(np.int64) + 1
    x1 = np.clip(x0f + 1, -1, w).astype(np.int64) + 1
    y1 = np.clip(y0f + 1, -1, h).astype(np.int64) + 1
    if img.ndim == 3:
        ax, ay = ax[..., None], ay[..., None]
    top = pad[y0, x0] + ax * (pad[y0, x1] - pad[y0, x0])
    bot = pad[y1, x0] + ax * (pad[y1, x1] - pad[y1, x0])
    return np.clip(np.rint(top + ay * (bot - top)), 0, 255).astype(np.uint8)


def _flip(img: np.ndarray, code: int) -> np.ndarray:
    """``cv2.flip``: 1 mirrors columns, 0 rows, -1 both."""
    if code == 1:
        return np.ascontiguousarray(img[:, ::-1])
    if code == 0:
        return np.ascontiguousarray(img[::-1])
    return np.ascontiguousarray(img[::-1, ::-1])


def strap_img(img: np.ndarray) -> tuple[int, int, int, int]:
    """First and last rows and columns with nonzero (finite) content of
    channel 1."""
    ch = img[:, :, 1]
    if np.issubdtype(ch.dtype, np.floating):
        finite = np.isfinite(ch)
        mask = (ch != 0) & finite if finite.all() else finite
    else:
        mask = ch != 0
    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    return rows[0], rows[-1], cols[0], cols[-1]


def clip_box(bbox: np.ndarray, img_box, alpha: float) -> tuple[np.ndarray, np.ndarray]:
    """Clip ``(N, 4+)`` xyxy boxes into ``img_box``; drop boxes that keep
    less than ``alpha`` of their area."""
    bbox = np.asarray(bbox, dtype=np.float64)
    if bbox.size == 0:
        return bbox.reshape(0, 4), np.zeros((0,), dtype=int)
    outside = ((bbox[:, 0] > img_box[2]) | (bbox[:, 2] < img_box[0])
               | (bbox[:, 1] > img_box[3]) | (bbox[:, 3] < img_box[1]))
    area = (bbox[:, 2] - bbox[:, 0]) * (bbox[:, 3] - bbox[:, 1])
    clipped = np.hstack([
        np.maximum(bbox[:, 0], img_box[0]).reshape(-1, 1),
        np.maximum(bbox[:, 1], img_box[1]).reshape(-1, 1),
        np.minimum(bbox[:, 2], img_box[2]).reshape(-1, 1),
        np.minimum(bbox[:, 3], img_box[3]).reshape(-1, 1),
        bbox[:, 4:],
    ])
    with np.errstate(divide="ignore", invalid="ignore"):
        delta = (area - (clipped[:, 2] - clipped[:, 0]) * (clipped[:, 3] - clipped[:, 1])) / area
    keep = (~outside) & (delta < (1.0 - alpha))
    return clipped[keep], keep.astype(int)


def _bboxes_to_array(bboxes: list[dict]) -> np.ndarray:
    return np.array([[b["x1"], b["y1"], b["x2"], b["y2"]] for b in bboxes], dtype=np.float64)


def _write_back(bboxes: list[dict], arr: np.ndarray, col_min=0, row_min=0) -> None:
    for i in range(arr.shape[0]):
        bboxes[i]["x1"] = int(arr[i, 0] - col_min)
        bboxes[i]["y1"] = int(arr[i, 1] - row_min)
        bboxes[i]["x2"] = int(math.ceil(arr[i, 2] - col_min))
        bboxes[i]["y2"] = int(math.ceil(arr[i, 3] - row_min))


# --------------------------------------------------------------------------- #
# Geometric ops.
# --------------------------------------------------------------------------- #
def horizontal_flip(img, bboxes):
    cols = img.shape[1]
    img = _flip(img, 1)
    for b in bboxes:
        b["x1"], b["x2"] = cols - b["x2"], cols - b["x1"]
    return img, bboxes


def vertical_flip(img, bboxes):
    rows = img.shape[0]
    img = _flip(img, 0)
    for b in bboxes:
        b["y1"], b["y2"] = rows - b["y2"], rows - b["y1"]
    return img, bboxes


def ninety_degree_rotation(img, bboxes, rng: np.random.Generator):
    rows, cols = img.shape[:2]
    angle = rng.choice([90, 180, 270])
    if angle == 270:
        img = _flip(np.transpose(img, (1, 0, 2)), 0)
    elif angle == 180:
        img = _flip(img, -1)
    else:  # 90
        img = _flip(np.transpose(img, (1, 0, 2)), 1)
    for b in bboxes:
        x1, x2, y1, y2 = b["x1"], b["x2"], b["y1"], b["y2"]
        if angle == 270:
            b["x1"], b["x2"], b["y1"], b["y2"] = y1, y2, cols - x2, cols - x1
        elif angle == 180:
            b["x1"], b["x2"], b["y1"], b["y2"] = cols - x2, cols - x1, rows - y2, rows - y1
        else:
            b["x1"], b["x2"], b["y1"], b["y2"] = rows - y2, rows - y1, x1, x2
    return img, bboxes


def any_degree_rotation(img, bboxes, rng: np.random.Generator, max_degrees=3.0):
    """Small-angle rotation on an expanded canvas, boxes through their
    rotated corners, then cropped to the content."""
    if not bboxes:
        return img, bboxes
    arr = _bboxes_to_array(bboxes)
    height, width = img.shape[:2]
    angle = rng.uniform(-max_degrees, max_degrees)
    cx, cy = width // 2, height // 2
    mat = rotation_matrix_2d((cx, cy), angle, 1.0)
    cos, sin = abs(mat[0, 0]), abs(mat[0, 1])
    new_w = int(height * sin + width * cos)
    new_h = int(height * cos + width * sin)
    mat[0, 2] += new_w / 2 - cx
    mat[1, 2] += new_h / 2 - cy
    img = warp_affine(img, mat, (new_w, new_h))

    x1, y1, x2, y2 = arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]
    corners = np.stack([x1, y1, x2, y1, x1, y2, x2, y2], axis=1).reshape(-1, 2)
    corners = np.hstack([corners, np.ones((corners.shape[0], 1))])
    rotated = (mat @ corners.T).T.reshape(-1, 8)
    xs, ys = rotated[:, 0::2], rotated[:, 1::2]
    arr = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1)

    row_min, row_max, col_min, col_max = strap_img(img)
    img = img[row_min:row_max, col_min:col_max, :]
    arr, mask = clip_box(arr, [col_min, row_min, col_max, row_max], 0.5)
    bboxes = [bboxes[i] for i in range(mask.shape[0]) if mask[i] == 1]
    _write_back(bboxes, arr, col_min, row_min)
    return img, bboxes


def shear(img, bboxes, rng: np.random.Generator):
    """Horizontal shear by up to 0.3; a negative factor shears the mirror
    image."""
    factor = rng.uniform(-0.3, 0.3)
    if factor < 0:
        img, bboxes = horizontal_flip(img, bboxes)
    height, width = img.shape[:2]
    arr = _bboxes_to_array(bboxes)
    mat = np.array([[1.0, abs(factor), 0.0], [0.0, 1.0, 0.0]])
    new_w = width + abs(factor * height)
    if arr.size:
        arr[:, [0, 2]] += (arr[:, [1, 3]] * abs(factor)).astype(int)
    img = warp_affine(img, mat, (int(new_w), height))
    row_min, row_max, col_min, col_max = strap_img(img)
    img = img[row_min:row_max, col_min:col_max, :]
    _write_back(bboxes, arr, col_min, row_min)
    if factor < 0:
        img, bboxes = horizontal_flip(img, bboxes)
    return img, bboxes


# --------------------------------------------------------------------------- #
# Photometric ops (run here only without augment_photometric_on_device).
# --------------------------------------------------------------------------- #
def brightness(img, bboxes, rng: np.random.Generator):
    """Shift weighted by the current brightness; zero background kept."""
    background = img == 0
    imgf = img.astype(np.float32)
    max_b, min_b = 180.0, 75.0
    n_fg = img.size - np.count_nonzero(background)
    if n_fg == 0:
        return img, bboxes
    avg = float(imgf.sum()) / n_fg
    if avg <= min_b or avg >= max_b:
        return img, bboxes
    p = (avg - min_b) / (max_b - min_b)
    if rng.random() < p:
        imgf -= rng.random() * (avg - min_b)
    else:
        imgf += rng.random() * (max_b - avg)
    imgf = np.clip(imgf, 0, 255).astype(np.uint8)
    imgf[background] = 0
    return imgf, bboxes


def contrast(img, bboxes, rng: np.random.Generator):
    """Intensity rescale over a random window; truncates to uint8."""
    max_c, min_c = 180.0, 75.0
    lo = min_c * rng.random()
    hi = (255.0 - max_c) * rng.random() + max_c
    out = np.clip((img.astype(np.float32) - lo) / max(hi - lo, 1e-6), 0.0, 1.0) * 255.0
    return out.astype(np.uint8), bboxes


def _as_ubyte(x: np.ndarray) -> np.ndarray:
    return np.rint(np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)


def _apply_grey_aware(img, img_type, fn):
    """``fn`` (float [0, 1] -> float) on channel 0, copied to every channel,
    for grey image types, else on the whole image; zero background kept."""
    if "grey" in img_type:
        background = img[:, :, 0] == 0
        noisy = _as_ubyte(fn(img[:, :, 0].astype(np.float32) / np.float32(255.0)))
        noisy[background] = 0
        out = img.copy()
        out[:, :, 0] = noisy
        out[:, :, 1] = noisy
        out[:, :, 2] = noisy
        return out
    background = img == 0
    noisy = _as_ubyte(fn(img.astype(np.float32) / np.float32(255.0)))
    noisy[background] = 0
    return noisy


def salt_and_pepper_noise(img, bboxes, img_type, rng: np.random.Generator):
    amount = (0.3 - 0.01) * rng.random() + 0.01
    svp = get_truncated_normal(mean=0.5, sd=0.1, low=0, upp=1).rvs(1, random_state=rng)[0]

    def fn(x):
        out = x.copy()
        r = rng.random(x.shape, dtype=np.float32)
        out[r < amount * svp] = 1.0
        out[(r >= amount * svp) & (r < amount)] = 0.0
        return out

    return _apply_grey_aware(img, img_type, fn), bboxes


def gaussian_noise(img, bboxes, img_type, rng: np.random.Generator):
    mean = 0.1 * rng.random() - 0.05
    var = (0.01 - 0.001) * rng.random() + 0.001

    def fn(x):
        noise = rng.standard_normal(x.shape, dtype=np.float32)
        return x + (noise * np.float32(var**0.5) + np.float32(mean))

    return _apply_grey_aware(img, img_type, fn), bboxes


def poisson_noise(img, bboxes, img_type, rng: np.random.Generator):
    def fn(x):
        bins = np.bincount(np.rint(x * 255.0).astype(np.uint8).ravel(), minlength=256)
        n_unique = max(int(np.count_nonzero(bins)), 2)
        vals = 2.0 ** np.ceil(np.log2(n_unique))
        return rng.poisson(x * vals) / np.float32(vals)

    return _apply_grey_aware(img, img_type, fn), bboxes


def augment(img_data: dict[str, Any], img: np.ndarray, config, do_augment: bool = True,
            rng: np.random.Generator | None = None) -> tuple[dict[str, Any], np.ndarray]:
    """The augmentation schedule of one tile: flips, rot90 and the small
    rotation at p = 0.5, shear at p = 0.25; then, unless the step does it on
    the device, brightness at p = 0.5 and one of {salt-and-pepper,
    gaussian, poisson, contrast} at p = 0.5."""
    assert "bboxes" in img_data and "width" in img_data and "height" in img_data
    rng = rng or np.random.default_rng()
    img_data_aug = copy.deepcopy(img_data)
    photometric = not getattr(config, "augment_photometric_on_device", False)
    if do_augment:
        boxes = img_data_aug["bboxes"]
        if config.use_horizontal_flips and rng.random() < 0.5:
            img, boxes = horizontal_flip(img, boxes)
        if config.use_vertical_flips and rng.random() < 0.5:
            img, boxes = vertical_flip(img, boxes)
        if config.use_90_rotations and rng.random() < 0.5:
            img, boxes = ninety_degree_rotation(img, boxes, rng)
        if config.use_rotations and rng.random() < 0.5:
            img, boxes = any_degree_rotation(img, boxes, rng)
        if config.use_shear and rng.random() < 0.25:
            img, boxes = shear(img, boxes, rng)
        if photometric and config.use_brightness and rng.random() < 0.5:
            img, boxes = brightness(img, boxes, rng)
        if photometric and config.use_noise and rng.random() < 0.5:
            r = rng.integers(0, 4)
            img_type = config.img_types[0]  # grey handling keys on the first type
            if r == 0:
                img, boxes = salt_and_pepper_noise(img, boxes, img_type, rng)
            elif r == 1:
                img, boxes = gaussian_noise(img, boxes, img_type, rng)
            elif r == 2:
                img, boxes = poisson_noise(img, boxes, img_type, rng)
            else:
                img, boxes = contrast(img, boxes, rng)
        img_data_aug["bboxes"] = boxes
        img_data_aug["width"] = img.shape[1]
        img_data_aug["height"] = img.shape[0]
    return img_data_aug, img
