"""OpenCV's 8-bit drawing and Gaussian blur, pixel for pixel, in numpy.

The synthetic rock-art set (``radnet_torch.cli.make_synthetic_rockart``)
is drawn with these, as the JAX package's script draws it with
``cv2.line``, ``cv2.circle``, ``cv2.ellipse`` (``LINE_8``) and
``cv2.GaussianBlur``.  They follow OpenCV's integer arithmetic: points in
16-bit fixed point (``XY_SHIFT``), a thick segment a filled convex
quadrangle with its outline and round caps, an ellipse the polyline of a
degree table, and the 8-bit blur's fixed-point kernel and rounding.

Every drawing function takes a ``uint8`` image, grey ``(H, W)`` or
``(H, W, C)``, and a scalar colour, which OpenCV reads as ``(c, 0, 0,
0)``: on a 3-channel image the first channel takes ``c`` and the others
0.  It draws in place, clipped to the image, and returns the image."""

from __future__ import annotations

import functools
import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1


def _tdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _cv_round(x: float) -> int:
    """``cvRound``: to nearest, ties to even."""
    return int(round(x))


def _raw_color(img: np.ndarray, color) -> np.ndarray:
    """A scalar colour as OpenCV writes it: ``(c, 0, 0, ...)``."""
    c = np.zeros(img.shape[2] if img.ndim == 3 else 1, np.uint8)
    c[0] = int(color)
    return c if img.ndim == 3 else c[0]


def _midpoint_circle(radius: int):
    """The ``(dx, dy)`` steps of OpenCV's midpoint circle (``Circle`` in its
    drawing code), one an octant's row, ``dy`` from 0 while ``dx >= dy``."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        yield dx, dy
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


@functools.lru_cache(maxsize=None)
def disc_rows(radius: int) -> dict:
    """``{row offset: half-width}`` of OpenCV's filled circle: the cap of a
    thick line and the corner of a thick ``cv2.rectangle``."""
    rows: dict = {}
    for dx, dy in _midpoint_circle(radius):
        for row, half in ((dy, dx), (-dy, dx), (dx, dy), (-dx, dy)):
            rows[row] = max(rows.get(row, -1), half)
    return rows


def _circle_points(radius: int) -> np.ndarray:
    """The ``(x, y)`` offsets of OpenCV's 1-px midpoint circle."""
    pts = [(sx * a, sy * b) for dx, dy in _midpoint_circle(radius)
           for a, b in ((dx, dy), (dy, dx)) for sx in (-1, 1) for sy in (-1, 1)]
    return np.asarray(pts, np.int64).reshape(-1, 2)


def _put_points(img: np.ndarray, xs: np.ndarray, ys: np.ndarray, col) -> None:
    h, w = img.shape[:2]
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = col


def _disc(img: np.ndarray, cx: int, cy: int, radius: int, col) -> None:
    """OpenCV's filled midpoint circle, clipped."""
    h, w = img.shape[:2]
    for dy, half in disc_rows(radius).items():
        y = cy + dy
        if 0 <= y < h:
            x0, x1 = max(cx - half, 0), min(cx + half, w - 1)
            if x0 <= x1:
                img[y, x0:x1 + 1] = col


def _clip_line(width: int, height: int, p1: list, p2: list) -> bool:
    """OpenCV's ``clipLine`` of the segment ``p1``-``p2`` (``[x, y]``
    lists, changed in place) to ``[0, width) x [0, height)``; False if
    none of it is inside."""
    if width <= 0 or height <= 0:
        return False
    right, bottom = width - 1, height - 1
    x1, y1 = p1
    x2, y2 = p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:] = [x1, y1]
    p2[:] = [x2, y2]
    return (c1 | c2) == 0


def _line_int(img: np.ndarray, p1, p2, col) -> None:
    """OpenCV's ``Line`` (its ``LineIterator``, 8-connected, left to
    right) between integer points."""
    h, w = img.shape[:2]
    a, b = [int(p1[0]), int(p1[1])], [int(p2[0]), int(p2[1])]
    if not (0 <= a[0] < w and 0 <= b[0] < w and 0 <= a[1] < h and 0 <= b[1] < h):
        if not _clip_line(w, h, a, b):
            return
    dx, dy = b[0] - a[0], b[1] - a[1]
    if dx < 0:
        dx, dy = -dx, -dy
        a, b = b, a
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    if dy > dx:  # steep: step y, sometimes x
        n = dy + 1
        err = dy - (dx + dx)
        ys = a[1] + sy * np.arange(n)
        xs = a[0] + _bresenham_minor(n, err, dy, dx)
    else:
        n = dx + 1
        err = dx - (dy + dy)
        xs = a[0] + np.arange(n)
        ys = a[1] + sy * _bresenham_minor(n, err, dx, dy)
    _put_points(img, np.asarray(xs, np.int64), np.asarray(ys, np.int64), col)


def _bresenham_minor(n: int, err: int, major: int, minor: int) -> np.ndarray:
    """The minor-axis offsets of ``LineIterator``'s ``n`` points: after each
    point, ``err`` takes ``-2 minor``, and ``+2 major`` with a minor step
    when it was negative."""
    out = np.zeros(n, np.int64)
    off = 0
    for i in range(n):
        out[i] = off
        if err < 0:
            off += 1
            err += 2 * major
        err -= 2 * minor
    return out


def _line2(img: np.ndarray, p1, p2, col) -> None:
    """OpenCV's ``Line2``, the outline of a filled polygon: an 8-connected
    line between points in 16-bit fixed point, stepped in fixed point along
    its major axis, and its end point rounded."""
    h, w = img.shape[:2]
    a, b = [int(p1[0]), int(p1[1])], [int(p2[0]), int(p2[1])]
    if not _clip_line(w << XY_SHIFT, h << XY_SHIFT, a, b):
        return
    (x1, y1), (x2, y2) = a, b
    dx, dy = x2 - x1, y2 - y1
    steep = abs(dy) >= abs(dx)
    if (dy if steep else dx) < 0:
        x1, x2, y1, y2 = x2, x1, y2, y1
        dx, dy = -dx, -dy
    major = abs(dy) if steep else abs(dx)
    step = _tdiv((dx if steep else dy) << XY_SHIFT, major | 1)
    ecount = ((y2 - y1) if steep else (x2 - x1)) >> XY_SHIFT
    k = np.arange(max(ecount + 1, 0), dtype=np.int64)
    if steep:
        xs = (x1 + _HALF + k * step) >> XY_SHIFT
        ys = ((y1 + _HALF) >> XY_SHIFT) + k
    else:
        xs = ((x1 + _HALF) >> XY_SHIFT) + k
        ys = (y1 + _HALF + k * step) >> XY_SHIFT
    xs = np.append(xs, (x2 + _HALF) >> XY_SHIFT)
    ys = np.append(ys, (y2 + _HALF) >> XY_SHIFT)
    _put_points(img, xs, ys, col)


def _line_fixed(img: np.ndarray, p1, p2, col) -> None:
    """A 1-px line between points in 16-bit fixed point (``ThickLine`` at
    thickness 1): the points rounded to pixels, then :func:`_line_int`."""
    _line_int(img, ((p1[0] + _HALF) >> XY_SHIFT, (p1[1] + _HALF) >> XY_SHIFT),
              ((p2[0] + _HALF) >> XY_SHIFT, (p2[1] + _HALF) >> XY_SHIFT), col)


def _fill_convex_poly(img: np.ndarray, v: list, col) -> None:
    """OpenCV's ``FillConvexPoly`` of ``LINE_8`` on vertices in 16-bit
    fixed point: the outline by :func:`_line2`, then the rows between two
    edges walked in fixed point."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = _HALF
    p0 = v[-1]
    for p in v:
        _line2(img, p0, p, col)
        p0 = p
    xs = [p[0] for p in v]
    ys = [p[1] for p in v]
    imin = min(range(npts), key=lambda i: (ys[i], i))
    xmin, xmax = (min(xs) + delta) >> XY_SHIFT, (max(xs) + delta) >> XY_SHIFT
    ymin, ymax = (min(ys) + delta) >> XY_SHIFT, (max(ys) + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge_idx = [imin, imin]
    edge_di = [1, npts - 1]
    edge_x = [-XY_ONE, -XY_ONE]
    edge_dx = [0, 0]
    y = ymin
    edge_ye = [y, y]
    edges = npts
    while True:
        for i in range(2):
            if y >= edge_ye[i]:
                idx0 = edge_idx[i]
                di = edge_di[i]
                idx = (idx0 + di) % npts
                while True:
                    go = edges > 0
                    edges -= 1
                    if not go:
                        break
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        x_start, x_end = v[idx0][0], v[idx][0]
                        edge_ye[i] = ty
                        edge_dx[i] = _tdiv((x_end - x_start) * 2 + (ty - y), 2 * (ty - y))
                        edge_x[i] = x_start
                        edge_idx[i] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge_x[0] > edge_x[1] else (0, 1)
            xx1 = (edge_x[left] + _HALF) >> XY_SHIFT
            xx2 = (edge_x[right] + _HALF) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = col
        edge_x[0] += edge_dx[0]
        edge_x[1] += edge_dx[1]
        y += 1
        if y > ymax:
            break


def _thick_line(img: np.ndarray, p0, p1, col, thickness: int, flags: int) -> None:
    """OpenCV's ``ThickLine`` of ``LINE_8`` between points in 16-bit fixed
    point; ``flags`` bit 0 caps ``p0``, bit 1 caps ``p1``."""
    if thickness <= 1:
        _line_fixed(img, p0, p1, col)
        return
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = _cv_round(dy * r), _cv_round(dx * r)
        pts = [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
               (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)]
        _fill_convex_poly(img, pts, col)
    radius = (half + _HALF) >> XY_SHIFT
    for i, p in enumerate((p0, p1)):
        if flags & (i + 1):
            _disc(img, (p[0] + _HALF) >> XY_SHIFT, (p[1] + _HALF) >> XY_SHIFT, radius, col)


def line(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, p1, p2, color, thickness)`` (``LINE_8``)."""
    col = _raw_color(img, color)
    h, w = img.shape[:2]
    if thickness <= 1:
        _line_int(img, p1, p2, col)
        return img
    # the end points first clipped to the image grown by the thickness
    t = int(thickness)
    a, b = [int(p1[0]) + t, int(p1[1]) + t], [int(p2[0]) + t, int(p2[1]) + t]
    if _clip_line(w + 2 * t, h + 2 * t, a, b):
        _thick_line(img, ((a[0] - t) << XY_SHIFT, (a[1] - t) << XY_SHIFT),
                    ((b[0] - t) << XY_SHIFT, (b[1] - t) << XY_SHIFT), col, t, 3)
    return img


# sin of 0-450 degrees as OpenCV's drawing code tabulates it (float32 of
# the value to 7 decimals): cos(a) is SIN_TABLE[450 - a].
SIN_TABLE = np.array([round(math.sin(math.radians(a)), 7) for a in range(451)],
                     np.float32).astype(np.float64)


def ellipse_poly(center, axes, angle: int, arc_start: int, arc_end: int, delta: int) -> list:
    """OpenCV's ``ellipse2Poly`` on doubles: the polyline's points, one
    every ``delta`` degrees of the arc and one at its end."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start += 360
        arc_end += 360
    while arc_end > 360:
        arc_end -= 360
        arc_start -= 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    a = angle + (360 if angle < 0 else 0)
    beta, alpha = SIN_TABLE[a], SIN_TABLE[450 - a]
    pts = []
    for i in range(arc_start, arc_end + delta, delta):
        t = min(i, arc_end)
        if t < 0:
            t += 360
        x = axes[0] * SIN_TABLE[450 - t]
        y = axes[1] * SIN_TABLE[t]
        pts.append((center[0] + x * alpha - y * beta, center[1] + x * beta + y * alpha))
    if len(pts) == 1:
        pts = [tuple(center)] * 2
    return pts


def _ellipse_ex(img: np.ndarray, center, axes, angle: int, arc_start: int, arc_end: int,
                col, thickness: int) -> None:
    """OpenCV's ``EllipseEx`` outline (thickness >= 0) of an ellipse in
    16-bit fixed point: its polyline drawn as thick segments, the first
    capped at both ends, the others at their end."""
    axes = (abs(axes[0]), abs(axes[1]))
    d = (max(axes) + _HALF) >> XY_SHIFT
    delta = 90 if d < 3 else 30 if d < 10 else 18 if d < 15 else 5
    v = []
    for px, py in ellipse_poly((float(center[0]), float(center[1])),
                               (float(axes[0]), float(axes[1])), angle, arc_start, arc_end, delta):
        x = _cv_round(px / XY_ONE) << XY_SHIFT
        y = _cv_round(py / XY_ONE) << XY_SHIFT
        pt = (x + _cv_round(px - x), y + _cv_round(py - y))
        if not v or pt != v[-1]:
            v.append(pt)
    if len(v) == 1:
        v = [tuple(center)] * 2
    flags = 3
    for p0, p in zip(v, v[1:]):
        _thick_line(img, p0, p, col, thickness, flags)
        flags = 2


def ellipse(img: np.ndarray, center, axes, angle, start_angle, end_angle, color,
            thickness: int = 1) -> np.ndarray:
    """``cv2.ellipse(img, center, axes, angle, start_angle, end_angle,
    color, thickness)`` (``LINE_8``, thickness >= 1)."""
    c = (int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT)
    ax = (int(axes[0]) << XY_SHIFT, int(axes[1]) << XY_SHIFT)
    _ellipse_ex(img, c, ax, _cv_round(angle), _cv_round(start_angle), _cv_round(end_angle),
                _raw_color(img, color), thickness)
    return img


def circle(img: np.ndarray, center, radius: int, color, thickness: int = 1) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, thickness)`` (``LINE_8``,
    thickness >= 1): the midpoint circle at 1 px, else the ellipse's
    path."""
    col = _raw_color(img, color)
    cx, cy, radius = int(center[0]), int(center[1]), int(radius)
    if thickness > 1:
        r = radius << XY_SHIFT
        _ellipse_ex(img, (cx << XY_SHIFT, cy << XY_SHIFT), (r, r), 0, 0, 360, col, thickness)
    else:
        off = _circle_points(radius)
        _put_points(img, cx + off[:, 0], cy + off[:, 1], col)
    return img


def gaussian_kernel_u8(sigma: float) -> np.ndarray:
    """OpenCV's 8-bit Gaussian kernel for ``sigma``: ``round(6 sigma + 1) |
    1`` taps in fixed point with 8 fractional bits (summing to 256),
    rounded with the error carried from tap to tap toward the centre."""
    n = _cv_round(sigma * 3 * 2 + 1) | 1
    scale2 = -0.125 / (sigma * sigma)
    half = (n - 1) // 2
    values = [math.exp(float(x * x) * scale2) for x in range(1 - n, 0, 2)]
    total = 0.0
    for t in values:
        total += t
    total = total * 2 + 1.0
    mul = 1.0 / total
    k = np.zeros(n, np.int64)
    err, s = 0.0, 0
    for i in range(half):
        adj = values[i] * mul * 256.0 + err
        v0 = _cv_round(adj)
        err = adj - v0
        k[i] = k[n - 1 - i] = v0
        s += v0
    k[half] = 256 - 2 * s
    return k


def gaussian_blur_u8(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` on a ``uint8`` image, grey
    or ``(H, W, C)``: the rows then the columns with
    :func:`gaussian_kernel_u8` and OpenCV's default border (reflect-101),
    the row sums exact in 8 fractional bits, the result rounded half up
    from 16."""
    k = gaussian_kernel_u8(sigma)
    r = len(k) // 2
    pad = [(0, 0)] * img.ndim
    pad[1] = (r, r)
    src = np.pad(img.astype(np.int32), pad, mode="reflect")
    w = img.shape[1]
    rows = np.zeros(img.shape, np.int32)
    for i, t in enumerate(k):
        rows += int(t) * src[:, i:i + w]
    pad = [(0, 0)] * img.ndim
    pad[0] = (r, r)
    src = np.pad(rows, pad, mode="reflect")
    h = img.shape[0]
    out = np.zeros(img.shape, np.int64)
    for i, t in enumerate(k):
        out += int(t) * src[i:i + h]
    return np.clip((out + (1 << 15)) >> 16, 0, 255).astype(np.uint8)
