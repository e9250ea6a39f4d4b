"""The loss plots of a training run: ``viz/accuracy.svg``, ``rpn_loss.svg``,
``detector_loss.svg`` and ``total_loss.svg``.

The JAX package's ``save_training_plots`` draws the same figures with
matplotlib (PNG); the card's host has no matplotlib, so these are SVG with
the same panels, titles, colours and legends.  Each panel plots one
``record.csv`` column: the training series red and its ``val_`` series
blue, each raw (faint) and as the trailing mean over ``min(20, n)`` epochs
(:func:`curve_series`), where a point is absent until the window is full
and wherever the window holds an empty cell, as pandas'
``rolling(window).mean()`` leaves NaN.  A run of absent points breaks a
curve.
"""

from __future__ import annotations

import html
import math
import os

PLOTS = [
    ("accuracy.svg", ["mean_overlapping_bboxes", "detector_acc"]),
    ("rpn_loss.svg", ["loss_rpn_cls", "loss_rpn_regr"]),
    ("detector_loss.svg", ["loss_detector_cls", "loss_detector_regr"]),
    ("total_loss.svg", ["total_loss"]),
]
_COLORS = {"r": "#ff0000", "b": "#0000ff"}
_RAW_OPACITY = 0.3


def _value(v) -> float:
    """A record cell as a float; an empty or non-numeric cell is NaN."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return math.nan


def curve_series(rows: list[dict], col: str) -> list[tuple[str, str, list[float]]]:
    """The four curves of ``col``'s panel in drawing order: ``(label, colour,
    ys)`` for the raw training series, its trailing mean, the raw validation
    series and its trailing mean; the x values are ``range(len(rows))``.
    The raw curves' label is ``""`` (not in the legend)."""
    n = len(rows)
    window = min(20, max(n, 1))
    out = []
    for series, color in ((col, "r"), (f"val_{col}", "b")):
        ys = [_value(r.get(series)) for r in rows]
        smooth = [math.nan] * n
        for i in range(window - 1, n):
            w = ys[i - window + 1 : i + 1]
            if not any(math.isnan(y) for y in w):
                smooth[i] = math.fsum(w) / window
        out.append(("", color, ys))
        out.append(("Train" if color == "r" else "Val", color, smooth))
    return out


def _panel(rows: list[dict], col: str, x0: float, width: float, height: float) -> list[str]:
    """One panel's SVG elements at horizontal offset ``x0``."""
    pad_l, pad_r, pad_t, pad_b = 56, 16, 36, 40
    pw, ph = width - pad_l - pad_r, height - pad_t - pad_b
    curves = curve_series(rows, col)
    finite = [y for _, _, ys in curves for y in ys if not math.isnan(y)]
    lo, hi = (min(finite), max(finite)) if finite else (0.0, 1.0)
    if hi - lo < 1e-12:
        lo, hi = lo - 0.5, hi + 0.5
    n = len(rows)

    def sx(i):
        return x0 + pad_l + pw * (i / (n - 1) if n > 1 else 0.5)

    def sy(v):
        return pad_t + ph * (1.0 - (v - lo) / (hi - lo))

    els = [f'<rect x="{x0 + pad_l}" y="{pad_t}" width="{pw}" height="{ph}" fill="none" stroke="#000000"/>',
           f'<text x="{x0 + pad_l + pw / 2:.2f}" y="{pad_t - 12}" text-anchor="middle" '
           f'font-size="14">{html.escape(col)}</text>']
    for k in range(5):
        v = lo + (hi - lo) * k / 4
        els.append(f'<text x="{x0 + pad_l - 6}" y="{sy(v) + 4:.2f}" text-anchor="end">{v:.4g}</text>')
    for i in sorted({0, n // 2, n - 1} if n else set()):
        els.append(f'<text x="{sx(i):.2f}" y="{pad_t + ph + 18}" text-anchor="middle">{i}</text>')
    legend = []
    for label, color, ys in curves:
        stroke, opacity = _COLORS[color], 1.0 if label else _RAW_OPACITY
        run: list[str] = []
        for i, y in enumerate(ys + [math.nan]):
            if not math.isnan(y):
                run.append(f"{sx(i):.2f},{sy(y):.2f}")
                continue
            if len(run) == 1:  # a lone point: a dot
                cx, cy = run[0].split(",")
                els.append(f'<circle cx="{cx}" cy="{cy}" r="2.5" fill="{stroke}" fill-opacity="{opacity}"/>')
            elif run:
                els.append(f'<polyline points="{" ".join(run)}" fill="none" stroke="{stroke}" '
                           f'stroke-opacity="{opacity}" stroke-width="1.5"/>')
            run = []
        if label:
            y = pad_t + 16 + 16 * len(legend)
            legend.append(f'<line x1="{x0 + pad_l + pw - 70}" y1="{y - 4}" x2="{x0 + pad_l + pw - 48}" '
                          f'y2="{y - 4}" stroke="{stroke}" stroke-width="2"/>'
                          f'<text x="{x0 + pad_l + pw - 42}" y="{y}">{label}</text>')
    return els + legend


def training_plot_svg(rows: list[dict], cols: list[str], width: int = 1500, height: int = 500) -> str:
    """One figure: a panel per column of ``cols``, side by side."""
    pw = width / len(cols)
    body = [el for k, col in enumerate(cols) for el in _panel(rows, col, k * pw, pw, height)]
    return "".join([
        f'<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 {width} {height}" width="{width}" '
        f'height="{height}" font-family="Helvetica, Arial, sans-serif" font-size="11">',
        f'<rect width="{width}" height="{height}" fill="#ffffff"/>', *body, "</svg>\n"])


def save_training_plots(record_rows: list[dict], viz_dir: str) -> None:
    """Write the four figures of ``record_rows`` (record.csv's rows, ``None``
    or ``""`` for an empty cell) into ``viz_dir``."""
    os.makedirs(viz_dir, exist_ok=True)
    for fname, cols in PLOTS:
        size = (1500, 500) if len(cols) == 2 else (1600, 800)
        with open(os.path.join(viz_dir, fname), "w") as f:
            f.write(training_plot_svg(record_rows, cols, *size))
