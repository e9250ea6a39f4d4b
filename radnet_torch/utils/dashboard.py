"""Self-contained HTML training dashboard (stdlib only).

Renders a model directory's ``record.csv`` (one row per epoch) and
``metrics.jsonl`` (one line per step) into one static HTML file with inline
SVG charts: open ``<model_dir>/dashboard.html`` in any browser, nothing to
install or serve.  The output is byte-for-byte the JAX package's dashboard
for the same two files.

Usage:
  python -m radnet_torch.utils.dashboard <model_dir>
or automatically at the end of ``engine.loop.fit``.
"""

from __future__ import annotations

import html
import json
import os
from typing import Sequence

# Two categorical series colours, light and dark mode; the pair stays
# distinguishable under colour-vision deficiency in both modes.
LIGHT = {"s1": "#2a78d6", "s2": "#eb6834"}
DARK = {"s1": "#3987e5", "s2": "#d95926"}

_CSS = """
.viz-root {{
  color-scheme: light;
  --surface-1: #fcfcfb; --surface-2: #f1f0ee;
  --text-primary: #0b0b0b; --text-secondary: #52514e; --text-muted: #8a887f;
  --grid: #e4e2de;
  --series-1: {l1}; --series-2: {l2};
  font-family: -apple-system, "Segoe UI", Roboto, Helvetica, Arial, sans-serif;
  background: var(--surface-1); color: var(--text-primary);
  margin: 0; padding: 24px;
}}
@media (prefers-color-scheme: dark) {{
  :root:where(:not([data-theme="light"])) .viz-root {{
    color-scheme: dark;
    --surface-1: #1a1a19; --surface-2: #242422;
    --text-primary: #ffffff; --text-secondary: #c3c2b7; --text-muted: #8a887f;
    --grid: #343431;
    --series-1: {d1}; --series-2: {d2};
  }}
}}
:root[data-theme="dark"] .viz-root {{
  color-scheme: dark;
  --surface-1: #1a1a19; --surface-2: #242422;
  --text-primary: #ffffff; --text-secondary: #c3c2b7; --text-muted: #8a887f;
  --grid: #343431;
  --series-1: {d1}; --series-2: {d2};
}}
.viz-root h1 {{ font-size: 18px; font-weight: 600; margin: 0 0 4px; }}
.viz-root .sub {{ color: var(--text-secondary); font-size: 13px; margin-bottom: 20px; }}
.tiles {{ display: flex; gap: 16px; flex-wrap: wrap; margin-bottom: 24px; }}
.tile {{ background: var(--surface-2); border-radius: 8px; padding: 12px 16px; min-width: 150px; }}
.tile .label {{ font-size: 12px; color: var(--text-secondary); }}
.tile .value {{ font-size: 26px; font-weight: 600; margin-top: 2px; }}
.grid-charts {{ display: grid; grid-template-columns: repeat(auto-fill, minmax(430px, 1fr)); gap: 24px; }}
.chart {{ background: var(--surface-1); }}
.chart h2 {{ font-size: 13px; font-weight: 600; margin: 0 0 2px; }}
.legend {{ display: flex; gap: 14px; font-size: 12px; color: var(--text-secondary); margin: 4px 0 6px; }}
.legend .key {{ display: inline-flex; align-items: center; gap: 5px; }}
.legend .swatch {{ width: 14px; height: 3px; border-radius: 2px; display: inline-block; }}
svg text {{ fill: var(--text-muted); font-size: 10px; font-family: inherit; }}
svg text.endlabel {{ fill: var(--text-secondary); font-size: 10px; }}
svg .gridline {{ stroke: var(--grid); stroke-width: 1; }}
svg .axisline {{ stroke: var(--grid); stroke-width: 1; }}
.tip {{ position: fixed; pointer-events: none; background: var(--surface-2);
  color: var(--text-primary); border: 1px solid var(--grid); border-radius: 6px;
  padding: 6px 9px; font-size: 12px; display: none; z-index: 9; }}
.tip .t-row {{ display: flex; align-items: center; gap: 6px; }}
.tip .t-dot {{ width: 8px; height: 8px; border-radius: 50%; display: inline-block; }}
details.tableview {{ margin-top: 24px; font-size: 12px; }}
details.tableview table {{ border-collapse: collapse; }}
details.tableview td, details.tableview th {{
  border: 1px solid var(--grid); padding: 3px 8px;
  font-variant-numeric: tabular-nums; text-align: right; }}
""".format(l1=LIGHT["s1"], l2=LIGHT["s2"], d1=DARK["s1"], d2=DARK["s2"])

_JS = """
(function () {
  const tip = document.createElement('div');
  tip.className = 'tip';
  document.body.appendChild(tip);
  document.querySelectorAll('svg[data-chart]').forEach(svg => {
    const d = JSON.parse(svg.dataset.chart);
    const cross = svg.querySelector('.crosshair');
    const dots = d.series.map((s, k) => svg.querySelector('.hoverdot-' + k));
    svg.addEventListener('mousemove', ev => {
      const pt = svg.createSVGPoint();
      pt.x = ev.clientX; pt.y = ev.clientY;
      const p = pt.matrixTransform(svg.getScreenCTM().inverse());
      let best = 0, dist = 1e9;
      d.xs.forEach((x, i) => { const dd = Math.abs(x - p.x); if (dd < dist) { dist = dd; best = i; } });
      cross.setAttribute('x1', d.xs[best]); cross.setAttribute('x2', d.xs[best]);
      cross.style.display = 'block';
      let rows = '<div style="color:var(--text-secondary)">' + d.xlabel + ' ' + d.xvals[best] + '</div>';
      d.series.forEach((s, k) => {
        const y = s.ys[best];
        if (y === null) { dots[k].style.display = 'none'; return; }
        dots[k].setAttribute('cx', d.xs[best]); dots[k].setAttribute('cy', s.py[best]);
        dots[k].style.display = 'block';
        rows += '<div class="t-row"><span class="t-dot" style="background:' + s.color +
                '"></span>' + s.name + ' <b>' + y + '</b></div>';
      });
      tip.innerHTML = rows;
      tip.style.display = 'block';
      tip.style.left = (ev.clientX + 14) + 'px';
      tip.style.top = (ev.clientY + 10) + 'px';
    });
    svg.addEventListener('mouseleave', () => {
      tip.style.display = 'none'; cross.style.display = 'none';
      dots.forEach(dd => dd && (dd.style.display = 'none'));
    });
  });
})();
"""


def _ticks(lo: float, hi: float, n: int = 4) -> list[float]:
    """Clean tick values covering [lo, hi]."""
    import math

    if hi <= lo:
        hi = lo + 1.0
    raw = (hi - lo) / n
    mag = 10 ** math.floor(math.log10(raw))
    step = next(s * mag for s in (1, 2, 2.5, 5, 10) if s * mag >= raw)
    t0 = math.floor(lo / step) * step
    out = [round(t0, 10)]
    while out[-1] < hi - 1e-9:  # last tick must cover the max value
        out.append(round(out[-1] + step, 10))
    return out


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e6:
        return f"{int(v):,}"
    return f"{v:.4g}"


def line_chart(
    title: str,
    xvals: Sequence,
    series: list[tuple[str, str, Sequence]],
    *,
    xlabel: str = "epoch",
    width: int = 430,
    height: int = 190,
) -> str:
    """One SVG line chart. ``series``: (name, css-color-var, ys with None gaps)."""
    pad_l, pad_r, pad_t, pad_b = 44, 64, 8, 22
    pw, ph = width - pad_l - pad_r, height - pad_t - pad_b
    ys_all = [y for _, _, ys in series for y in ys if y is not None]
    if not ys_all or len(xvals) == 0:
        return ""
    lo, hi = min(ys_all), max(ys_all)
    ticks = _ticks(min(lo, 0 if lo > 0 and hi / max(lo, 1e-9) > 5 else lo), hi)
    lo, hi = ticks[0], ticks[-1]
    n = len(xvals)

    def sx(i):
        return pad_l + (pw * i / max(n - 1, 1))

    def sy(v):
        return pad_t + ph * (1 - (v - lo) / max(hi - lo, 1e-12))

    parts = [
        f'<svg viewBox="0 0 {width} {height}" width="{width}" height="{height}"'
    ]
    # gridlines + y ticks
    body = []
    for t in ticks:
        y = sy(t)
        body.append(f'<line class="gridline" x1="{pad_l}" y1="{y:.1f}" x2="{width - pad_r}" y2="{y:.1f}"/>')
        body.append(f'<text x="{pad_l - 6}" y="{y + 3:.1f}" text-anchor="end">{_fmt(t)}</text>')
    body.append(f'<line class="axisline" x1="{pad_l}" y1="{pad_t + ph}" x2="{width - pad_r}" y2="{pad_t + ph}"/>')
    # x ticks: first / middle / last
    for i in sorted({0, n // 2, n - 1}):
        body.append(
            f'<text x="{sx(i):.1f}" y="{height - 6}" text-anchor="middle">{xvals[i]}</text>'
        )

    data = {"xs": [round(sx(i), 1) for i in range(n)], "xvals": list(xvals), "xlabel": xlabel, "series": []}
    for name, color, ys in series:
        pts = [(sx(i), sy(y)) for i, y in enumerate(ys) if y is not None]
        if not pts:
            continue
        path = "M" + " L".join(f"{x:.1f} {y:.1f}" for x, y in pts)
        body.append(
            f'<path d="{path}" fill="none" stroke="{color}" stroke-width="2" '
            f'stroke-linejoin="round" stroke-linecap="round"/>'
        )
        # end marker: >=8px dot with a 2px surface ring
        ex, ey = pts[-1]
        body.append(f'<circle cx="{ex:.1f}" cy="{ey:.1f}" r="6" fill="var(--surface-1)"/>')
        body.append(f'<circle cx="{ex:.1f}" cy="{ey:.1f}" r="4" fill="{color}"/>')
        # direct end label (value only; identity is in the legend)
        last_y = next(y for y in reversed(ys) if y is not None)
        body.append(
            f'<text class="endlabel" x="{ex + 9:.1f}" y="{ey + 3:.1f}">{_fmt(last_y)}</text>'
        )
        data["series"].append(
            {
                "name": name,
                "color": color,
                "ys": [None if y is None else round(float(y), 4) for y in ys],
                "py": [None if y is None else round(sy(y), 1) for y in ys],
            }
        )
        body.append(
            f'<circle class="hoverdot-{len(data["series"]) - 1}" r="4" fill="{color}" '
            f'stroke="var(--surface-1)" stroke-width="2" style="display:none"/>'
        )
    body.append(
        f'<line class="crosshair" y1="{pad_t}" y2="{pad_t + ph}" x1="0" x2="0" '
        f'stroke="var(--grid)" style="display:none"/>'
    )
    payload = html.escape(json.dumps(data), quote=True)
    parts.append(f' data-chart="{payload}">')
    parts.extend(body)
    parts.append("</svg>")

    legend = ""
    if len(series) >= 2:
        keys = "".join(
            f'<span class="key"><span class="swatch" style="background:{c}"></span>{html.escape(nm)}</span>'
            for nm, c, _ in series
        )
        legend = f'<div class="legend">{keys}</div>'
    return f'<div class="chart"><h2>{html.escape(title)}</h2>{legend}{"".join(parts)}</div>'


def _col(rows: list[dict], key: str) -> list:
    out = []
    for r in rows:
        v = r.get(key)
        try:
            v = float(v)
            out.append(None if v != v else v)  # NaN -> gap
        except (TypeError, ValueError):
            out.append(None)
    return out


def generate_dashboard(model_dir: str, out_name: str = "dashboard.html") -> str | None:
    """Render record.csv + metrics.jsonl into ``<model_dir>/dashboard.html``."""
    record_path = os.path.join(model_dir, "record.csv")
    if not os.path.exists(record_path):
        return None
    import csv

    with open(record_path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return None
    epochs = list(range(1, len(rows) + 1))

    steps, step_loss = [], []
    jl = os.path.join(model_dir, "metrics.jsonl")
    if os.path.exists(jl):
        with open(jl) as f:
            for ln in f:
                try:
                    m = json.loads(ln)
                    steps.append(int(m["step"]))
                    step_loss.append(float(m["total_loss"]))
                except (ValueError, KeyError):
                    continue

    s1, s2 = "var(--series-1)", "var(--series-2)"

    def tv(train_key):
        return [
            ("train", s1, _col(rows, train_key)),
            ("val", s2, _col(rows, "val_" + train_key)),
        ]

    charts = []
    if steps:
        # thin to <=600 points
        k = max(1, len(steps) // 600)
        charts.append(
            line_chart(
                "Total loss per step", steps[::k],
                [("train", s1, step_loss[::k])], xlabel="step",
            )
        )
    for title, key in (
        ("Total loss", "total_loss"),
        ("RPN objectness loss", "loss_rpn_cls"),
        ("RPN box-regression loss", "loss_rpn_regr"),
        ("Detector class loss", "loss_detector_cls"),
        ("Detector box-regression loss", "loss_detector_regr"),
        ("Detector accuracy", "detector_acc"),
        ("Mean overlapping boxes", "mean_overlapping_bboxes"),
    ):
        charts.append(line_chart(title, epochs, tv(key)))

    val_total = _col(rows, "val_total_loss")
    best_val = min((v for v in val_total if v is not None), default=None)
    last = rows[-1]
    tiles = []
    for label, value in (
        ("Epochs", str(len(rows))),
        ("Best val total loss", _fmt(best_val) if best_val is not None else "-"),
        ("Final detector acc", html.escape(str(last.get("detector_acc", "-")))),
        ("Elapsed (min)", html.escape(str(last.get("elapsed_time", "-")))),
    ):
        tiles.append(
            f'<div class="tile"><div class="label">{label}</div>'
            f'<div class="value">{value}</div></div>'
        )

    # table view (accessibility fallback)
    cols = list(rows[0].keys())
    thead = "".join(f"<th>{html.escape(c)}</th>" for c in cols)
    tbody = "".join(
        "<tr>" + "".join(f"<td>{html.escape(str(r.get(c, '')))}</td>" for c in cols) + "</tr>"
        for r in rows
    )

    doc = f"""<!doctype html>
<html><head><meta charset="utf-8"><title>{html.escape(os.path.basename(model_dir))} - training dashboard</title>
<style>{_CSS}</style></head>
<body class="viz-root">
<h1>{html.escape(os.path.basename(model_dir))}</h1>
<div class="sub">Training dashboard - rendered from record.csv / metrics.jsonl</div>
<div class="tiles">{''.join(tiles)}</div>
<div class="grid-charts">{''.join(c for c in charts if c)}</div>
<details class="tableview"><summary>Data table (record.csv)</summary>
<table><thead><tr>{thead}</tr></thead><tbody>{tbody}</tbody></table></details>
<script>{_JS}</script>
</body></html>"""
    out_path = os.path.join(model_dir, out_name)
    with open(out_path, "w") as f:
        f.write(doc)
    return out_path


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_dir")
    args = p.parse_args(argv)
    out = generate_dashboard(args.model_dir)
    if out is None:
        print(f"no record.csv under {args.model_dir}")
        return 1
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
