"""radnet_torch.utils.dashboard against radnet_tpu's: the same HTML, byte
for byte, from the same record.csv and metrics.jsonl (validation columns
empty or filled, NaN cells, a malformed step line, steps thinned past 600
points, an empty or missing record); and a dashboard that fails to render
never fails a training run."""

import json
import math
import shutil
import types

import numpy as np
import pytest
import torch

from radnet_torch.engine import loop
from radnet_torch.engine.loop import RECORD_COLUMNS, write_record
from radnet_torch.utils import dashboard as tdash
from radnet_tpu.utils import dashboard as jdash

torch.set_num_threads(1)


def _write_logs(d, n_epochs: int, n_steps: int, validation: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    rows = []
    for e in range(n_epochs):
        row = {k: round(float(rng.uniform(0.01, 3.0)), 3) for k in RECORD_COLUMNS}
        row["elapsed_time"] = round(0.37 * (e + 1), 3)
        row["model_improvement"] = None if e % 2 else -round(float(rng.uniform(0, 1)), 3)
        if not validation:
            for k in RECORD_COLUMNS:
                if k.startswith("val_"):
                    row[k] = None
        rows.append(row)
    if n_epochs > 2:
        rows[1]["detector_acc"] = float("nan")
    write_record(str(d / "record.csv"), rows)
    if n_steps:
        with open(d / "metrics.jsonl", "w") as f:
            for s in range(n_steps):
                f.write(json.dumps({"step": s, "total_loss": float(4.0 * math.exp(-s / 50.0))}) + "\n")
            f.write("not json\n")
            f.write(json.dumps({"step": n_steps}) + "\n")  # no total_loss


@pytest.mark.parametrize("n_epochs, n_steps, validation", [
    (1, 0, False), (3, 40, True), (5, 1300, True), (4, 12, False),
])
def test_dashboard_html_equals_jax(tmp_path, n_epochs, n_steps, validation):
    a, b = tmp_path / "a" / "model_x", tmp_path / "b" / "model_x"
    a.mkdir(parents=True)
    _write_logs(a, n_epochs, n_steps, validation)
    shutil.copytree(a, b)
    got, want = tdash.generate_dashboard(str(a)), jdash.generate_dashboard(str(b))
    assert got.endswith("dashboard.html") and want.endswith("dashboard.html")
    html = open(got, "rb").read()
    assert html == open(want, "rb").read()
    assert html.count(b"<svg") == (8 if n_steps else 7)


def test_dashboard_without_a_record(tmp_path):
    assert tdash.generate_dashboard(str(tmp_path)) is None
    (tmp_path / "record.csv").write_text(",".join(RECORD_COLUMNS) + "\n")
    assert tdash.generate_dashboard(str(tmp_path)) is None
    assert tdash.main([str(tmp_path)]) == 1


def test_line_chart_and_ticks_equal_jax():
    series = [("train", "red", [3.0, None, 1.5, 0.25]), ("val", "blue", [None, 2.0, 1.0, 0.5])]
    assert tdash.line_chart("t <x>", [1, 2, 3, 4], series) == jdash.line_chart("t <x>", [1, 2, 3, 4], series)
    assert tdash.line_chart("empty", [], []) == ""
    for lo, hi in ((0.0, 1.0), (0.013, 0.27), (5.0, 5.0), (-3.0, 1200.0)):
        assert tdash._ticks(lo, hi) == jdash._ticks(lo, hi)


def test_fit_survives_a_failing_dashboard(tmp_path, monkeypatch, capsys):
    def boom(model_path):
        raise ValueError("no")

    monkeypatch.setattr(loop, "generate_dashboard", boom)
    state = types.SimpleNamespace(model=torch.nn.Linear(1, 1), step=0)
    _, record = loop.fit(None, state, None, iter(()), str(tmp_path / "m"), n_epochs=0)
    assert record == [] and "dashboard generation failed: no" in capsys.readouterr().out
