"""The port's loss plots against the JAX package's ``save_training_plots``:
the series of every panel equal to what JAX hands ``Axes.plot`` on the same
``record.csv`` (NaN in the same places, values within 1e-12), with empty
``val_*`` cells, at 3 and 25 epochs; and the four SVG files."""

import math
import xml.etree.ElementTree as ET

import matplotlib.axes
import numpy as np
import pandas as pd
import pytest
import torch

from radnet_torch.engine.loop import RECORD_COLUMNS, read_record, write_record
from radnet_torch.engine.plots import PLOTS, curve_series, save_training_plots
from radnet_tpu.engine import loop as jloop

torch.set_num_threads(1)


def _rows(n: int, seed: int) -> list[dict]:
    """record rows as fit writes them: 3 decimals, empty validation cells at
    the second and the last epoch, model_improvement empty where it did not
    improve."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        row = {k: round(float(rng.uniform(0.05, 3.0)), 3) for k in RECORD_COLUMNS}
        if i in (1, n - 1):
            for k in RECORD_COLUMNS:
                if k.startswith("val_"):
                    row[k] = None
        if i % 3:
            row["model_improvement"] = None
        rows.append(row)
    return rows


@pytest.mark.parametrize("n", [3, 25])
def test_series_equal_jax(n, tmp_path, monkeypatch):
    path = str(tmp_path / "record.csv")
    write_record(path, _rows(n, n))

    calls = []
    real = matplotlib.axes.Axes.plot

    def plot(self, *args, **kwargs):
        calls.append((np.asarray(args[0], np.float64), np.asarray(args[1], np.float64)))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(matplotlib.axes.Axes, "plot", plot)
    jloop.save_training_plots(pd.read_csv(path), str(tmp_path / "jax_viz"))

    rows = read_record(path)
    got = [s for _, cols in PLOTS for col in cols for s in curve_series(rows, col)]
    assert len(got) == len(calls) == 4 * 7
    for (label, color, ys), (jx, jy) in zip(got, calls):
        np.testing.assert_array_equal(jx, np.arange(n))
        ys = np.asarray(ys)
        np.testing.assert_array_equal(np.isnan(ys), np.isnan(jy))
        np.testing.assert_allclose(ys[~np.isnan(ys)], jy[~np.isnan(jy)], rtol=0, atol=1e-12)
    smooth_val = curve_series(rows, "total_loss")[3][2]
    if n <= 20:  # one window of every epoch: one point, absent here (an empty cell)
        assert all(math.isnan(y) for y in smooth_val)
        assert sum(not math.isnan(y) for y in curve_series(rows, "total_loss")[1][2]) == 1
    else:  # the windows ending at epochs 21-23 hold no empty cell
        assert [i for i, y in enumerate(smooth_val) if not math.isnan(y)] == [21, 22, 23]


def test_svg_files(tmp_path):
    rows = _rows(25, 0)
    save_training_plots(rows, str(tmp_path / "viz"))
    for fname, cols in PLOTS:
        root = ET.parse(tmp_path / "viz" / fname).getroot()
        texts = [t.text for t in root.iter("{http://www.w3.org/2000/svg}text")]
        assert all(c in texts for c in cols) and texts.count("Train") == texts.count("Val") == len(cols)
    save_training_plots([], str(tmp_path / "empty"))  # a run with no epoch still writes them
    assert len(list((tmp_path / "empty").iterdir())) == 4
