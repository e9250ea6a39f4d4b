"""The port's debugging commands against radnet_tpu's.

``RADNet.predict_region_proposals`` gives the JAX package's proposal sets
(exactly: integer boxes) on the same weights and panels, and the two
``test_rpn`` CLIs print the same per-panel counts and the same recall line.
The JAX package's own path raises on a ResNet50 with ``infer_host_s2d``
(its default: 12-channel canvases meet a 3-channel mean), so it runs with
the field off; the port ignores the field.  ``test_data``: the anchor
report equals the JAX package's dict, and with JAX's subsample keys
replayed (``tests/torch_port_util.jax_rpn_bits``) the per-anchor positive
counts and the printed per-sample lines are equal too; its PNGs are
written.  ``cv2.resize`` is patched to the port's bicubic, so both
packages resize alike.
"""

import csv
import dataclasses
import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from radnet_torch.cli import test_data as ttd
from radnet_torch.cli import test_rpn as trpn
from radnet_torch.config import Config as TorchConfig
from radnet_torch.data.image import read_image
from radnet_torch.data.png import write_png
from radnet_torch.inference import RADNet as TorchRADNet
from radnet_tpu.cli import test_data as jtd
from radnet_tpu.cli import test_rpn as jrpn
from radnet_tpu.inference import RADNet as JaxRADNet
from tests.test_torch_cascade import _grey_panel
from tests.torch_port_util import jax_resnet, jax_rpn_bits, port_cv2_resize, port_model, torch_config
from tests.util import tiny_config

torch.set_num_threads(1)

PANEL_HW = (80, 90)


@pytest.fixture(scope="module")
def nets():
    cfg, model, params, bstats = jax_resnet(0)
    cfg = dataclasses.replace(cfg, infer_host_s2d=False)
    return (JaxRADNet(cfg, model, params, bstats),
            TorchRADNet(torch_config(cfg), port_model(cfg, params, bstats), device="cpu"))


def _key(props):
    return sorted((p["class"], p["prob"], int(p["x1"]), int(p["y1"]), int(p["x2"]), int(p["y2"]))
                  for p in props)


@pytest.mark.parametrize("seed, hw", [(3, PANEL_HW), (4, (130, 140)), (5, (50, 70))])
def test_predict_region_proposals_matches_jax(nets, monkeypatch, seed, hw):
    monkeypatch.setattr(cv2, "resize", port_cv2_resize)
    jnet, tnet = nets
    panel = _grey_panel(seed, *hw)
    want = jnet.predict_region_proposals(panel)
    got = tnet.predict_region_proposals(panel)
    assert len(want) > 0
    assert _key(got) == _key(want)


@pytest.fixture(scope="module")
def rpn_set(nets, tmp_path_factory):
    """Two grey panels, each with ground truth at one proposal and one box
    far from any; annot.csv beside them."""
    root = tmp_path_factory.mktemp("rpn")
    folder = root / "data" / nets[1].C.img_types[0]
    folder.mkdir(parents=True)
    rows = []
    for k in range(2):
        panel = _grey_panel(10 + k, *PANEL_HW)
        write_png(str(folder / f"p{k}.png"), panel[..., 0])
        p = nets[1].predict_region_proposals(panel)[3 * k]
        rows.append([f"p{k}.png", "boat", p["x1"] + 1, p["y1"], p["x2"], p["y2"] - 1])
        rows.append([f"p{k}.png", "human", 70, 60, 89, 79])
    with open(root / "annot.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["img_path", "label", "xmin", "ymin", "xmax", "ymax"])
        w.writerows(rows)
    return root


def test_test_rpn_cli_matches_jax(nets, rpn_set, monkeypatch, capsys, tmp_path):
    import radnet_torch.inference

    monkeypatch.setattr(cv2, "resize", port_cv2_resize)
    monkeypatch.setattr(jrpn, "load_radnet", lambda *a, **k: nets[0])
    monkeypatch.setattr(radnet_torch.inference, "load_radnet", lambda *a, **k: nets[1])
    outs = []
    for main, models, extra in ((jrpn.main, tmp_path / "jax", []), (trpn.main, tmp_path / "port", ["--device", "cpu"])):
        rc = main(["--models-path", str(models), "--model-name", "m", "--annot", str(rpn_set / "annot.csv"),
                   "--data", str(rpn_set / "data"), *extra])
        assert rc == 0
        outs.append([ln for ln in capsys.readouterr().out.splitlines() if not ln.startswith("Read ")])
    assert outs[0] == outs[1]
    assert "RPN recall@0.5: 2/4 = 0.500" in outs[1]
    for k in range(2):
        drawn = read_image(str(tmp_path / "port" / "m" / "test_rpn" / f"p{k}.png"))
        assert drawn.shape == PANEL_HW + (3,)
        assert (drawn[60, 70] == (0, 255, 0)).all()  # the far box's corner, green


@pytest.fixture(scope="module")
def train_set(tmp_path_factory):
    """Grey 2-class panels of 96-140 px with bright figures, train.csv and the
    tiny config (rotations and shears on, as training runs them)."""
    from tests.test_torch_train_cli import _panel

    root = tmp_path_factory.mktemp("td")
    cfg = tiny_config("resnet50")
    folder = root / "train" / cfg.img_types[0]
    folder.mkdir(parents=True)
    rng = np.random.default_rng(1)
    rows = []
    for k in range(4):
        img, boxes = _panel(rng, int(rng.integers(96, 140)), int(rng.integers(96, 140)), 4)
        write_png(str(folder / f"p{k}.png"), img)
        rows += [[f"p{k}.png", ("boat", "human")[i % 2], *b] for i, b in enumerate(boxes)]
    with open(root / "train.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["img_path", "label", "xmin", "ymin", "xmax", "ymax"])
        w.writerows(rows)
    cfg.save(str(root / "config.json"))
    return root, cfg


def _td_args(root):
    return ["--config-json", str(root / "config.json"), "--train-annot", str(root / "train.csv"),
            "--train-data", str(root / "train")]


def _jax_draws(cfg, seed):
    n = cfg.feat_size * cfg.feat_size * cfg.n_anchors
    return lambda i: jax_rpn_bits(jax.random.PRNGKey(seed + i), n)


def test_analyze_anchors_matches_jax(train_set):
    from radnet_torch.data.dataset import get_data

    root, cfg = train_set
    data, _, _ = get_data(str(root / "train.csv"), str(root / "train"), cfg.img_types)
    tcfg = TorchConfig.from_dict(cfg.to_dict())
    for seed in (27, 3):
        want = jtd.analyze_anchors(data, cfg, 0, seed)
        assert ttd.analyze_anchors(data, tcfg, 0, seed, device="cpu") == want
        assert len(want["kmeans_wh_clusters"]) == 3
    wh = np.random.default_rng(0).uniform(5, 90, (40, 2))
    np.testing.assert_array_equal(ttd._kmeans_wh(wh, 3, 5), jtd._kmeans_wh(wh, 3, 5))
    empty = [{"bboxes": []}]
    assert json.dumps(ttd.analyze_anchors(empty, tcfg, device="cpu")) == json.dumps(jtd.analyze_anchors(empty, cfg))


@pytest.mark.parametrize("seed", [27, 5])
def test_anchor_usage_and_report_match_jax_given_its_draws(train_set, monkeypatch, capsys, seed):
    monkeypatch.setattr(cv2, "resize", port_cv2_resize)
    root, cfg = train_set
    args = _td_args(root) + ["--analyze-anchors", "--usage-samples", "3", "--seed", str(seed)]
    reports = []
    for main, extra in ((jtd.main, {}), (ttd.main, {"draws": _jax_draws(cfg, seed)})):
        assert main(args + (["--device", "cpu"] if extra else []), **extra) == 0
        out = capsys.readouterr().out
        reports.append(json.loads(out[out.index("{"):]))
    assert reports[0] == reports[1]
    per = reports[1]["anchor_usage"]["positives_per_anchor"]
    assert sum(sum(d.values()) for d in per.values()) > 0


def test_test_data_samples_match_jax_and_pngs_written(train_set, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(cv2, "resize", port_cv2_resize)
    root, cfg = train_set
    lines = []
    for main, out, extra in ((jtd.main, tmp_path / "jax", {}),
                             (ttd.main, tmp_path / "port", {"draws": _jax_draws(cfg, 7)})):
        args = _td_args(root) + ["--n-samples", "3", "--seed", "7", "--out-dir", str(out)]
        assert main(args + (["--device", "cpu"] if extra else []), **extra) == 0
        lines.append([ln.replace(str(out), "OUT") for ln in capsys.readouterr().out.splitlines()
                      if not ln.startswith("Read ")])
    assert lines[0] == lines[1]
    assert any("n_pos=0" not in ln for ln in lines[1] if ln.startswith("sample"))
    for i in range(3):
        img = read_image(str(tmp_path / "port" / f"test_data_{i}.png"))
        assert img.shape == (cfg.canvas_size, cfg.canvas_size, 3)
        assert ((img == (0, 255, 0)).all(-1)).any()  # a ground-truth outline

    # Without a card the default device raises, as every entry point does.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttd.main(_td_args(root) + ["--n-samples", "1", "--out-dir", str(tmp_path / "x")])
    assert not os.path.exists(tmp_path / "x")
