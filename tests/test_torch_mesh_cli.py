"""``cli.predict`` and ``cli.test`` on a 2 x 2 gloo mesh of spawned CPU
ranks (``--n-devices 4 --model-parallel 2``) against the same CLIs on one
device, on a tiny ResNet50 directory with decisive weights.

* ``cli.predict`` writes the files the single device writes: the same
  detections (boxes and classes equal, confidences within PANEL_PROB_TOL)
  and the drawn PNGs;
* ``cli.test`` gives the same mAP and per-class AP.

tests/test_torch_mesh_serve.py drives ``cli.serve`` and ``cli.test_rpn`` on
the same directories.
"""

import csv
import json
import shutil

import numpy as np
import pytest
import torch

from radnet_torch.cli import predict as tpredict
from radnet_torch.cli import test as ttest
from radnet_torch.cli.predict import resolve_type_path
from radnet_torch.data.png import write_png
from radnet_torch.inference import load_radnet, save_radnet
from tests.torch_mesh_ranks import grey_canvases
from tests.torch_port_util import jax_resnet, port_model, torch_config

torch.set_num_threads(1)

MESH_2X2 = ["--n-devices", "4", "--model-parallel", "2"]
# A panel detection's confidence, mesh against one device.  A merged
# detection averages tile probabilities, which the row-parallel float32 sums
# move by float noise: read 2.0e-5 at most on these panels (the port's single
# device against JAX's: 9.3e-6), where tiles hold 1e-5 (test_torch_mesh_resnet).
PANEL_PROB_TOL = 1e-4


def panel(seed: int, h: int = 96, w: int = 100) -> np.ndarray:
    """A grey ``(h, w)`` panel of bright blocks on a dark ground."""
    return grey_canvases(1, max(h, w), max(h, w), seed)[0, :h, :w, 0]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A model directory, a scan directory and a two-panel test set."""
    root = tmp_path_factory.mktemp("mesh_cli")
    cfg, _, params, bstats = jax_resnet(0)
    tcfg = torch_config(cfg)
    save_radnet(str(root / "models" / "m"), tcfg, port_model(cfg, params, bstats))
    for k, t in enumerate(tcfg.img_types + ["blended_map_grey"]):
        path = resolve_type_path(str(root / "scan"), t)
        path.parent.mkdir(parents=True, exist_ok=True)
        write_png(str(path), panel(k))
    net = load_radnet(str(root / "models" / "m"), device="cpu")
    folder = root / "test" / tcfg.img_types[0]
    folder.mkdir(parents=True)
    rows = []
    for k in range(2):
        grey = panel(10 + k)
        write_png(str(folder / f"p{k}.png"), grey)
        for j, d in enumerate(net.predict([np.repeat(grey[..., None], 3, -1)])):
            if j % 2 == 0:
                rows.append([f"p{k}.png", d["class"], d["x1"] + 1, d["y1"], d["x2"], d["y2"] - 1])
        rows.append([f"p{k}.png", "human", 3, 4, 30, 33])
    with open(root / "test.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["img_path", "label", "xmin", "ymin", "xmax", "ymax"])
        w.writerows(rows)
    return root


def copy_model(root, name):
    shutil.copytree(root / "models" / "m", root / "models" / name)
    return ["--device", "cpu", "--models-path", str(root / "models"), "--model-name", name]


def same_dets(got, want):
    """The same detection set in JSON form, confidences within PANEL_PROB_TOL."""
    def order(ds):
        return sorted(ds, key=lambda d: (d["label"], d["x1"], d["y1"], d["x2"], d["y2"]))

    got, want = order(got), order(want)
    key = ("label", "x1", "y1", "x2", "y2")
    assert [tuple(d[k] for k in key) for d in got] == [tuple(d[k] for k in key) for d in want]
    np.testing.assert_allclose([d["confidence"] for d in got], [d["confidence"] for d in want],
                               rtol=0, atol=PANEL_PROB_TOL)


def test_predict_cli_on_a_2x2_mesh_writes_the_single_device_files(root):
    outs = {}
    for name, flags in (("single", []), ("mesh", MESH_2X2)):
        scan = root / f"scan_{name}"
        shutil.copytree(root / "scan", scan)
        argv = ["--device", "cpu", "--models-path", str(root / "models"), "--model-name", "m",
                "--scan-data-path", str(scan)]
        assert tpredict.main(argv + flags) == 0
        outs[name] = json.loads((scan / "arrays" / "predictions.json").read_text())
        pngs = sorted(p.name for p in (scan / "img" / "predictions").iterdir())
        assert pngs == ["all_predictions.png", "boat_predictions.png", "human_predictions.png",
                        "other_predictions.png"]
    assert len(outs["single"]) > 0
    same_dets(outs["mesh"], outs["single"])


def test_test_cli_on_a_2x2_mesh_gives_the_single_device_map(root):
    accuracy = {}
    for name, flags in (("single", []), ("mesh", MESH_2X2)):
        argv = copy_model(root, f"test_{name}") + [
            "--test-annot", str(root / "test.csv"), "--test-data", str(root / "test")]
        assert ttest.main(argv + flags) == 0
        model = root / "models" / f"test_{name}"
        accuracy[name] = json.loads((model / "test_accuracy.json").read_text())
        assert sorted(p.name for p in (model / "test").iterdir()) == ["p0.png", "p1.png"]
        assert (model / "viz" / "precision_recall.svg").exists()
    assert accuracy["single"]["mAP"] > 0
    assert accuracy["mesh"].keys() == accuracy["single"].keys()
    for k, v in accuracy["single"].items():
        assert accuracy["mesh"][k] == pytest.approx(v, abs=1e-9), k
