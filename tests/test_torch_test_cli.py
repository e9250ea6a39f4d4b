"""A JAX model directory served by the port, and the port's evaluation CLI.

``scripts/export_jax_model.py`` turns a directory that the JAX package
wrote (``Config.save`` + ``save_checkpoint(dir/"ckpt_best", state)``) into
one the port loads: the same weights, ``ckpt_last`` as the fallback, an
int8 configuration's ``infer_quantize`` kept.  Then ``radnet_tpu.cli.test.main`` and
``radnet_torch.cli.test.main --device cpu`` evaluate the same small grey
test set from that one directory: the same detections (boxes equal,
confidences within 1e-5, as tests/test_torch_cascade.py), the same
``test_accuracy.json`` and ``test_accuracy_coco.json`` within 1e-9, and the
same ``--compare`` exit codes; the port's drawn panels equal the JAX
package's ``draw_detections`` of the same detections.  ``cv2.resize`` is patched to the port's
bicubic, so both see the same prescaled panels.
"""

import csv
import dataclasses
import html
import json
import os
import re
import shutil
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from radnet_torch.cli import test as ttest
from radnet_torch.config import Config as TorchConfig
from radnet_torch.data.image import read_image
from radnet_torch.data.png import write_png
from radnet_torch.evaluation import evaluate_detections
from radnet_torch.inference import load_radnet
from radnet_tpu.cli import common as jcommon
from radnet_tpu.cli import test as jtest
from radnet_tpu.config import Config as JaxConfig
from radnet_tpu.engine.checkpoint import save_checkpoint
from radnet_tpu.engine.train_state import create_train_state
from radnet_tpu.inference import load_radnet as jax_load_radnet
from tests.test_torch_cascade import _assert_same_dets, _grey_panel
from tests.torch_port_util import jax_resnet, port_cv2_resize, port_model

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
import export_jax_model  # noqa: E402

torch.set_num_threads(1)

N_PANELS = 3
PANEL_HW = (80, 90)  # four 64-px tiles, two batches


def _write_jax_model_dir(path, cfg, model, params, bstats):
    state = create_train_state(model, cfg, jax.random.PRNGKey(0))
    save_checkpoint(str(path / "ckpt_best"), state.replace(params=params, batch_stats=bstats))
    cfg.save(str(path / "config.json"))


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """A model directory written by the JAX package alone, then exported."""
    cfg, model, params, bstats = jax_resnet(0)
    path = tmp_path_factory.mktemp("models") / "jax_model"
    _write_jax_model_dir(path, cfg, model, params, bstats)
    assert not (path / "model.pt").exists()
    export_jax_model.main([str(path)])
    return path


def test_config_fields_match():
    """Every field of a JAX config.json reaches the port's Config."""
    jf = {f.name: f.type for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.type for f in dataclasses.fields(TorchConfig)}
    assert jf == tf
    cfg = jax_resnet(0)[0]
    assert TorchConfig.from_dict(cfg.to_dict()).to_dict() == cfg.to_dict()


def test_export_writes_the_bridged_weights(jax_dir):
    cfg, _, params, bstats = jax_resnet(0)
    want = port_model(cfg, params, bstats).state_dict()
    got = torch.load(jax_dir / "model.pt", weights_only=True)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], want[k].float(), rtol=0, atol=0, msg=k)
    net = load_radnet(str(jax_dir), device="cpu")
    assert net.C.to_dict() == cfg.to_dict()


def test_export_falls_back_to_ckpt_last_and_refuses_unported(jax_dir, tmp_path):
    cfg, _, params, bstats = jax_resnet(0)
    d = tmp_path / "last"
    shutil.copytree(jax_dir / "ckpt_best", d / "ckpt_last")
    shutil.copy(jax_dir / "config.json", d / "config.json")
    export_jax_model.main([str(d)])
    want = port_model(cfg, params, bstats).state_dict()
    got = torch.load(d / "model.pt", weights_only=True)
    for k in ("trunk.conv1.weight", "head.dense_class.weight"):
        torch.testing.assert_close(got[k], want[k].float(), rtol=0, atol=0)

    # An int8 configuration exports the float model's weights and keeps its
    # infer_quantize, which the port's load_radnet then reads.
    raw = cfg.to_dict()
    raw["infer_quantize"] = "int8"
    (d / "config.json").write_text(json.dumps(raw))
    export_jax_model.export(str(d))
    got = torch.load(d / "model.pt", weights_only=True)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k].float()) for k in want)
    assert json.loads((d / "config.json").read_text())["infer_quantize"] == "int8"
    net = load_radnet(str(d), device="cpu")
    assert net.C.infer_quantize == "int8" and net.model.head_quant == "int8"
    raw = cfg.to_dict()
    raw["renamed_field"] = 1
    (d / "config.json").write_text(json.dumps(raw))
    with pytest.raises(SystemExit, match="renamed_field"):
        export_jax_model.export(str(d))


def test_load_radnet_names_the_exporter(tmp_path):
    jax_resnet(0)[0].save(str(tmp_path / "config.json"))
    with pytest.raises(FileNotFoundError, match="export_jax_model.py"):
        load_radnet(str(tmp_path), device="cpu")


@pytest.fixture(scope="module")
def nets(jax_dir):
    """Both packages' RADNet, each loaded from the one directory by its own
    load_radnet; the CLIs get these, so each package compiles once."""
    return jax_load_radnet(str(jax_dir)), load_radnet(str(jax_dir), device="cpu")


@pytest.fixture
def cli_nets(nets, monkeypatch):
    import radnet_torch.inference

    monkeypatch.setattr(cv2, "resize", port_cv2_resize)
    monkeypatch.setattr(jtest, "load_radnet", lambda *a, **k: nets[0])
    monkeypatch.setattr(radnet_torch.inference, "load_radnet", lambda *a, **k: nets[1])
    return nets


@pytest.fixture(scope="module")
def test_set(nets, tmp_path_factory):
    """Grey panels whose ground truth is half the detections, moved a few
    pixels, plus boxes nothing detects; test.csv beside them."""
    tnet = nets[1]
    root = tmp_path_factory.mktemp("eval")
    folder = root / "test" / tnet.C.img_types[0]
    folder.mkdir(parents=True)
    rng = np.random.default_rng(5)
    rows = []
    for k in range(N_PANELS):
        panel = _grey_panel(40 + k, *PANEL_HW)
        write_png(str(folder / f"p{k}.png"), panel[..., 0])
        for j, d in enumerate(tnet.predict([panel])):
            if j % 2 == 0:
                x1, y1, x2, y2 = (d[c] + int(rng.integers(-2, 3)) for c in ("x1", "y1", "x2", "y2"))
                rows.append([f"p{k}.png", d["class"], x1, y1, x2, y2])
        rows.append([f"p{k}.png", "human", 3, 4, 30, 33])
    with open(root / "test.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["img_path", "label", "xmin", "ymin", "xmax", "ymax"])
        w.writerows(rows)
    return root


def _run(main, module, jax_dir, test_set, monkeypatch, extra=()):
    """main(...) on the test set; (rc, detections it evaluated, stdout-free
    accuracy dicts)."""
    seen = {}
    real = module.evaluate_detections

    def spy(dets, gt, thr):
        seen["dets"], seen["gt"] = list(dets), list(gt)
        return real(dets, gt, thr)

    monkeypatch.setattr(module, "evaluate_detections", spy)
    rc = main(["--models-path", str(jax_dir.parent), "--model-name", jax_dir.name,
               "--test-annot", str(test_set / "test.csv"), "--test-data", str(test_set / "test"),
               "--coco-map", *extra])
    acc = json.loads((jax_dir / "test_accuracy.json").read_text())
    coco = json.loads((jax_dir / "test_accuracy_coco.json").read_text())
    return rc, seen, acc, coco


def _assert_close_tree(got, want, tol=1e-9):
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_close_tree(got[k], want[k], tol)
    elif want is None:
        assert got is None
    else:
        assert abs(got - want) <= tol


def test_test_cli_matches_jax(jax_dir, test_set, cli_nets, monkeypatch, capsys):
    (jax_dir / "test").mkdir(exist_ok=True)  # the JAX CLI writes its PNGs there
    j_rc, j_seen, j_acc, j_coco = _run(jtest.main, jtest, jax_dir, test_set, monkeypatch)
    j_out = capsys.readouterr().out
    shutil.rmtree(jax_dir / "test")  # the port creates the folder itself

    drawn = {}  # panel image before drawing, and the detections drawn on it
    real_draw = ttest.draw_detections

    def draw_spy(img, detections):
        drawn[len(drawn)] = (img.copy(), list(detections))
        return real_draw(img, detections)

    monkeypatch.setattr(ttest, "draw_detections", draw_spy)
    t_rc, t_seen, t_acc, t_coco = _run(
        ttest.main, ttest, jax_dir, test_set, monkeypatch, ["--device", "cpu"])
    t_out = capsys.readouterr().out
    assert j_rc == t_rc == 0
    assert len(j_seen["dets"]) > 0 and j_seen["gt"] == t_seen["gt"]
    _assert_same_dets(t_seen["dets"], j_seen["dets"])
    assert 0.0 < t_acc["mAP"] < 1.0
    assert set(t_acc) == {"boat", "human", "mAP"}
    _assert_close_tree(t_acc, j_acc)
    _assert_close_tree(t_coco, j_coco)
    assert t_coco["AP50"] == t_acc["mAP"] and len(t_coco["per_threshold"]) == 10
    for line in ("mAP: ", "mAP@[.5:.95]: ", "Average prediction time: ",
                 "Steady-state prediction time (excl. first panel): "):
        assert line in j_out and line in t_out

    for k in range(N_PANELS):  # one drawn panel each
        assert read_image(str(jax_dir / "test" / f"p{k}.png")).shape == PANEL_HW + (3,)
    # each as the JAX package draws the same detections on the same panel
    assert len(drawn) == N_PANELS and sum(len(d) for _, d in drawn.values()) == len(t_seen["dets"])
    for k, (img, dets) in drawn.items():
        np.testing.assert_array_equal(read_image(str(jax_dir / "test" / f"p{k}.png")),
                                      jcommon.draw_detections(img, dets))

    # The curve's points ride in the SVG unrounded; legend and title as JAX's.
    svg = (jax_dir / "viz" / "precision_recall.svg").read_text()
    result = evaluate_detections(t_seen["dets"], t_seen["gt"], 0.5)
    payload = re.search(r'data-curves="([^"]*)"', svg).group(1)
    assert json.loads(html.unescape(payload)) == result["curves"]
    assert f"mAP: {100 * result['mAP']:.2f} %" in svg
    for key, ap in result["per_class"].items():
        assert html.escape(f"{key}: {100 * ap:.2f} %") in svg


@pytest.mark.parametrize("bump, want_rc", [(0.0, 0), (0.01, 2)])
def test_compare_exit_codes_match_jax(jax_dir, test_set, cli_nets, tmp_path, bump, want_rc):
    (jax_dir / "test").mkdir(exist_ok=True)
    base = ["--models-path", str(jax_dir.parent), "--model-name", jax_dir.name,
            "--test-annot", str(test_set / "test.csv"), "--test-data", str(test_set / "test"),
            "--limit", "1"]
    assert ttest.main(base + ["--device", "cpu"]) == 0
    ref = json.loads((jax_dir / "test_accuracy.json").read_text())
    ref["mAP"] += bump
    ref_path = tmp_path / "ref.json"
    ref_path.write_text(json.dumps(ref))
    assert ttest.main(base + ["--device", "cpu", "--compare", str(ref_path)]) == want_rc
    assert jtest.main(base + ["--compare", str(ref_path)]) == want_rc


def test_test_cli_refuses_unported_flags(tmp_path):
    """The mesh flags run (tests/test_torch_mesh_cli.py); what stays refused:
    more cards than the host has, and a model axis that does not divide."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for flags, error, match in ((["--n-devices", "2"], SystemExit, "needs 2 CUDA devices"),
                                (["--device", "cpu", "--n-devices", "3", "--model-parallel", "2"],
                                 ValueError, "not divisible")):
        with pytest.raises(error, match=match):
            ttest.main(["--models-path", str(tmp_path), *flags])
