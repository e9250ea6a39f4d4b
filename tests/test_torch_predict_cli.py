"""The port's predict command and image loading against radnet_tpu.

``radnet_torch.cli.predict`` on a scan directory of two tiny grey panels
must write the ``predictions.json`` that JAX ``RADNet.predict`` gives on the
same images and weights (labels and boxes equal, confidences within 1e-5,
as tests/test_torch_cascade.py), and the four prediction PNGs as the JAX
package draws those detections.
``cv2.resize`` is patched to the port's bicubic, so both see the same
prescaled panels.
"""

import json

import cv2
import numpy as np
import pytest
import torch

from radnet_torch.cli import predict as tpredict
from radnet_torch.data import dataset as tdataset
from radnet_torch.data.image import read_image
from radnet_torch.data.png import write_png
from radnet_torch.inference import save_radnet
from radnet_tpu.cli import common as jcommon
from radnet_tpu.cli import predict as jpredict
from radnet_tpu.data import dataset as jdataset
from radnet_tpu.inference import RADNet as JaxRADNet
from tests.test_torch_cascade import _assert_same_dets, _grey_panel
from tests.torch_port_util import jax_resnet, port_cv2_resize, port_model, torch_config

torch.set_num_threads(1)

TYPES = ["enhanced_topo_grey", "topo_grey", "blended_map_grey", "enhanced_topo", "topo",
         "blended_map"]


@pytest.mark.parametrize("img_type", TYPES)
def test_resolve_type_path_matches(img_type, tmp_path):
    assert tpredict.resolve_type_path(str(tmp_path), img_type) == \
        jpredict.resolve_type_path(str(tmp_path), img_type)


def test_resolve_type_path_rejects_unknown_type():
    with pytest.raises(ValueError):
        tpredict.resolve_type_path("scan", "infrared")


@pytest.mark.parametrize("absolute", [False, True])
def test_get_image_typed_layout(tmp_path, monkeypatch, absolute):
    """The type directory goes after the data root; a deeper layout is found
    by probing; the decoded panel equals OpenCV's BGR decode."""
    rng = np.random.default_rng(0)
    grey = rng.integers(0, 255, (20, 30), dtype=np.uint8)
    colour = rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)
    for sub, img in (("data/topo_grey/train/a.png", grey),
                     ("data/rgb/train/a.png", colour),
                     ("root/data/deep/topo_grey/b.png", grey)):
        (tmp_path / sub).parent.mkdir(parents=True, exist_ok=True)
        write_png(str(tmp_path / sub), img)
    monkeypatch.chdir(tmp_path)
    prefix = f"{tmp_path}/" if absolute else ""
    for rel, types in (("data/train/a.png", ["topo_grey"]),
                       ("data/train/a.png", ["rgb", "topo_grey"]),
                       ("root/data/deep/b.png", ["topo_grey"])):
        got = tdataset.get_image(prefix + rel, types)
        want = jdataset.get_image(prefix + rel, types)
        np.testing.assert_array_equal(got, want)
    assert tdataset._resolve_typed_path(prefix + "data/train/a.png", "rgb") == \
        jdataset._resolve_typed_path(prefix + "data/train/a.png", "rgb")
    with pytest.raises(FileNotFoundError):
        tdataset.get_image(prefix + "data/train/missing.png", ["topo_grey"])


def test_choose_img_type_weights():
    rng = np.random.default_rng(0)
    draws = [tdataset.choose_img_type(["a", "b", "c"], rng) for _ in range(2000)]
    assert abs(draws.count("a") / 2000 - 0.5) < 0.05
    assert tdataset.choose_img_type(["only"]) == "only"


def test_predict_cli_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(cv2, "resize", port_cv2_resize)
    cfg, model, params, bstats = jax_resnet(0)
    save_radnet(str(tmp_path / "models" / "m"), torch_config(cfg), port_model(cfg, params, bstats))

    scan = tmp_path / "scan"
    panels = {t: _grey_panel(seed)[..., 0] for seed, t in enumerate(cfg.img_types, start=6)}
    for t, grey in panels.items():
        path = tpredict.resolve_type_path(str(scan), t)
        path.parent.mkdir(parents=True, exist_ok=True)
        write_png(str(path), grey)
    viz = tpredict.resolve_type_path(str(scan), "blended_map_grey")
    viz.parent.mkdir(parents=True, exist_ok=True)
    write_png(str(viz), _grey_panel(9)[..., 0])

    rc = tpredict.main(["--models-path", str(tmp_path / "models"), "--model-name", "m",
                        "--scan-data-path", str(scan), "--device", "cpu"])
    assert rc == 0
    got = json.loads((scan / "arrays" / "predictions.json").read_text())

    jnet = JaxRADNet(cfg, model, params, bstats)
    want = jnet.predict([np.repeat(panels[t][..., None], 3, axis=-1) for t in cfg.img_types])
    assert len(want) > 0
    key = lambda d: (d["label"], d["x1"], d["y1"], d["x2"], d["y2"])  # noqa: E731
    want = [{"label": d["class"], "confidence": d["prob"], **{k: d[k] for k in ("x1", "y1", "x2", "y2")}}
            for d in want]
    assert sorted(map(key, got)) == sorted(map(key, want))
    np.testing.assert_allclose([d["confidence"] for d in sorted(got, key=key)],
                               [d["confidence"] for d in sorted(want, key=key)], rtol=0, atol=1e-5)
    for name in ("all", "boat", "human", "other"):
        out = read_image(str(scan / "img" / "predictions" / f"{name}_predictions.png"))
        assert out.shape == (130, 140, 3)
    drawn = read_image(str(scan / "img" / "predictions" / "all_predictions.png"))
    d = got[0]
    assert (drawn[d["y1"], d["x1"]] == 255).all()  # outline drawn at the corner

    # Every PNG as the JAX package draws the same detections on the same
    # image: labelled in all_predictions.png, outlined in the class's colour
    # by cv2.rectangle in the others.
    base = read_image(str(viz))
    dets = [{"class": d["label"], "prob": d["confidence"], **{k: d[k] for k in ("x1", "y1", "x2", "y2")}}
            for d in got]
    np.testing.assert_array_equal(drawn, jcommon.draw_detections(base.copy(), dets))
    for name, color, keep in (("boat", (28, 26, 228), lambda c: c == "boat"),
                              ("human", (184, 126, 55), lambda c: c == "human"),
                              ("other", (0, 127, 255), lambda c: c not in ("boat", "human"))):
        want = base.copy()
        for d in dets:
            if keep(d["class"]):
                cv2.rectangle(want, (d["x1"], d["y1"]), (d["x2"], d["y2"]), color, 8)
        out = read_image(str(scan / "img" / "predictions" / f"{name}_predictions.png"))
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("use_img_type", [False, True])
def test_predict_from_path_matches_jax(tmp_path, monkeypatch, use_img_type):
    """One panel per configured type (or the first type only), read from
    the typed layout and predicted."""
    import dataclasses

    from radnet_torch.inference import RADNet as TorchRADNet

    monkeypatch.setattr(cv2, "resize", port_cv2_resize)
    cfg, model, params, bstats = jax_resnet(0)
    cfg = dataclasses.replace(cfg, use_img_type=use_img_type)
    for seed, t in enumerate(cfg.img_types, start=4):
        path = tmp_path / "data" / t / "test" / "p.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        write_png(str(path), _grey_panel(seed, 80, 90)[..., 0])
    img_path = str(tmp_path / "data" / "test" / "p.png")
    tnet = TorchRADNet(torch_config(cfg), port_model(cfg, params, bstats), device="cpu")
    want = JaxRADNet(cfg, model, params, bstats).predict_from_path(img_path)
    got = tnet.predict_from_path(img_path)
    assert len(want) > 0
    _assert_same_dets(got, want)


def test_predict_cli_refuses_unported_flags(tmp_path):
    """The mesh flags run (tests/test_torch_mesh_cli.py); what stays refused:
    more cards than the host has, and a model axis that does not divide."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="needs 2 CUDA devices"):
        tpredict.main(["--scan-data-path", str(tmp_path), "--n-devices", "2"])
    with pytest.raises(ValueError, match="not divisible"):
        tpredict.main(["--scan-data-path", str(tmp_path), "--device", "cpu", "--n-devices", "3",
                       "--model-parallel", "2"])
