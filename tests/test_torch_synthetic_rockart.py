"""radnet_torch's synthetic rock-art set against OpenCV and the JAX package's
scripts/make_synthetic_rockart.py, on the CPU.

* ``radnet_torch.data.raster``'s ``line``, ``circle`` and ``ellipse``
  against ``cv2.line``, ``cv2.circle`` and ``cv2.ellipse`` (``LINE_8``) on
  seeded sweeps: thickness 1-35, end points and centres near and past the
  edges, arcs of 0-180 and 0-360 degrees and others, radii and axes 0-110,
  grey and 3-channel images, random backgrounds and colours: 0 differing
  pixels.  A 1-px circle keeps its centre inside the image: there OpenCV's
  clipped branch writes past the row it draws.
* ``gaussian_blur_u8`` against ``cv2.GaussianBlur(img, (0, 0), sigma)`` on
  random images of even and odd sizes: 0 differing pixels.
* ``make_panel`` against the JAX script's for several seeds at 600 x 600
  and once at 2400 x 2400: pixels and boxes equal; ``main`` on a tiny set:
  the same tree, CSV bytes, decoded PNGs and output lines.
* Under the committed config (``radnet_torch/configs/synthetic_rockart.json``),
  the anchor report of ``cli.test_data --analyze-anchors`` on a generated
  train split equals the JAX package's, the per-anchor positives too with
  JAX's subsample keys replayed; ``scripts/anchor_coverage.py``'s shares
  on that split, under this config and the default one, equal those of
  JAX's anchor grid and IoU; and the first joint step on a batch sampled
  from the set, at tiny widths, equals JAX's on the same weights: the RPN
  targets equal, every metric within 5e-6 of JAX's (5e-6 relative above 1,
  as tests/test_torch_alternating.py holds a step's losses) but the RPN
  regression loss and the total, which are held within 5e-6 of the loss
  evaluated in float64 on the same targets, and from JAX's by no more than
  JAX's own distance from float64 plus 5e-6: with 42 anchors XLA's float32
  sum of the denominator lands 1.6e-5 from float64 (ROADMAP Queue 3).
"""

import contextlib
import csv
import importlib.util
import io
import json
import pathlib
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from radnet_torch.cli import make_synthetic_rockart as mk
from radnet_torch.cli import test_data as ttd
from radnet_torch.config import Config as TorchConfig
from radnet_torch.data import raster
from radnet_torch.data.dataset import get_data
from radnet_torch.data.pipeline import batch_samples, tile_sample_generator
from radnet_torch.engine import steps as tsteps
from radnet_torch.engine import train_state as tstate
from radnet_tpu.cli import test_data as jtd
from radnet_tpu.config import Config as JaxConfig
from radnet_tpu.engine import steps as jsteps
from radnet_tpu.engine.train_state import create_train_state
from radnet_tpu.geometry import iou_matrix as jax_iou_matrix
from radnet_tpu.models.detector import build_model as jax_build_model
from radnet_tpu.ops.anchors import image_anchors_xyxy as jax_image_anchors_xyxy
from tests.test_torch_vgg import dropout_masks
from tests.torch_port_util import jax_rpn_bits, jax_step_draws, port_cv2_resize, port_model, to_np
from tests.util import tiny_config

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG_JSON = ROOT / "radnet_torch" / "configs" / "synthetic_rockart.json"
# The tiny widths of tests/util.py laid over the committed config.
TINY_FIELDS = ("canvas_size", "img_size", "batch_size", "max_gt_boxes", "n_rois", "pre_nms_top_n",
               "post_nms_top_n", "max_detections_per_tile", "infer_tile_batch", "compute_dtype",
               "vgg_fc_dim")


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_make_synthetic_rockart",
                                                  ROOT / "scripts" / "make_synthetic_rockart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _differing(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.any(a != b, axis=-1).sum() if a.ndim == 3 else (a != b).sum())


def _canvas(rng, channels: int):
    h, w = int(rng.integers(40, 200)), int(rng.integers(40, 200))
    shape = (h, w, channels) if channels > 1 else (h, w)
    return rng.integers(0, 256, shape).astype(np.uint8)


def _line_case(rng, img, t):
    h, w = img.shape[:2]
    m = 60
    p1 = (int(rng.integers(-m, w + m)), int(rng.integers(-m, h + m)))
    p2 = (int(rng.integers(-m, w + m)), int(rng.integers(-m, h + m)))
    return (p1, p2), (p1, p2)


def _circle_case(rng, img, t):
    h, w = img.shape[:2]
    m = 0 if t == 1 else 25
    c = (int(rng.integers(-m, w + m)), int(rng.integers(-m, h + m)))
    r = int(rng.integers(0, 111))
    return (c, r), (c, r)


def _ellipse_case(rng, img, t, arc=None):
    h, w = img.shape[:2]
    c = (int(rng.integers(-25, w + 25)), int(rng.integers(-25, h + 25)))
    axes = (int(rng.integers(0, 111)), int(rng.integers(0, 111)))
    angle = int(rng.integers(0, 360)) if rng.random() < 0.3 else 0
    start, end = arc if arc else (int(rng.integers(-40, 360)), int(rng.integers(-40, 420)))
    args = (c, axes, angle, start, end)
    return args, args


PRIMITIVES = {
    "line": (cv2.line, raster.line, _line_case),
    "circle": (cv2.circle, raster.circle, _circle_case),
    "ellipse_0_180": (cv2.ellipse, raster.ellipse, lambda r, i, t: _ellipse_case(r, i, t, (0, 180))),
    "ellipse_0_360": (cv2.ellipse, raster.ellipse, lambda r, i, t: _ellipse_case(r, i, t, (0, 360))),
    "ellipse_any_arc": (cv2.ellipse, raster.ellipse, _ellipse_case),
}


@pytest.mark.parametrize("channels", [1, 3], ids=["grey", "bgr"])
@pytest.mark.parametrize("name", list(PRIMITIVES))
def test_primitive_equals_cv2(name, channels):
    """Every thickness 1-35, four cases each, on random canvases."""
    cv_fn, fn, case = PRIMITIVES[name]
    rng = np.random.default_rng(sorted(PRIMITIVES).index(name) * 10 + channels)
    bad = []
    for t in range(1, 36):
        for _ in range(4):
            base = _canvas(rng, channels)
            color = int(rng.integers(0, 256))
            cv_args, args = case(rng, base, t)
            want, got = base.copy(), base.copy()
            cv_fn(want, *cv_args, color, t)
            out = fn(got, *args, color, t)
            assert out is got
            if _differing(got, want):
                bad.append((t, args, _differing(got, want)))
    assert not bad, bad[:5]


def test_script_strokes_near_the_edges_equal_cv2():
    """The script's own strokes (thickness max(2, min(w, h) // 12) up to 35)
    with figures 10 px from the panel's edges, where caps and rings clip."""
    rng = np.random.default_rng(7)
    for k in range(40):
        want = np.full((300, 300, 3), 40, np.uint8)
        got = want.copy()
        w, h = int(rng.integers(60, 280)), int(rng.integers(60, 280))
        x1 = int(rng.choice([10, 300 - w - 10]))
        y1 = int(rng.choice([10, 300 - h - 10]))
        th = max(2, min(w, h) // 12)
        for f, g, args in ((cv2.ellipse, raster.ellipse,
                            ((x1 + w // 2, y1 + h // 2), (w // 2, h // 2), 0, 0, 360 if k % 2 else 180)),
                           (cv2.line, raster.line, ((x1, y1 + h // 2), (x1 + w, y1 + h // 2))),
                           (cv2.line, raster.line, ((x1 + w // 2, y1), (x1, y1 + h))),
                           (cv2.circle, raster.circle, ((x1 + w // 2, y1 + w // 4), max(3, w // 4)))):
            f(want, *args, 200, th)
            g(got, *args, 200, th)
        assert _differing(got, want) == 0, (k, w, h, x1, y1)


def test_sin_table_equals_cv2s():
    """``ellipse_poly``'s degree table: cv2.ellipse2Poly at axes of 2^20
    rounds each entry to 2^-20."""
    pts = cv2.ellipse2Poly((0, 0), (1 << 20, 1 << 20), 0, 0, 360, 1)
    want = raster.ellipse_poly((0.0, 0.0), (float(1 << 20), float(1 << 20)), 0, 0, 360, 1)
    np.testing.assert_array_equal(pts, np.rint(np.asarray(want)).astype(np.int64))


@pytest.mark.parametrize("channels", [1, 3], ids=["grey", "bgr"])
@pytest.mark.parametrize("hw", [(37, 52), (64, 64), (101, 77), (600, 601), (19, 30)])
def test_gaussian_blur_equals_cv2(hw, channels):
    rng = np.random.default_rng(hw[0] * channels)
    img = rng.integers(0, 256, hw + ((channels,) if channels > 1 else ())).astype(np.uint8)
    got = raster.gaussian_blur_u8(img, 3)
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert _differing(got, cv2.GaussianBlur(img, (0, 0), 3)) == 0


def test_gaussian_kernel_is_19_taps_summing_to_256():
    k = raster.gaussian_kernel_u8(3)
    assert len(k) == 19 and int(k.sum()) == 256 and list(k) == list(k[::-1])


@pytest.mark.parametrize("seed, size", [(0, 600), (1, 600), (2, 600), (5, 600), (0, 2400)])
def test_make_panel_equals_jax_script(seed, size):
    script = _jax_script()
    want, want_rows = script.make_panel(np.random.default_rng(seed), size, 10)
    got, rows = mk.make_panel(np.random.default_rng(seed), size, 10)
    assert rows == want_rows
    assert got.dtype == want.dtype and got.shape == want.shape == (size, size, 3)
    assert _differing(got, want) == 0
    # The strokes are in channel 0 only, on grey noise: not a grey panel.
    assert (got[..., 1] == got[..., 2]).all() and (got[..., 0] != got[..., 1]).any()


def _tree(root: pathlib.Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def test_main_equals_jax_script(tmp_path, monkeypatch, capsys):
    args = ["--panel-size", "600", "--n-train", "2", "--n-val", "1", "--n-test", "1", "--seed", "3"]
    script = _jax_script()
    monkeypatch.setattr(sys, "argv", ["make_synthetic_rockart.py", "--root", str(tmp_path / "jax"), *args])
    assert script.main() == 0
    want_out = capsys.readouterr().out
    assert mk.main(["--root", str(tmp_path / "port"), *args]) == 0
    assert capsys.readouterr().out == want_out
    assert want_out.splitlines()[0] == "train: 2 panels, 20 boxes"
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    assert _tree(proot) == _tree(jroot)
    for split in ("train", "val", "test"):
        assert (proot / f"{split}.csv").read_bytes() == (jroot / f"{split}.csv").read_bytes()
    pngs = [p for p in _tree(jroot) if p.endswith(".png")]
    assert len(pngs) == 4
    for p in pngs:
        want = cv2.imread(str(jroot / p), cv2.IMREAD_UNCHANGED)
        got = cv2.imread(str(proot / p), cv2.IMREAD_UNCHANGED)
        assert got.shape == want.shape and _differing(got, want) == 0, p


def test_csv_of_no_rows_is_pandas(tmp_path):
    import pandas as pd

    mk.write_csv(str(tmp_path / "a.csv"), [])
    pd.DataFrame([]).to_csv(str(tmp_path / "b.csv"), index=False)
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()


@pytest.fixture(scope="module")
def synth_set(tmp_path_factory):
    """Two 2400 x 2400 train panels and one val and test panel, from the
    port's CLI."""
    root = tmp_path_factory.mktemp("synth")
    with contextlib.redirect_stdout(io.StringIO()):
        assert mk.main(["--root", str(root), "--n-train", "2", "--n-val", "1", "--n-test", "1"]) == 0
    return root


def _td_args(root):
    return ["--config-json", str(CONFIG_JSON), "--train-annot", str(root / "train.csv"),
            "--train-data", str(root / "data" / "train")]


def test_anchor_report_equals_jax(synth_set, monkeypatch, capsys):
    """The committed config's report on the generated train split, with 2
    usage samples (JAX's subsample keys replayed into the port)."""
    monkeypatch.setattr(cv2, "resize", port_cv2_resize)
    cfg = JaxConfig.load(str(CONFIG_JSON))
    n = cfg.feat_size * cfg.feat_size * cfg.n_anchors
    args = _td_args(synth_set) + ["--analyze-anchors", "--usage-samples", "2", "--seed", "27"]
    reports = []
    for main, extra in ((jtd.main, {}),
                        (ttd.main, {"draws": lambda i: jax_rpn_bits(jax.random.PRNGKey(27 + i), n)})):
        assert main(args + (["--device", "cpu"] if extra else []), **extra) == 0
        out = capsys.readouterr().out
        reports.append(json.loads(out[out.index("{"):]))
    assert reports[0] == reports[1]
    assert reports[1]["n_boxes"] == 20 and reports[1]["configured_scales"] == cfg.anchor_box_scales
    per = reports[1]["anchor_usage"]["positives_per_anchor"]
    assert sum(sum(d.values()) for d in per.values()) > 0


def _anchor_coverage_script():
    spec = importlib.util.spec_from_file_location("anchor_coverage", ROOT / "scripts" / "anchor_coverage.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("config_json", [CONFIG_JSON, None], ids=["committed", "default"])
def test_anchor_coverage_equals_jax_anchor_grid(synth_set, config_json):
    """scripts/anchor_coverage.py on the generated train split against JAX's
    anchor grid (ops/anchors.py) and IoU (geometry.iou_matrix) under the
    RPN's rule IoU > rpn_max_overlap: each box at a centre cell of the grid,
    centred on its anchors and at the script's 8 x 8 placements."""
    cov = _anchor_coverage_script()
    with open(synth_set / "train.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    got = cov.coverage(rows, TorchConfig.load(str(config_json)) if config_json else TorchConfig())

    cfg = JaxConfig.load(str(config_json)) if config_json else JaxConfig()
    f, stride = cfg.feat_size, cfg.rpn_stride
    anchors = jax_image_anchors_xyxy(f, f, cfg.anchor_box_scales, cfg.anchor_box_ratios,
                                     stride).reshape(-1, 4)
    centre = (f // 2 + 0.5) * stride
    offs = (np.arange(cov.N_PLACEMENTS) + 0.5) / cov.N_PLACEMENTS * stride
    places = np.array([(0.0, 0.0)] + [(ox, oy) for ox in offs for oy in offs]) + centre
    scale = cfg.img_size / float(cfg.tile_size)
    per = {}
    for r in rows:
        w = (int(r["xmax"]) - int(r["xmin"])) * scale
        h = (int(r["ymax"]) - int(r["ymin"])) * scale
        boxes = np.concatenate([places - (w / 2, h / 2), places + (w / 2, h / 2)], axis=1)
        hit = np.asarray(jax_iou_matrix(boxes, anchors)).max(1) > cfg.rpn_max_overlap
        per.setdefault(r["label"], []).append((hit[0], float(hit[1:].mean())))

    def summary(items):
        return {"n_boxes": len(items), "centred": round(float(np.mean([c for c, _ in items])), 4),
                "on_grid": round(float(np.mean([g for _, g in items])), 4)}

    every = [x for items in per.values() for x in items]
    assert {k: got[k] for k in ("n_boxes", "centred", "on_grid")} == summary(every)
    assert got["by_class"] == {k: summary(v) for k, v in sorted(per.items())}
    assert got["n_boxes"] == 20 and 0 < got["on_grid"]


def _tiny_chain_configs():
    """The committed config with tests/util.py's tiny widths: (JAX's, the port's)."""
    d = json.loads(CONFIG_JSON.read_text())
    tiny = tiny_config("vgg16").to_dict()
    d.update({k: tiny[k] for k in TINY_FIELDS})
    return JaxConfig.from_dict(d), TorchConfig.from_dict(d)


def _no_poisson_key(cfg, shape):
    """The first step key from PRNGKey(11) whose photometric draws pick no
    Poisson noise (that sampler cannot be replayed)."""
    for k in range(11, 60):
        key = jax.random.PRNGKey(k)
        d = jax_step_draws(key, cfg, shape[0], shape, grey=True).photometric
        if not ((d.noise_coin < 0.5) & (d.noise_pick == 2)).any():
            return key
    raise AssertionError("no key without Poisson noise")


def test_first_joint_step_equals_jax(synth_set):
    cfg, tcfg = _tiny_chain_configs()
    assert tcfg.to_dict() == cfg.to_dict() and tcfg.network == "vgg16" and tcfg.n_anchors == 42
    data, class_count, _ = get_data(str(synth_set / "train.csv"), str(synth_set / "data" / "train"),
                                    tcfg.img_types)
    gen = tile_sample_generator(data, tcfg, class_count, tcfg.class_mapping, train_mode=True, seed=4)
    batch = {k: np.asarray(v) for k, v in batch_samples([next(gen) for _ in range(tcfg.batch_size)]).items()}
    assert batch["gt_mask"].any() and batch["image"].dtype == np.uint8

    model = jax_build_model(cfg)
    jstate = create_train_state(model, cfg, jax.random.PRNGKey(0), learning_rate=5e-5)
    params, bstats = jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)
    key = _no_poisson_key(cfg, batch["image"].shape)
    with dropout_masks() as rec:
        _, want = jsteps.make_train_step(model, cfg)(jstate, batch, key)
        want = jax.device_get(want)
        jax.effects_barrier()
    draws = jax_step_draws(key, cfg, tcfg.batch_size, batch["image"].shape, grey=True)
    draws.head_masks = rec.pair()

    state = tstate.create_train_state(tcfg, torch.Generator(), "cpu", learning_rate=5e-5,
                                      model=port_model(cfg, params, bstats).train())
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tsteps.make_train_step(state, tcfg)(tbatch, draws)
    assert float(want["loss_rpn_cls"]) > 0 and float(want["loss_detector_cls"]) > 0

    # The RPN targets of that step: JAX's from the step key, the port's from
    # the replayed subsample words.
    rng_t = jax.random.split(key, 3)[0]
    anchors = jsteps._device_anchors(cfg)
    sv = batch["sample_valid"].astype(np.float32)
    want_cls, want_regr = jax.device_get(jsteps._batch_rpn_targets(cfg, batch, rng_t, anchors[0], sv))
    got_cls, got_regr = tsteps._rpn_targets(tcfg, tbatch, draws, tsteps.step_constants(tcfg, "cpu"),
                                            torch.from_numpy(sv))
    np.testing.assert_array_equal(to_np(got_cls), want_cls)
    np.testing.assert_array_equal(to_np(got_regr), want_regr)
    assert want_cls[..., :tcfg.n_anchors].sum() > 0

    # The RPN regression loss in float64 from those targets: the plain init's
    # regression layer is zero, so the prediction is 0.  Its denominator adds
    # 1e-4 for each of the 5376 channels of 42 anchors, a float32 sum that
    # XLA rounds 1.6e-5 from float64 here (ROADMAP Queue 3); the port's lands
    # within 5e-6 of float64.
    assert not any(np.any(v) for v in params["rpn"]["rpn_out_regress"].values())
    a = tcfg.n_anchors
    mask, x = want_regr[..., :4 * a].astype(np.float64), want_regr[..., 4 * a:].astype(np.float64)
    exact = (mask * np.where(np.abs(x) <= 1, 0.5 * x * x, np.abs(x) - 0.5)).sum() / (1e-4 + mask).sum()
    exact = {"loss_rpn_regr": exact,
             "total_loss": exact + sum(float(want[k]) for k in ("loss_rpn_cls", "loss_detector_cls",
                                                               "loss_detector_regr"))}
    for k in tsteps.METRIC_KEYS:
        g, w = float(got[k]), float(want[k])
        if k in exact:
            assert abs(g - exact[k]) <= 5e-6 * max(1.0, abs(exact[k])), (k, g, exact[k])
            assert abs(g - w) <= abs(w - exact[k]) + 5e-6 * max(1.0, abs(w)), (k, g, w, exact[k])
        else:
            assert abs(g - w) <= 5e-6 * max(1.0, abs(w)), (k, g, w)
