"""``--quantize int8`` through the port's entry points on the CPU, against the
JAX package's on one model directory.

A tiny VGG16 directory written by the JAX package alone is converted by
``scripts/export_jax_model.py``; then ``load_radnet(quantize=...)`` follows
the JAX package's override (tests/test_quant.py), ``quantize_from_args``
maps as tests/test_cli_paths.py, and ``cli.serve``, ``cli.predict`` and
``cli.test`` with ``--quantize int8`` give the JAX CLIs' detections (the
same sets, probabilities within tests/test_torch_quant.py's PROB_TOL) and
mAP (within PROB_TOL: an AP moves only where two detections trade places).
The eval step of a model built with ``infer_quantize="int8"`` gives JAX's
eval losses within 1e-4 relative, the float steps' tolerance (read: at most
4.5e-6), at one thread and at torch's default thread count.  The losses
that the int8 head reaches are held on one head input, JAX's, against
JAX's head run op by op: some stage-5 activations of the tiny ResNet50 sit
within 4e-6 of an int8 rounding boundary (25.4999966 against 25.5000008),
so float32 noise decides how their codes round.  The trunk's sums, whose
order follows the thread count, move the port's head input by that much,
and JAX's own head, jitted and run op by op on one input, rounds such codes
apart and gives probabilities 2% apart (one code moves the class loss by
2e-4 relative).  The port's head reproduces the op-by-op codes bit for bit.
``cv2.resize`` is patched to the port's bicubic, so both packages see the
same prescaled panels.
"""

import csv
import dataclasses
import io
import json
import os
import shutil
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flax import linen as nn

from radnet_torch.cli import common as tcommon
from radnet_torch.cli import predict as tpredict
from radnet_torch.cli import serve as tserve
from radnet_torch.cli import test as ttest
from radnet_torch.config import Config as TorchConfig
from radnet_torch.data.png import write_png
from radnet_torch.engine import steps as tsteps
from radnet_torch.engine import train_state as tstate
from radnet_torch.inference import load_radnet
from radnet_torch.models.detector import build_model
from radnet_torch.models.quant import QuantConv, QuantDense
from radnet_tpu.cli import predict as jpredict
from radnet_tpu.cli import serve as jserve
from radnet_tpu.cli import test as jtest
from radnet_tpu.engine import steps as jsteps
from radnet_tpu.models.detector import build_model as jax_build_model
from tests.test_torch_cascade import _assert_same_dets, _grey_panel
from tests.test_torch_quant import PROB_TOL
from tests.test_torch_test_cli import _write_jax_model_dir
from tests.torch_port_util import (jax_detector, jax_step_draws, jax_vgg, port_cv2_resize,
                                   port_model, torch_config)
from tests.util import synthetic_batch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
import export_jax_model  # noqa: E402

DEFAULT_THREADS = torch.get_num_threads()
torch.set_num_threads(1)

# The metrics that the RoI head does not reach.
HEADLESS_KEYS = ("loss_rpn_cls", "loss_rpn_regr", "mean_overlapping_bboxes")


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """A tiny VGG16 directory the JAX package wrote, then exported."""
    cfg, model, params, bstats = jax_vgg(0)
    path = tmp_path_factory.mktemp("models") / "vgg"
    _write_jax_model_dir(path, cfg, model, params, bstats)
    export_jax_model.main([str(path)])
    return path


@pytest.fixture
def same_resize(monkeypatch, tmp_path):
    monkeypatch.setattr(cv2, "resize", port_cv2_resize)
    monkeypatch.setenv("RADNET_COMPILE_CACHE", str(tmp_path / "jax_cache"))


def _dets(records):
    """serve/predict JSON records -> the detection dicts of predict."""
    return [{"class": d["label"], "prob": d["confidence"], **{k: d[k] for k in ("x1", "y1", "x2", "y2")}}
            for d in records]


def test_load_radnet_quantize_override(jax_dir, tmp_path):
    """tests/test_quant.py's override: "int8" sets it, None keeps the saved
    value, "" clears it; the weights are the same either way."""
    r = load_radnet(str(jax_dir), device="cpu", quantize="int8")
    assert r.C.infer_quantize == "int8" and r.model.head_quant == "int8"
    assert isinstance(r.model.head.fc1, QuantDense) and isinstance(r.model.head.fc2, QuantDense)
    weights = r.model.state_dict()
    for quantize in (None, ""):
        r = load_radnet(str(jax_dir), device="cpu", quantize=quantize)
        assert r.C.infer_quantize is None and r.model.head_quant is None
        assert type(r.model.head.fc1).__name__ == "Dense"
        assert r.model.state_dict().keys() == weights.keys()
        assert all(torch.equal(v, weights[k]) for k, v in r.model.state_dict().items())

    saved = tmp_path / "saved_int8"
    shutil.copytree(jax_dir, saved)
    raw = json.loads((saved / "config.json").read_text())
    raw["infer_quantize"] = "int8"
    (saved / "config.json").write_text(json.dumps(raw))
    assert load_radnet(str(saved), device="cpu").C.infer_quantize == "int8"
    assert load_radnet(str(saved), device="cpu", quantize="").C.infer_quantize is None


def test_resnet50_int8_model_builds():
    cfg = TorchConfig(infer_quantize="int8", compute_dtype="float32", canvas_size=64)
    model = build_model(cfg)
    convs = [n for n, m in model.head.named_modules() if isinstance(m, QuantConv)]
    assert len(convs) == 10  # s5a: 4, s5b and s5c: 3 each
    assert not any(isinstance(m, QuantConv) for m in model.trunk.modules())
    with pytest.raises(ValueError, match="infer_quantize"):
        build_model(dataclasses.replace(cfg, infer_quantize="fp8"))


def test_quantize_arg_mapping():
    class A:
        quantize = None

    assert tcommon.quantize_from_args(A()) is None
    A.quantize = "int8"
    assert tcommon.quantize_from_args(A()) == "int8"
    A.quantize = "none"
    assert tcommon.quantize_from_args(A()) == ""  # load_radnet maps "" -> cleared
    for module in (tserve, tpredict, ttest):
        p = module.build_argparser()
        base = ["--scan-data-path", "s"] if module is tpredict else []
        assert p.parse_args(base).quantize is None
        assert p.parse_args(base + ["--quantize", "int8"]).quantize == "int8"
        assert p.parse_args(base + ["--quantize", "none"]).quantize == "none"
        with pytest.raises(SystemExit):
            p.parse_args(base + ["--quantize", "fp8"])


def test_serve_cli_int8_matches_jax(jax_dir, tmp_path, same_resize, monkeypatch, capsys):
    paths = []
    for k in range(2):
        paths.append(str(tmp_path / f"p{k}.png"))
        write_png(paths[-1], _grey_panel(20 + k)[..., 0])
    argv = ["--models-path", str(jax_dir.parent), "--model-name", jax_dir.name, "--quantize", "int8"]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(paths) + "\n"))
    assert jserve.main(argv) == 0
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    out = io.StringIO()
    assert tserve.main(argv + ["--device", "cpu"], stdin=io.StringIO("\n".join(paths) + "\n"),
                       stdout=out) == 0
    got = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [r["path"] for r in got] == [r["path"] for r in want] == paths
    for g, w in zip(got, want):
        assert len(w["detections"]) > 0
        _assert_same_dets(_dets(g["detections"]), _dets(w["detections"]), prob_atol=PROB_TOL)

    # The int8 head answers otherwise than the float one, which --quantize
    # none and the default both give.
    floats = []
    for flags in (["--quantize", "none"], []):
        out = io.StringIO()
        assert tserve.main(argv[:4] + flags + ["--device", "cpu"], stdin=io.StringIO(paths[0] + "\n"),
                           stdout=out) == 0
        floats.append(json.loads(out.getvalue())["detections"])
    assert floats[0] == floats[1] != got[0]["detections"]


def _scan_dir(root, cfg):
    scan = root / "scan"
    for seed, t in enumerate(cfg.img_types + ["blended_map_grey"], start=6):
        path = tpredict.resolve_type_path(str(scan), t)
        path.parent.mkdir(parents=True, exist_ok=True)
        write_png(str(path), _grey_panel(seed)[..., 0])
    return scan


def test_predict_cli_int8_matches_jax(jax_dir, tmp_path, same_resize):
    scan = _scan_dir(tmp_path, jax_vgg(0)[0])
    argv = ["--models-path", str(jax_dir.parent), "--model-name", jax_dir.name,
            "--scan-data-path", str(scan), "--quantize", "int8"]
    assert jpredict.main(argv) == 0
    want = json.loads((scan / "arrays" / "predictions.json").read_text())
    assert tpredict.main(argv + ["--device", "cpu"]) == 0
    got = json.loads((scan / "arrays" / "predictions.json").read_text())
    assert len(want) > 0
    _assert_same_dets(_dets(got), _dets(want), prob_atol=PROB_TOL)


def test_test_cli_int8_matches_jax(jax_dir, tmp_path, same_resize):
    """cli.test --quantize int8: the same mAP as the JAX CLI, on ground
    truth made of every second int8 detection, moved a few pixels."""
    net = load_radnet(str(jax_dir), device="cpu", quantize="int8")
    folder = tmp_path / "test" / net.C.img_types[0]
    folder.mkdir(parents=True)
    rng = np.random.default_rng(5)
    rows = []
    for k in range(2):
        panel = _grey_panel(40 + k)
        write_png(str(folder / f"p{k}.png"), panel[..., 0])
        for j, d in enumerate(net.predict([panel])):
            if j % 2 == 0:
                rows.append([f"p{k}.png", d["class"]] + [d[c] + int(rng.integers(-2, 3))
                                                         for c in ("x1", "y1", "x2", "y2")])
    with open(tmp_path / "test.csv", "w", newline="") as f:
        csv.writer(f).writerows([["img_path", "label", "xmin", "ymin", "xmax", "ymax"]] + rows)
    argv = ["--models-path", str(jax_dir.parent), "--model-name", jax_dir.name,
            "--test-annot", str(tmp_path / "test.csv"), "--test-data", str(tmp_path / "test"),
            "--quantize", "int8"]
    (jax_dir / "test").mkdir(exist_ok=True)  # the JAX CLI writes its PNGs there
    assert jtest.main(argv) == 0
    want = json.loads((jax_dir / "test_accuracy.json").read_text())
    assert ttest.main(argv + ["--device", "cpu"]) == 0
    got = json.loads((jax_dir / "test_accuracy.json").read_text())
    assert set(got) == set(want) and 0.0 < want["mAP"] <= 1.0
    for k in want:
        assert abs(got[k] - want[k]) <= PROB_TOL, (k, got[k], want[k])


class head_inputs:
    """A context in which the flax detector's RoI head records its input
    (the pooled RoIs), also from inside ``jax.jit``."""

    def __init__(self):
        self.inputs = []

    def _intercept(self, next_fun, args, kwargs, context):
        if context.module.name == "head" and context.method_name == "__call__":
            jax.debug.callback(lambda x: self.inputs.append(np.asarray(x)), args[0])
        return next_fun(*args, **kwargs)

    def __enter__(self):
        self._ctx = nn.intercept_methods(self._intercept)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


def _port_eval(ts, tcfg, batch, draws, head_input=None, head_output=None):
    """The port's eval metrics and its head's input.  ``head_input``: run
    the head on these pooled RoIs instead of its own; ``head_output``: use
    these (class probs, deltas) in place of the head's."""
    head, seen = ts.model.head, []
    forward = head.forward

    def fwd(rois, *args, **kw):
        seen.append(rois.detach().clone())
        if head_output is not None:
            return head_output
        return forward(rois if head_input is None else head_input, *args, **kw)

    head.forward = fwd
    try:
        got = tsteps.make_eval_step(ts, tcfg)(
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, draws)
    finally:
        del head.forward
    return {k: float(v) for k, v in got.items()}, seen[0]


def _close_metrics(got, want, keys):
    for k in keys:
        w = float(want[k])
        assert abs(got[k] - w) <= max(1e-4 * abs(w), 1e-7), (k, got[k], w)


@pytest.mark.parametrize("network", ["resnet50", "vgg16"])
def test_eval_step_int8_matches_jax(network):
    """make_eval_step of an int8 model: JAX's eval losses (the int8 head on
    the sampled RoIs, as radnet_tpu's make_eval_step runs it), at one thread
    and at the default count.  The port's head input is JAX's within
    float32 noise; the losses the head reaches are held on JAX's head input,
    against JAX's head run op by op (the module doc)."""
    cfg, _, params, bstats = jax_detector(network, 0)
    qcfg = dataclasses.replace(cfg, infer_quantize="int8")
    batch = synthetic_batch(qcfg, batch=2, seed=3)
    key = jax.random.PRNGKey(12)
    jmodel = jax_build_model(qcfg)
    with head_inputs() as rec:
        _, want = jax.jit(lambda p: jsteps.compute_losses(jmodel, qcfg, p, bstats, batch, key,
                                                          True))(params)
        want = jax.device_get(want)
        jax.effects_barrier()
    jax_pool = torch.from_numpy(rec.inputs[-1].copy())
    jax_head = tuple(torch.from_numpy(np.array(a)) for a in jmodel.apply(
        {"params": params, "batch_stats": bstats}, jnp.asarray(rec.inputs[-1]),
        method=lambda m, x: m.head(x, deterministic=True)))

    tcfg = torch_config(qcfg)
    ts = tstate.create_train_state(tcfg, torch.Generator(), "cpu", model=port_model(qcfg, params, bstats))
    assert ts.model.head_quant == "int8"
    draws = jax_step_draws(key, qcfg, 2, batch["image"].shape, grey=True)
    _, fwant = jax.jit(lambda p: jsteps.compute_losses(jax_build_model(cfg), cfg, p, bstats, batch, key,
                                                       True))(params)
    assert float(want["loss_detector_regr"]) != float(fwant["loss_detector_regr"])  # int8 ran
    try:
        for threads in sorted({1, DEFAULT_THREADS}):
            torch.set_num_threads(threads)
            got, pool = _port_eval(ts, tcfg, batch, draws)
            _close_metrics(got, want, HEADLESS_KEYS)
            assert pool.shape == jax_pool.shape
            torch.testing.assert_close(pool, jax_pool, rtol=1e-4,
                                       atol=1e-4 * float(jax_pool.abs().max()))
            got, _ = _port_eval(ts, tcfg, batch, draws, head_input=jax_pool)
            ref, _ = _port_eval(ts, tcfg, batch, draws, head_output=jax_head)
            assert ref["loss_detector_cls"] > 0
            _close_metrics(got, ref, tsteps.METRIC_KEYS)
    finally:
        torch.set_num_threads(1)
