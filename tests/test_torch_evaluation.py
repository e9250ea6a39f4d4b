"""radnet_torch.evaluation and cli.test's compare_accuracy against
radnet_tpu's, on seeded detections and ground truth: several classes, tied
probabilities, a class with no detections, a class with no ground truth,
empty inputs.  Tolerance 0: both are the same float64 numpy arithmetic, so
every float, curve point and tie order must be equal."""

import numpy as np
import pytest

from radnet_torch import evaluation as tev
from radnet_torch.cli.test import compare_accuracy as t_compare
from radnet_tpu import evaluation as jev
from radnet_tpu.cli.test import compare_accuracy as j_compare

CLASSES = ["boat", "human", "other", "wheel"]


def _box(rng, cls, extent=400):
    x1, y1 = (int(v) for v in rng.integers(0, extent, 2))
    w, h = (int(v) for v in rng.integers(8, 80, 2))
    return {"class": cls, "x1": x1, "y1": y1, "x2": x1 + w, "y2": y1 + h}


def _case(name: str, seed: int = 0):
    """(detections, ground truth) of a named case."""
    rng = np.random.default_rng(seed)
    if name == "empty":
        return [], []
    gt = [_box(rng, CLASSES[k % 3]) for k in range(30)]  # boat, human, other
    if name == "gt_only":
        return [], gt
    dets = []
    for g in gt[:24]:  # near-copies of most ground truth, some of another class
        d = {k: (v + int(rng.integers(-6, 7)) if k != "class" else v) for k, v in g.items()}
        if rng.random() < 0.15:
            d["class"] = CLASSES[int(rng.integers(0, 3))]
        dets.append(d)
    dets += [_box(rng, CLASSES[int(rng.integers(0, 3))]) for _ in range(12)]  # false positives
    dets.append(dict(gt[0]))  # a duplicate of a matched box
    dets.append({"class": "boat", "x1": 50, "y1": 50, "x2": 50, "y2": 90})  # degenerate
    # Probabilities on a 0.1 grid: many ties, so the order of ties matters.
    for d in dets:
        d["prob"] = float(np.round(rng.uniform(0.5, 1.0), 1))
    if name == "class_without_gt":
        dets += [dict(_box(rng, "wheel"), prob=0.9) for _ in range(3)]
    if name == "class_without_detections":
        gt += [_box(rng, "wheel") for _ in range(2)]
    if name == "dets_only":
        return dets, []
    return dets, gt


CASES = ["random", "class_without_gt", "class_without_detections", "empty", "gt_only", "dets_only"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("thresh", [0.5, 0.75])
def test_match_detections_matches_jax(case, thresh):
    dets, gt = _case(case)
    assert tev.match_detections(dets, gt, thresh) == jev.match_detections(dets, gt, thresh)


@pytest.mark.parametrize("case", CASES)
def test_interpolated_average_precision_matches_jax(case):
    dets, gt = _case(case)
    T, P = jev.match_detections(dets, gt, 0.5)
    for key in sorted(T):
        got = tev.interpolated_average_precision(T[key], P[key])
        want = jev.interpolated_average_precision(T[key], P[key])
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.9])
def test_evaluate_detections_matches_jax(case, thresh):
    dets, gt = _case(case)
    got = tev.evaluate_detections(dets, gt, thresh)
    want = jev.evaluate_detections(dets, gt, thresh)
    assert got == want
    assert list(got["per_class"]) == list(want["per_class"]) == sorted(got["per_class"])
    if case == "class_without_gt":
        assert got["per_class"]["wheel"] == 0.0
    if case == "class_without_detections":
        assert got["per_class"]["wheel"] == 0.0 and got["curves"]["wheel"]["recall"] == [0.0, 0.0]


@pytest.mark.parametrize("case", CASES)
def test_evaluate_detections_multi_matches_jax(case):
    dets, gt = _case(case)
    got = tev.evaluate_detections_multi(dets, gt)
    assert got == jev.evaluate_detections_multi(dets, gt)
    assert len(got["per_threshold"]) == 10
    if gt and dets:
        assert got["AP50"] == tev.evaluate_detections(dets, gt)["mAP"]
    assert tev.evaluate_detections_multi(dets, gt, [0.6]) == jev.evaluate_detections_multi(dets, gt, [0.6])


def test_box_iou_matches_jax():
    rng = np.random.default_rng(3)
    pairs = [(tuple(_box(rng, "b").values())[1:], tuple(_box(rng, "b").values())[1:]) for _ in range(200)]
    pairs += [((0, 0, 10, 10), (0, 0, 10, 10)), ((0, 0, 10, 10), (10, 0, 20, 10)),
              ((5, 5, 5, 9), (0, 0, 10, 10)), ((0, 0, 10, 10), (20, 20, 30, 30)),
              ((0.5, 0.5, 3.25, 7.0), (1.0, 0.0, 2.0, 8.0))]
    for a, b in pairs:
        assert tev.box_iou(a, b) == jev.box_iou(a, b)


@pytest.mark.parametrize("ours, ref, tol", [
    ({"boat": 0.8, "human": 0.6, "mAP": 0.7}, {"boat": 0.7, "human": 0.7, "mAP": 0.7}, 0.005),
    ({"boat": 0.8, "mAP": 0.69}, {"boat": 0.8, "human": 0.6, "mAP": 0.7}, 0.005),
    ({"boat": 0.8, "mAP": 0.69}, {"boat": 0.8, "mAP": 0.7}, 0.02),
    ({"boat": 0.8, "other": 0.1, "mAP": 0.45}, {"boat": 0.8, "mAP": 0.8}, 0.005),
    ({"boat": 0.8}, {"boat": 0.8, "mAP": 0.8}, 0.005),
])
def test_compare_accuracy_matches_jax(ours, ref, tol):
    got = t_compare(ours, ref, tol)
    assert got == j_compare(ours, ref, tol)
    assert got[0] == ("mAP" in ours and ours["mAP"] - ref["mAP"] >= -tol)
