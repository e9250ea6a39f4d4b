"""Detection evaluation: greedy GT matching and VOC-style interpolated AP.

The JAX package's ``evaluation.py``, function for function, so both give
the same floats: predictions are matched to unseen GT boxes of the same
class greedily in descending-confidence order at IoU >= threshold;
unmatched GT become false negatives with score 0; AP is the Riemann sum
under the monotone-interpolated precision/recall curve.  Pure numpy on the
host: the arrays involved are tiny.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def box_iou(a, b) -> float:
    ax1, ay1, ax2, ay2 = a
    bx1, by1, bx2, by2 = b
    if ax1 >= ax2 or ay1 >= ay2 or bx1 >= bx2 or by1 >= by2:
        return 0.0
    iw = min(ax2, bx2) - max(ax1, bx1)
    ih = min(ay2, by2) - max(ay1, by1)
    if iw < 0 or ih < 0:
        return 0.0
    inter = iw * ih
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return float(inter) / float(union + 1e-6)


def match_detections(
    pred: list[dict[str, Any]],
    gt: list[dict[str, Any]],
    iou_threshold: float = 0.5,
) -> tuple[dict[str, list[int]], dict[str, list[float]]]:
    """Greedy pred<->GT matching.

    Returns per-class parallel lists (T, P): T[c][i] is 1 if prediction i of
    class c matched a GT box, and P[c][i] its confidence; unmatched GT are
    appended as (1, 0.0) rows."""
    T: dict[str, list[int]] = {}
    P: dict[str, list[float]] = {}
    matched = np.zeros(len(gt), dtype=bool)

    # All-pairs IoU in one vectorized pass (same formula/eps/degenerate
    # handling as box_iou); the greedy scan below then only consults rows.
    # Each prediction matches the FIRST unmatched same-class GT in list
    # order, not the best-IoU one: the first-True index.
    if pred and gt:
        pb = np.array([[p["x1"], p["y1"], p["x2"], p["y2"]] for p in pred], float)
        gb = np.array([[g["x1"], g["y1"], g["x2"], g["y2"]] for g in gt], float)
        iw = np.minimum(pb[:, None, 2], gb[None, :, 2]) - np.maximum(
            pb[:, None, 0], gb[None, :, 0]
        )
        ih = np.minimum(pb[:, None, 3], gb[None, :, 3]) - np.maximum(
            pb[:, None, 1], gb[None, :, 1]
        )
        inter = np.where((iw < 0) | (ih < 0), 0.0, iw * ih)
        area_p = (pb[:, 2] - pb[:, 0]) * (pb[:, 3] - pb[:, 1])
        area_g = (gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1])
        iou_all = inter / (area_p[:, None] + area_g[None, :] - inter + 1e-6)
        degenerate = ((pb[:, 0] >= pb[:, 2]) | (pb[:, 1] >= pb[:, 3]))[:, None] | (
            (gb[:, 0] >= gb[:, 2]) | (gb[:, 1] >= gb[:, 3])
        )[None, :]
        iou_all = np.where(degenerate, 0.0, iou_all)
    else:
        iou_all = np.zeros((len(pred), len(gt)))
    gt_cls = np.array([g["class"] for g in gt], dtype=object)

    order = np.argsort([-p["prob"] for p in pred])
    for idx in order:
        p = pred[idx]
        cls = p["class"]
        T.setdefault(cls, [])
        P.setdefault(cls, [])
        P[cls].append(p["prob"])
        cand = (~matched) & (gt_cls == cls) & (iou_all[idx] >= iou_threshold)
        found = bool(cand.any())
        if found:
            matched[int(np.argmax(cand))] = True
        T[cls].append(int(found))

    for gi, g in enumerate(gt):
        if not matched[gi]:
            T.setdefault(g["class"], []).append(1)
            P.setdefault(g["class"], []).append(0.0)
    return T, P


def interpolated_average_precision(
    y_true, y_score
) -> tuple[float, np.ndarray, np.ndarray, list[float], list[float]]:
    """VOC interpolated AP.

    Returns (ap, precision, recall, interpolated_precision,
    interpolated_recall)."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    n_gt = float(np.sum(y_true))

    order = np.flip(np.argsort(y_score))
    tp = fp = 0
    precision, recall = [], []
    for i in order:
        if y_true[i] > 0 and y_score[i] > 0.0:
            tp += 1
        elif y_true[i] == 0 and y_score[i] > 0.0:
            fp += 1
        precision.append(tp / (tp + fp) if (tp + fp) else 0.0)
        recall.append(tp / n_gt if n_gt else 0.0)

    precision = np.asarray(precision)
    recall = np.asarray(recall)

    max_p = 0.0
    interp_p: list[float] = []
    interp_r: list[float] = []
    for i in reversed(range(len(recall))):
        max_p = max(max_p, precision[i])
        interp_r.append(recall[i])
        interp_p.append(max_p)
    interp_p.reverse()
    interp_r.reverse()

    ap = 0.0
    for i in range(len(interp_p) - 1):
        ap += interp_p[i + 1] * (interp_r[i + 1] - interp_r[i])
    return ap, precision, recall, interp_p, interp_r


def evaluate_detections(
    all_dets: list[dict[str, Any]],
    all_gt: list[dict[str, Any]],
    iou_threshold: float = 0.5,
) -> dict[str, Any]:
    """Per-class AP + mAP over a pooled test set.

    Returns ``{'per_class': {name: ap}, 'mAP': float, 'curves': {...}}``.
    """
    T, P = match_detections(all_dets, all_gt, iou_threshold)
    per_class: dict[str, float] = {}
    curves: dict[str, Any] = {}
    for key in sorted(T.keys()):
        ap, prec, rec, ip, ir = interpolated_average_precision(T[key], P[key])
        per_class[key] = ap
        curves[key] = {
            "precision": prec.tolist(),
            "recall": rec.tolist(),
            "interpolated_precision": ip,
            "interpolated_recall": ir,
        }
    m_ap = float(np.mean(list(per_class.values()))) if per_class else 0.0
    return {"per_class": per_class, "mAP": m_ap, "curves": curves}


def evaluate_detections_multi(
    all_dets: list[dict[str, Any]],
    all_gt: list[dict[str, Any]],
    thresholds: list[float] | None = None,
) -> dict[str, Any]:
    """COCO-style multi-threshold mAP: mAP averaged over IoU in {0.50,
    0.55, ..., 0.95}.  Each threshold reuses the pooled greedy matcher and
    interpolated AP, so AP@0.50 here equals
    ``evaluate_detections(...)["mAP"]`` exactly.

    Returns ``{"per_threshold": {"0.50": {...}, ...},
    "per_class_avg": {cls: mean AP}, "mAP_50_95": float,
    "AP50": float, "AP75": float}``.
    """
    if thresholds is None:
        thresholds = [0.5 + 0.05 * i for i in range(10)]
    per_threshold: dict[str, Any] = {}
    class_aps: dict[str, list[float]] = {}
    for t in thresholds:
        res = evaluate_detections(all_dets, all_gt, t)
        res = {"per_class": res["per_class"], "mAP": res["mAP"]}  # drop curves
        key = f"{t:.2f}"
        per_threshold[key] = res
        for cls, ap in res["per_class"].items():
            class_aps.setdefault(cls, []).append(ap)
    per_class_avg = {c: float(np.mean(v)) for c, v in class_aps.items()}
    maps = [r["mAP"] for r in per_threshold.values()]
    return {
        "per_threshold": per_threshold,
        "per_class_avg": per_class_avg,
        "mAP_50_95": float(np.mean(maps)) if maps else 0.0,
        "AP50": per_threshold.get("0.50", {}).get("mAP"),
        "AP75": per_threshold.get("0.75", {}).get("mAP"),
    }
