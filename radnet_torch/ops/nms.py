"""Fixed-point non-maximum suppression on the device, and the host merges.

:func:`nms_fixed_point` computes greedy NMS (strict ``iou > thresh``) over a
batch of candidate sets as a Jacobi iteration of

    kept[i] = valid[i] and no j with dominates[i, j] and kept[j]

where ``dominates[i, j]`` says that candidate ``j`` outscores ``i`` (index
as the tie-break) and overlaps it.  :func:`dominates` builds that relation:
its plain version on CPU tensors, the hand-written kernel
``csrc/nms_dominance.cu`` on CUDA tensors.

Score order follows ``jax.lax.top_k``: descending, ties by ascending index.
``torch.topk`` promises no tie order, so the port sorts stably instead.

:func:`final_nms_cluster` and :func:`nms_numpy` run on the host in numpy on
the few hundred boxes of one panel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from radnet_torch.geometry import iou_matrix
from radnet_torch.ops import cuda_kernels

NEG_INF = float("-inf")

# Jacobi rounds of nms_fixed_point: every round ends in a device -> host
# sync (the convergence test).  Reset and read by measurement scripts.
NMS_STATS = {"calls": 0, "rounds": 0}


def dominates_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """``(B, N, 4)`` xyxy boxes + ``(B, N)`` scores -> ``(B, N, N)`` bool,
    ``[b, i, j]``: candidate ``j`` can suppress ``i``."""
    n = boxes.shape[-2]
    idx = torch.arange(n, device=boxes.device)
    s = scores.float()
    higher = (s[..., None, :] > s[..., :, None]) | (
        (s[..., None, :] == s[..., :, None]) & (idx[None, :] > idx[:, None])
    )
    overlap = iou_matrix(boxes, boxes) > iou_thresh
    return higher & overlap


def dominates_cuda(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Launch ``csrc/nms_dominance.cu``; same contract as :func:`dominates_plain`."""
    if not (boxes.is_cuda and scores.is_cuda and boxes.device == scores.device):
        raise ValueError("dominates_cuda needs both tensors on one CUDA device")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"dominates_cuda takes float32, not {boxes.dtype}/{scores.dtype}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"shapes {tuple(boxes.shape)}, {tuple(scores.shape)}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("dominates_cuda needs contiguous (B, N, 4) boxes and (B, N) scores")
    if boxes.data_ptr() % 16:
        raise ValueError("dominates_cuda needs 16-byte aligned boxes")
    b, n = scores.shape
    out = torch.empty((b, n, n), dtype=torch.uint8, device=boxes.device)
    cuda_kernels.NMS_DOMINANCE.launch(
        cuda_kernels.ptr(boxes), cuda_kernels.ptr(scores), cuda_kernels.ptr(out),
        b, n, ctypes.c_float(iou_thresh),
    )
    return out.view(torch.bool)


def dominates(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """The dominance relation: plain version on CPU tensors, kernel on CUDA."""
    if boxes.device.type == "cpu":
        return dominates_plain(boxes, scores, iou_thresh)
    return dominates_cuda(boxes, scores, iou_thresh)


def _sorted_desc(scores: torch.Tensor, k: int):
    """Top ``k`` along the last axis, descending, ties by ascending index."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_fixed_point(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_thresh: float,
    *,
    max_out: int,
    cast_int: bool = False,
):
    """Greedy NMS over a batch: ``(B, N, 4)`` xyxy, ``(B, N)`` scores and
    validity -> (boxes ``(B, max_out, 4)``, scores ``(B, max_out)``, valid
    ``(B, max_out)``), score-descending; unused slots are zero and invalid.
    ``cast_int`` floors the kept boxes."""
    b, n = scores.shape
    boxes = boxes.float().contiguous()
    s = torch.where(valid, scores.float(), torch.full_like(scores, NEG_INF, dtype=torch.float32))
    s = s.contiguous()
    dom = dominates(boxes, s, iou_thresh)

    kept = valid
    rounds = 0
    while rounds < n:
        suppressed = (dom & kept[:, None, :]).any(dim=-1)
        new_kept = valid & ~suppressed
        rounds += 1
        changed = bool((new_kept != kept).any())  # device -> host sync
        kept = new_kept
        if not changed:
            break
    NMS_STATS["calls"] += 1
    NMS_STATS["rounds"] += rounds

    kept_scores = torch.where(kept, s, torch.full_like(s, NEG_INF))
    k = min(max_out, n)
    top_scores, top_idx = _sorted_desc(kept_scores, k)
    out_valid = top_scores > NEG_INF
    picked = torch.gather(boxes, 1, top_idx[..., None].expand(b, k, 4))
    out_boxes = torch.where(out_valid[..., None], picked, torch.zeros_like(picked))
    out_scores = torch.where(out_valid, top_scores, torch.zeros_like(top_scores))
    if k < max_out:
        pad = max_out - k
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros((b, pad, 4))], dim=1)
        out_scores = torch.cat([out_scores, out_scores.new_zeros((b, pad))], dim=1)
        out_valid = torch.cat([out_valid, out_valid.new_zeros((b, pad))], dim=1)
    if cast_int:
        out_boxes = torch.floor(out_boxes)
    return out_boxes, out_scores, out_valid


def topk_candidates(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, k: int):
    """Score top-``k`` of a batch of candidate sets (invalid ones score
    -inf): ``(B, N, 4)``, ``(B, N)``, ``(B, N)`` -> boxes ``(B, k, 4)``,
    scores ``(B, k)``, valid ``(B, k)``."""
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    top_scores, idx = _sorted_desc(masked, k)
    picked = torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4))
    return picked, top_scores, top_scores > NEG_INF


# --------------------------------------------------------------------------- #
# Host-side merges (numpy).
# --------------------------------------------------------------------------- #
def final_nms_cluster(
    boxes: np.ndarray,
    probs: np.ndarray,
    obj_avg_threshold: float = 0.2,
    obj_confidence_threshold: float = 0.8,
    n_obj_avg: int = 5,
) -> tuple[np.ndarray, np.ndarray]:
    """Cluster-average NMS across the tiles of a panel.

    Greedily groups boxes around the highest-probability remaining box at
    ``iou > obj_avg_threshold``; within a cluster keeps the members above
    ``obj_confidence_threshold`` (or, if none qualify, the ``n_obj_avg``
    highest-probability members) and emits their mean box and mean prob.
    """
    boxes = np.asarray(boxes, dtype=np.float64)
    probs = np.asarray(probs, dtype=np.float64)
    if boxes.size == 0:
        return np.zeros((0, 4), dtype=np.int64), np.zeros((0,), dtype=np.float64)

    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1) * (y2 - y1)
    order = np.argsort(probs)  # ascending; the best is last
    picked_groups: list[np.ndarray] = []

    while order.size > 0:
        last = order.size - 1
        i = order[last]
        rest = order[:last]

        iw = np.maximum(0.0, np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]))
        ih = np.maximum(0.0, np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]))
        inter = iw * ih
        overlap = inter / (area[i] + area[rest] - inter + 1e-6)

        cluster_pos = np.concatenate([np.nonzero(overlap > obj_avg_threshold)[0], [last]])
        cluster = order[cluster_pos]  # ascending prob; best member last

        if probs[cluster].max() < obj_confidence_threshold:
            members = cluster[-n_obj_avg:]
        else:
            members = cluster[probs[cluster] > obj_confidence_threshold]

        picked_groups.append(members)
        order = np.delete(order, cluster_pos)

    new_boxes = np.array([np.rint(boxes[g].mean(axis=0)).astype("int") for g in picked_groups])
    new_probs = np.array([probs[g].mean() for g in picked_groups])
    return new_boxes, new_probs


def nms_numpy(
    boxes: np.ndarray,
    probs: np.ndarray,
    overlap_thresh: float = 0.9,
    max_boxes: int = 300,
) -> tuple[np.ndarray, np.ndarray]:
    """Host greedy NMS for small candidate sets; returns int boxes."""
    if len(boxes) == 0:
        return np.zeros((0, 4), dtype=np.int64), np.zeros((0,))
    boxes = np.asarray(boxes, dtype=np.float64)
    probs = np.asarray(probs, dtype=np.float64)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1) * (y2 - y1)
    order = np.argsort(probs)
    pick = []
    while order.size > 0:
        last = order.size - 1
        i = order[last]
        pick.append(i)
        rest = order[:last]
        iw = np.maximum(0.0, np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]))
        ih = np.maximum(0.0, np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]))
        inter = iw * ih
        overlap = inter / (area[i] + area[rest] - inter + 1e-6)
        order = np.delete(order, np.concatenate([[last], np.nonzero(overlap > overlap_thresh)[0]]))
        if len(pick) >= max_boxes:
            break
    return boxes[pick].astype("int"), probs[pick]
