"""Fixed-point non-maximum suppression on the device, and the host merges.

:func:`nms_fixed_point` computes greedy NMS (strict ``iou > thresh``) over a
batch of candidate sets from the kept set :func:`nms_kept` gives, the
unique fixed point of

    kept[i] = valid[i] and no j with dominates[i, j] and kept[j]

where ``dominates[i, j]`` (:func:`dominates_plain`) says that candidate
``j`` outscores ``i`` (index as the tie-break) and overlaps it.  On CPU
tensors :func:`nms_kept_plain` builds the relation and Jacobi-iterates it
from ``kept = valid``, at most ``N`` rounds, as the JAX package does; on
CUDA tensors the hand-written kernel ``csrc/nms_fused.cu`` does both in one
launch, with no device -> host sync.

Score order follows ``jax.lax.top_k``: descending, ties by ascending index.
``torch.topk`` promises no tie order, so the port sorts stably instead.

:func:`final_nms_cluster` and :func:`nms_numpy` run on the host in numpy on
the few hundred boxes of one panel.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from radnet_torch.geometry import iou_matrix
from radnet_torch.ops import cuda_kernels

NEG_INF = float("-inf")
MAX_N = 3584  # csrc/nms_fused.cu kMaxN: a set's relation fills a cluster of 8 blocks

# Measurement only: the NMS calls made, and the (B,) int32 round counts of the
# last calls, left on their device.  Nothing on the main path reads them (a
# read of a CUDA tensor would wait for the card); chip_smoke.py sums them
# after its own synchronise.
NMS_STATS = {"calls": 0}
RECENT_ROUNDS: collections.deque = collections.deque(maxlen=256)


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


def nms_kept_plain(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                   iou_thresh: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kept set: ``(B, N, 4)`` boxes, ``(B, N)`` scores
    and validity -> (kept ``(B, N)`` bool, Jacobi rounds ``(B,)`` int32).  A
    set's rounds end at the first that changes nothing, or at ``N``."""
    b, n = scores.shape
    dom = dominates_plain(boxes, scores, iou_thresh)
    kept = valid
    rounds = torch.zeros(b, dtype=torch.int32, device=valid.device)
    active = torch.ones(b, dtype=torch.bool, device=valid.device)
    for _ in range(n):
        new_kept = valid & ~(dom & kept[:, None, :]).any(dim=-1)
        rounds += active
        active &= (new_kept != kept).any(dim=-1)
        kept = new_kept
        if not bool(active.any()):
            break
    return kept, rounds


def nms_kept_cuda(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                  iou_thresh: float, *, with_relation: bool = False):
    """Launch ``csrc/nms_fused.cu``; same contract as :func:`nms_kept_plain`.
    ``with_relation`` also returns the relation as the kernel packed it,
    ``(B, N, ceil(N / 32))`` int32 words (:func:`pack_relation`), on the
    pairs of valid candidates (other rows and columns are zero)."""
    tensors = (boxes, scores, valid)
    if not all(t.is_cuda and t.device == boxes.device for t in tensors):
        raise ValueError("nms_kept_cuda needs every tensor on one CUDA device")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms_kept_cuda takes float32, not {boxes.dtype}/{scores.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, not {valid.dtype}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2] \
            or valid.shape != scores.shape:
        raise ValueError(f"shapes {tuple(boxes.shape)}, {tuple(scores.shape)}, {tuple(valid.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("nms_kept_cuda needs contiguous (B, N, 4) boxes and (B, N) scores, valid")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_kept_cuda needs 16-byte aligned boxes")
    if not iou_thresh >= 0.0:
        raise ValueError(f"nms_kept_cuda takes an IoU threshold >= 0, not {iou_thresh}")
    b, n = scores.shape
    if n > MAX_N or b > 65535:
        raise ValueError(f"nms_kept_cuda takes up to {MAX_N} candidates a set and 65535 sets, "
                         f"not {n} and {b}")
    kept = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    rounds = torch.empty((b,), dtype=torch.int32, device=boxes.device)
    relation = None
    if with_relation:
        relation = torch.zeros((b, n, -(-n // 32)), dtype=torch.int32, device=boxes.device)
    if b and n:
        cuda_kernels.NMS_FUSED.launch(
            *(cuda_kernels.ptr(t) for t in (boxes, scores, valid, kept, rounds)),
            ctypes.c_void_p(None if relation is None else relation.data_ptr()),
            b, n, ctypes.c_float(iou_thresh),
        )
    return (kept, rounds, relation) if with_relation else (kept, rounds)


def nms_kept(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_thresh: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The kept set: plain version on CPU tensors, the kernel on CUDA."""
    if boxes.device.type == "cpu":
        return nms_kept_plain(boxes, scores, valid, iou_thresh)
    return nms_kept_cuda(boxes, scores, valid, iou_thresh)


def pack_relation(dom: torch.Tensor) -> torch.Tensor:
    """``(B, N, N)`` bool -> ``(B, N, ceil(N / 32))`` int32 words: bit ``j %
    32`` of word ``j // 32`` of row ``i`` is ``dom[b, i, j]``."""
    b, n, _ = dom.shape
    w = -(-n // 32)
    bits = torch.zeros((b, n, w * 32), dtype=torch.int64, device=dom.device)
    bits[..., :n] = dom.long()
    words = (bits.view(b, n, w, 32) << torch.arange(32, device=dom.device)).sum(-1)
    return (words - (words >= 2**31).long() * 2**32).int()


def unpack_relation(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_relation`: ``(B, N, W)`` words -> ``(B, N, N)`` bool."""
    shifts = torch.arange(32, device=words.device)
    bits = (words.long()[..., None] >> shifts) & 1
    return bits.flatten(-2)[..., :n].bool()


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
    kept, rounds = nms_kept(boxes, s, valid.contiguous(), iou_thresh)
    NMS_STATS["calls"] += 1
    RECENT_ROUNDS.append(rounds)

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
