"""Target assignment of both stages, batched over tiles, on the device.

:func:`rpn_targets`: every anchor's objectness and regression target from
one ``(B, N, G)`` IoU matrix and masked reductions, then the positive and
negative subsample to ``max_regions``.  :func:`proposal_targets`: the
second stage's class and regression targets of each proposal, then the
balanced sample of ``n_rois`` RoIs.

Semantics, as the JAX package's ``ops/targets.py``:
  - strict IoU bands: positive iff ``iou > rpn_max_overlap``, neutral iff
    ``rpn_min < iou < rpn_max``;
  - anchors that cross the valid image extent take no part;
  - a ground-truth box with no positive anchor forces its best anchor
    positive, the later box winning a shared anchor;
  - the negative budget fills up to ``max_regions`` (or, with
    ``reference_neg_budget``, keeps as many negatives as positives once over
    budget);
  - the second stage's IoU is taken on rounded feature-map coordinates.

Random choices are arguments, not drawn here: ``pos_bits`` / ``neg_bits``
(the random words the subsample thresholds, :func:`subset_bits` wide) and
``r_pos`` / ``r_neg`` (the uniforms that order the RoI sample).  Nothing
here reads a tensor back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from radnet_torch.geometry import encode_boxes, iou_matrix
from radnet_torch.ops.anchors import anchor_validity_mask

INT32_MAX = 2**31 - 1


def subset_bits(n: int) -> tuple[int, int]:
    """(index bits, random bits) of the subsample's composite keys over ``n``
    elements: ``random << index_bits | index`` stays below 2**31."""
    idx_bits = max(1, (n - 1).bit_length())
    return idx_bits, min(16, 31 - idx_bits)


def keep_random_subset(mask: torch.Tensor, budget: torch.Tensor, rbits: torch.Tensor) -> torch.Tensor:
    """Keep exactly ``min(budget, count)`` True elements of each row of
    ``mask``: ``(B, N)`` bool, ``(B,)`` int budgets, ``(B, N)`` int32 random
    words below ``2**random_bits``.  The keys are unique, so the count is
    exact; the threshold is a gather at ``budget - 1`` of the sorted keys."""
    n = mask.shape[-1]
    idx_bits, _ = subset_bits(n)
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    keys = (rbits.to(torch.int32) << idx_bits) | idx
    keys = torch.where(mask, keys, torch.full_like(keys, INT32_MAX))
    sorted_keys = torch.sort(keys, dim=-1).values
    at = (budget.long() - 1).clamp(0, n - 1)[:, None]
    thr = torch.gather(sorted_keys, 1, at)
    return mask & (keys <= thr) & (budget > 0)[:, None]


class RpnTargets(NamedTuple):
    y_rpn_cls: torch.Tensor  # (B, H, W, 2A): [valid | overlap]
    y_rpn_regr: torch.Tensor  # (B, H, W, 8A): [4x overlap | std-scaled targets]
    n_pos: torch.Tensor  # (B,) int32, positive anchors after the cap


def rpn_targets(
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    valid_width: torch.Tensor,
    valid_height: torch.Tensor,
    anchors_xyxy: torch.Tensor,
    pos_bits: torch.Tensor,
    neg_bits: torch.Tensor,
    *,
    rpn_min_overlap: float = 0.3,
    rpn_max_overlap: float = 0.7,
    max_regions: int = 256,
    std_scaling: float = 4.0,
    reference_neg_budget: bool = False,
    fallback_min_iou: float = 0.0,
) -> RpnTargets:
    """Anchor targets of a batch of padded tiles.

    ``gt_boxes`` (B, G, 4) xyxy in canvas pixels, ``gt_mask`` (B, G) bool,
    ``valid_width``/``valid_height`` (B,) extents of the real image,
    ``anchors_xyxy`` (H, W, A, 4) from :func:`~radnet_torch.ops.anchors.image_anchors_xyxy`,
    ``pos_bits``/``neg_bits`` (B, H * W * A) int32 random words."""
    feat_h, feat_w, n_per_cell = anchors_xyxy.shape[:3]
    anchors = anchors_xyxy.reshape(-1, 4).float()
    b, g = gt_mask.shape
    n = anchors.shape[0]
    dev = anchors.device
    gt_boxes = gt_boxes.float()

    a_valid = anchor_validity_mask(anchors, valid_width.float(), valid_height.float())  # (B, N)
    iou = iou_matrix(anchors.expand(b, n, 4), gt_boxes) * gt_mask[:, None, :].float()  # (B, N, G)
    best_iou, best_gt = iou.max(-1).values, iou.argmax(-1)

    pos = a_valid & (best_iou > rpn_max_overlap)
    neutral = a_valid & ~pos & (best_iou > rpn_min_overlap) & (best_iou < rpn_max_overlap)
    neg = a_valid & ~pos & ~neutral

    def gather_rows(t, idx):  # t (B, M, 4), idx (B, K) -> (B, K, 4)
        return torch.gather(t, 1, idx[..., None].expand(*idx.shape, 4))

    regr_all = encode_boxes(anchors, gather_rows(gt_boxes, best_gt))  # (B, N, 4)

    # A ground-truth box with no positive anchor forces its best valid
    # anchor positive; where two boxes share one, the later box wins.
    zero = torch.zeros((), device=dev)
    iou_masked = torch.where(a_valid[..., None], iou, zero)
    gt_has_pos = (iou_masked > rpn_max_overlap).any(1)  # (B, G)
    gt_best_anchor = iou_masked.argmax(1)  # (B, G)
    gt_best_iou = iou_masked.max(1).values
    need_fallback = gt_mask & ~gt_has_pos & (gt_best_iou > fallback_min_iou)
    regr_fallback = encode_boxes(anchors[gt_best_anchor], gt_boxes)  # (B, G, 4)
    arange_n = torch.arange(n, device=dev)
    match = need_fallback[:, None, :] & (gt_best_anchor[:, None, :] == arange_n[None, :, None])
    arange_g = torch.arange(g, device=dev).expand(b, n, g)
    win_g = torch.where(match, arange_g, torch.full_like(arange_g, -1)).max(-1).values  # (B, N)
    has_fb = win_g >= 0
    overlap = pos | has_fb
    valid = pos | neg | has_fb
    regr_all = torch.where(has_fb[..., None], gather_rows(regr_fallback, win_g.clamp_min(0)), regr_all)

    # Subsample to the region budget.
    pos_mask = overlap & valid
    neg_mask = valid & ~overlap
    n_pos = pos_mask.sum(-1)
    n_neg = neg_mask.sum(-1)
    half = max_regions // 2
    keep_pos = keep_random_subset(pos_mask, torch.full_like(n_pos, half), pos_bits)
    n_pos_kept = n_pos.clamp_max(half)
    if reference_neg_budget:
        neg_budget = torch.where(n_pos_kept + n_neg > max_regions, n_pos_kept, n_neg)
    else:
        neg_budget = torch.minimum(n_neg, max_regions - n_pos_kept)
    keep_neg = keep_random_subset(neg_mask, neg_budget, neg_bits)
    # The subsample clears only validity: ``overlap`` keeps every positive,
    # so the regression mask still covers the positives it dropped.
    valid = keep_pos | keep_neg

    shape = (b, feat_h, feat_w, n_per_cell)
    overlap_f = overlap.float().reshape(shape)
    valid_f = valid.float().reshape(shape)
    regr = torch.where(overlap[..., None], regr_all, zero).reshape(b, feat_h, feat_w, 4 * n_per_cell)
    y_rpn_cls = torch.cat([valid_f, overlap_f], dim=-1)
    y_rpn_regr = torch.cat([overlap_f.repeat_interleave(4, dim=-1), regr * std_scaling], dim=-1)
    return RpnTargets(y_rpn_cls, y_rpn_regr, n_pos_kept.to(torch.int32))


class ProposalTargets(NamedTuple):
    rois: torch.Tensor  # (B, R, 4) xywh feature-map coords
    y_class: torch.Tensor  # (B, R, n_classes) one-hot
    y_regr: torch.Tensor  # (B, R, 8K) [labels | std-scaled coords]
    roi_valid: torch.Tensor  # (B, R) bool, False when no RoI survived
    n_pos: torch.Tensor  # (B,) int32, positives before sampling


def proposal_targets(
    proposals: torch.Tensor,
    prop_valid: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_classes: torch.Tensor,
    gt_mask: torch.Tensor,
    r_pos: torch.Tensor,
    r_neg: torch.Tensor,
    regr_std: torch.Tensor,
    *,
    n_classes: int,
    n_rois: int,
    stride: int,
    classifier_min_overlap: float = 0.1,
    classifier_max_overlap: float = 0.5,
) -> ProposalTargets:
    """Second-stage targets and the balanced RoI sample of a batch.

    ``proposals`` (B, P, 4) xyxy integer-valued feature-map coords,
    ``prop_valid`` (B, P), ground truth as in :func:`rpn_targets` plus
    ``gt_classes`` (B, G) (background, id ``n_classes - 1``, excluded),
    ``r_pos``/``r_neg`` (B, P) uniforms, ``regr_std`` (4,) float32.  Up to
    ``n_rois // 2`` positives, the rest negatives, reusing a pool that is
    too small from its start."""
    n_fg = n_classes - 1
    b, p = prop_valid.shape
    dev = proposals.device
    # stride is a power of two, so this division is exact on any device.
    gta = torch.round(gt_boxes.float() / float(stride))
    props = torch.round(proposals.float())

    iou = iou_matrix(props, gta) * gt_mask[:, None, :].float()  # (B, P, G)
    best_iou, best_gt = iou.max(-1).values, iou.argmax(-1)
    keep = prop_valid & (best_iou >= classifier_min_overlap)
    is_fg = keep & (best_iou >= classifier_max_overlap)
    is_bg = keep & ~is_fg

    bg_id = torch.full_like(best_gt, n_fg)
    cls_id = torch.where(is_fg, torch.gather(gt_classes.long(), 1, best_gt), bg_id)
    y_class = (cls_id[..., None] == torch.arange(n_classes, device=dev)).float()

    t = encode_boxes(props, torch.gather(gta, 1, best_gt[..., None].expand(b, p, 4)))
    t_scaled = t * regr_std
    onehot_fg = (cls_id[..., None] == torch.arange(n_fg, device=dev)).float() * is_fg[..., None].float()
    labels = onehot_fg.repeat_interleave(4, dim=-1)  # (B, P, 4K)
    coords = labels * t_scaled.repeat(1, 1, n_fg)
    y_regr = torch.cat([labels, coords], dim=-1)

    x1, y1, x2, y2 = props.unbind(-1)
    rois_xywh = torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)

    n_pos = is_fg.sum(-1)
    n_neg = is_bg.sum(-1)
    k_pos = n_pos.clamp_max(n_rois // 2)
    inf = torch.full((), float("inf"), device=dev)
    pos_order = torch.argsort(torch.where(is_fg, r_pos, inf), dim=-1, stable=True)
    neg_order = torch.argsort(torch.where(is_bg, r_neg, inf), dim=-1, stable=True)
    slot = torch.arange(n_rois, device=dev)[None, :]
    pos_idx = torch.gather(pos_order, 1, slot % n_pos.clamp_min(1)[:, None])
    neg_idx = torch.gather(neg_order, 1, (slot - k_pos[:, None]) % n_neg.clamp_min(1)[:, None])
    use_pos = (slot < k_pos[:, None]) | (n_neg == 0)[:, None]
    sel = torch.where(use_pos, pos_idx, neg_idx)  # (B, R)
    roi_valid = ((n_pos + n_neg) > 0)[:, None].expand(b, n_rois)

    def pick(x):
        return torch.gather(x, 1, sel[..., None].expand(b, n_rois, x.shape[-1]))

    return ProposalTargets(pick(rois_xywh), pick(y_class), pick(y_regr), roi_valid,
                           n_pos.to(torch.int32))
