"""RPN outputs -> RoI proposals on the device, batched over tiles.

Undo the regression std-scaling, decode every anchor, clamp sizes to one
feature cell, clip to the valid feature extent, drop degenerate boxes and
anchors whose cell lies in the canvas padding, take the score top
``pre_nms_top_n``, then run the fixed-point NMS to ``post_nms_top_n`` slots
with the kept boxes floored to integers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from radnet_torch.geometry import decode_boxes
from radnet_torch.ops.nms import nms_fixed_point, topk_candidates


class Proposals(NamedTuple):
    boxes: torch.Tensor  # (B, post_nms_top_n, 4) xyxy, integer-valued, fm coords
    scores: torch.Tensor  # (B, post_nms_top_n)
    valid: torch.Tensor  # (B, post_nms_top_n) bool


def decode_proposals(
    rpn_cls: torch.Tensor,
    rpn_regr: torch.Tensor,
    valid_fw: torch.Tensor,
    valid_fh: torch.Tensor,
    anchors_xywh: torch.Tensor,
    *,
    std_scaling: float | torch.Tensor = 4.0,
    pre_nms_top_n: int = 1024,
    post_nms_top_n: int = 300,
    nms_thresh: float = 0.7,
) -> Proposals:
    """Proposals for a batch of tiles.

    Args:
      rpn_cls: ``(B, H, W, A)`` post-sigmoid objectness.
      rpn_regr: ``(B, H, W, 4A)`` raw regression output (std-scaled).
      valid_fw / valid_fh: ``(B,)`` int feature extent of the real image
        inside the padded canvas.
      anchors_xywh: ``(H, W, A, 4)`` anchor grid in feature units.
      std_scaling: the regression divisor; the cascade passes a float32
        tensor on the device, since a Python float is uploaded on every call
        and the upload waits for the card.
    """
    b, feat_h, feat_w, num_anchors = rpn_cls.shape
    deltas = rpn_regr.float().reshape(b, feat_h, feat_w, num_anchors, 4)
    # A device tensor divisor: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal, which rounds differently.
    deltas = deltas / torch.as_tensor(std_scaling, dtype=torch.float32, device=deltas.device)
    boxes_xywh = decode_boxes(anchors_xywh, deltas, round_outputs=True)

    x, y, w, h = boxes_xywh.unbind(-1)
    w = w.clamp_min(1.0)
    h = h.clamp_min(1.0)
    x2 = x + w
    y2 = y + h
    hi_x = (valid_fw.float() - 1.0)[:, None, None, None]
    hi_y = (valid_fh.float() - 1.0)[:, None, None, None]
    zero = torch.zeros((), device=x.device)
    x1 = torch.minimum(torch.maximum(x, zero), hi_x)
    y1 = torch.minimum(torch.maximum(y, zero), hi_y)
    x2 = torch.minimum(torch.maximum(x2, zero), hi_x)
    y2 = torch.minimum(torch.maximum(y2, zero), hi_y)

    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(b, -1, 4)
    scores = rpn_cls.float().reshape(b, -1)

    dev = rpn_cls.device
    cell_x = torch.arange(feat_w, device=dev)[None, None, :, None]
    cell_y = torch.arange(feat_h, device=dev)[None, :, None, None]
    in_valid = (cell_x < valid_fw[:, None, None, None]) & (cell_y < valid_fh[:, None, None, None])
    in_valid = in_valid.expand(b, feat_h, feat_w, num_anchors).reshape(b, -1)
    nondegenerate = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
    valid = nondegenerate & in_valid

    cand_boxes, cand_scores, cand_valid = topk_candidates(
        boxes, scores, valid, min(pre_nms_top_n, boxes.shape[1])
    )
    out = nms_fixed_point(
        cand_boxes, cand_scores, cand_valid, nms_thresh, max_out=post_nms_top_n, cast_int=True
    )
    return Proposals(*out)
