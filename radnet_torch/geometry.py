"""Box geometry in float32: all-pairs IoU and the delta decode.

Boxes are ``(..., 4)`` in ``(x1, y1, x2, y2)`` ("xyxy") or ``(x, y, w, h)``
("xywh") layout as stated per function.  Every expression keeps the JAX
package's float32 operation order, so integer-valued boxes give the same
bits in both packages.
"""

from __future__ import annotations

import torch

EPS = 1e-6


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs IoU of xyxy boxes, batched: ``a (..., N, 4)``, ``b (..., M,
    4)`` -> ``(..., N, M)`` float32.

    Degenerate boxes (x1 >= x2 or y1 >= y2) get IoU 0, and the union
    carries a ``1e-6`` stabiliser in the denominator.
    """
    a = a.float()
    b = b.float()
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    iou = inter / (union + EPS)
    valid_a = (a[..., 2] > a[..., 0]) & (a[..., 3] > a[..., 1])
    valid_b = (b[..., 2] > b[..., 0]) & (b[..., 3] > b[..., 1])
    valid = valid_a[..., :, None] & valid_b[..., None, :]
    return torch.where(valid, iou, torch.zeros_like(iou))


def decode_boxes(
    anchors_xywh: torch.Tensor, deltas: torch.Tensor, *, round_outputs: bool = True
) -> torch.Tensor:
    """Apply ``(tx, ty, tw, th)`` deltas to xywh anchors.

    Centre shift by ``t * size``, log-size scaling with the exponent clamped
    to [-10, 10], then round half to even.  Returns xywh float32.
    """
    x, y, w, h = anchors_xywh.unbind(-1)
    tx, ty, tw, th = deltas.unbind(-1)
    cx = x + w / 2.0
    cy = y + h / 2.0
    cx1 = tx * w + cx
    cy1 = ty * h + cy
    w1 = torch.exp(tw.clamp(-10.0, 10.0)) * w
    h1 = torch.exp(th.clamp(-10.0, 10.0)) * h
    x1 = cx1 - w1 / 2.0
    y1 = cy1 - h1 / 2.0
    out = torch.stack([x1, y1, w1, h1], dim=-1)
    if round_outputs:
        out = torch.round(out)
    return out.float()


def encode_boxes(anchors_xyxy: torch.Tensor, gt_xyxy: torch.Tensor) -> torch.Tensor:
    """Regression targets ``(tx, ty, tw, th)`` of ``gt`` against ``anchors``:
    centre offset over the anchor size, log of the size ratio.  Shapes
    broadcast; a non-positive anchor size divides by 1 and a ground-truth
    size is floored at ``1e-6`` (callers mask those rows)."""
    a = anchors_xyxy.float()
    g = gt_xyxy.float()
    aw = a[..., 2] - a[..., 0]
    ah = a[..., 3] - a[..., 1]
    acx = (a[..., 0] + a[..., 2]) / 2.0
    acy = (a[..., 1] + a[..., 3]) / 2.0
    gw = g[..., 2] - g[..., 0]
    gh = g[..., 3] - g[..., 1]
    gcx = (g[..., 0] + g[..., 2]) / 2.0
    gcy = (g[..., 1] + g[..., 3]) / 2.0
    one = torch.ones((), device=a.device)
    aw_safe = torch.where(aw > 0, aw, one)
    ah_safe = torch.where(ah > 0, ah, one)
    tx = (gcx - acx) / aw_safe
    ty = (gcy - acy) / ah_safe
    tw = torch.log(gw.clamp_min(EPS) / aw_safe)
    th = torch.log(gh.clamp_min(EPS) / ah_safe)
    return torch.stack([tx, ty, tw, th], dim=-1)


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)
