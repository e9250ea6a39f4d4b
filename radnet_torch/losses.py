"""Detection losses, with the masks and packing of the training targets.

* ``y_rpn_cls``  = cat([is_valid (A), overlap (A)]) on the channel axis;
* ``y_rpn_regr`` = cat([overlap repeated 4 times (4A), targets * std (4A)]);
* ``y_det_cls``  = one-hot over ``n_classes`` (background last);
* ``y_det_regr`` = cat([labels (4K), coords * std (4K)]), K = n_classes - 1.

Every loss is a masked sum over the mask's sum plus ``1e-4`` per element,
with weights 1.0, in float32.  On a mesh each rank holds some of the
batch's tiles: it passes the whole batch's denominator (``den``, ``n_rois``:
its own summed over the data axis, :func:`rpn_denominators`,
:func:`detector_denominators`), so its loss is its share of the whole
batch's ratio of sums, and the shares' gradients sum to the whole one.  Probabilities are clipped as ``jnp.clip``
differentiates a clip: a value exactly at a bound (a saturated sigmoid or
softmax) passes half its gradient.
"""

from __future__ import annotations

import torch

EPSILON = 1e-4


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``x`` clipped to [lo, hi] by max and min, whose gradients split a tie
    evenly, as JAX's do (``Tensor.clamp`` passes all of it).  The bounds are
    CPU scalars, so nothing is uploaded."""
    return torch.minimum(torch.maximum(x, torch.tensor(lo)), torch.tensor(hi))


def _smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """0.5 x^2 for |x| <= 1, else |x| - 0.5."""
    x_abs = x.abs()
    return torch.where(x_abs <= 1.0, 0.5 * x * x, x_abs - 0.5)


def _masked_den(mask: torch.Tensor) -> torch.Tensor:
    return (EPSILON + mask).sum()


def _masked_mean(num: torch.Tensor, mask: torch.Tensor, den: torch.Tensor | None) -> torch.Tensor:
    return num.sum() / (_masked_den(mask) if den is None else den)


def _regr_mask(y_true: torch.Tensor, num_classes: int, roi_mask: torch.Tensor | None):
    mask = y_true[..., : 4 * num_classes]
    return mask if roi_mask is None else mask * roi_mask[..., None]


def rpn_denominators(y_cls: torch.Tensor, y_regr: torch.Tensor,
                     num_anchors: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``den`` of :func:`rpn_loss_cls` and :func:`rpn_loss_regr` on
    these tiles."""
    return _masked_den(y_cls[..., :num_anchors]), _masked_den(y_regr[..., : 4 * num_anchors])


def detector_denominators(y_regr: torch.Tensor, num_classes: int,
                          roi_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``n_rois`` of :func:`class_loss_cls` and :func:`detector_accuracy`,
    and the ``den`` of :func:`class_loss_regr`, on these tiles."""
    return roi_mask.sum(), _masked_den(_regr_mask(y_regr, num_classes, roi_mask))


def rpn_loss_regr(y_true: torch.Tensor, y_pred: torch.Tensor, num_anchors: int,
                  den: torch.Tensor | None = None) -> torch.Tensor:
    """Masked smooth-L1 over the RPN regression channels: ``y_true`` (B, H,
    W, 8A), ``y_pred`` (B, H, W, 4A)."""
    mask = y_true[..., : 4 * num_anchors]
    target = y_true[..., 4 * num_anchors:]
    return _masked_mean(mask * _smooth_l1(target - y_pred.float()), mask, den)


def rpn_loss_cls(y_true: torch.Tensor, y_pred: torch.Tensor, num_anchors: int,
                 den: torch.Tensor | None = None) -> torch.Tensor:
    """Masked binary cross-entropy over RPN objectness: ``y_true`` (B, H, W,
    2A), ``y_pred`` (B, H, W, A) after the sigmoid."""
    valid = y_true[..., :num_anchors]
    label = y_true[..., num_anchors:]
    p = _clip(y_pred.float(), 1e-7, 1.0 - 1e-7)
    bce = -(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p))
    return _masked_mean(valid * bce, valid, den)


def class_loss_regr(y_true: torch.Tensor, y_pred: torch.Tensor, num_classes: int,
                    roi_mask: torch.Tensor | None = None,
                    den: torch.Tensor | None = None) -> torch.Tensor:
    """Masked smooth-L1 over the per-class detector regression: ``y_true``
    (B, R, 8K), K = ``num_classes`` foreground classes; ``roi_mask`` (B, R)."""
    mask = _regr_mask(y_true, num_classes, roi_mask)
    target = y_true[..., 4 * num_classes:]
    return _masked_mean(mask * _smooth_l1(target - y_pred.float()), mask, den)


def class_loss_cls(y_true: torch.Tensor, y_pred: torch.Tensor,
                   roi_mask: torch.Tensor | None = None,
                   n_rois: torch.Tensor | None = None) -> torch.Tensor:
    """Categorical cross-entropy over RoIs, ``y_pred`` after the softmax."""
    p = _clip(y_pred.float(), 1e-7, 1.0)
    ce = -(y_true * torch.log(p)).sum(-1)  # (B, R)
    if roi_mask is None:
        return ce.mean()
    return (ce * roi_mask).sum() / ((roi_mask.sum() if n_rois is None else n_rois) + EPSILON)


def detector_accuracy(y_true: torch.Tensor, y_pred: torch.Tensor,
                      roi_mask: torch.Tensor | None = None,
                      n_rois: torch.Tensor | None = None) -> torch.Tensor:
    """Share of RoIs whose most probable class is the labelled one."""
    hit = (torch.argmax(y_pred, dim=-1) == torch.argmax(y_true, dim=-1)).float()
    if roi_mask is None:
        return hit.mean()
    return (hit * roi_mask).sum() / ((roi_mask.sum() if n_rois is None else n_rois) + EPSILON)
