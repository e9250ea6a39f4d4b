"""The joint train step and the eval step.

One step, with no read back to the host:

  photometric augmentation + centring -> trunk (once) -> RPN heads
    -> RPN losses -> proposals from the detached RPN outputs (decode + NMS)
    -> second-stage targets and the balanced RoI sample
    -> RoI pooling + detector head -> detector losses
    -> one backward of the summed loss -> one Adam update.

This is "approximate joint training": proposals come from the RPN before
the update, and one optimizer updates the shared trunk once with the summed
loss.  With the trunk frozen, the feature map is detached, so no backward
runs through the trunk; with it trainable, the detector loss reaches the
trunk through the RoI-pool gradient (``ops/roi_align.py``).

Random choices are a :class:`StepDraws` per step, drawn by :func:`draw_step`
from a ``torch.Generator`` on the device.  ``Config.train_bundle_steps``
(the JAX package fuses K steps into one program with the same trajectory
as K single steps) runs as K single steps here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from radnet_torch import losses
from radnet_torch.config import Config, feature_extent
from radnet_torch.data.pipeline import preprocess_on_device
from radnet_torch.engine.train_state import TrainState
from radnet_torch.models.detector import FasterRCNN
from radnet_torch.ops import augment_device
from radnet_torch.ops.anchors import feature_anchors_xywh, image_anchors_xyxy
from radnet_torch.ops.proposals import decode_proposals
from radnet_torch.ops.targets import proposal_targets, rpn_targets, subset_bits

METRIC_KEYS = ("loss_rpn_cls", "loss_rpn_regr", "loss_detector_cls", "loss_detector_regr",
               "total_loss", "detector_acc", "mean_overlapping_bboxes")


@dataclasses.dataclass
class StepDraws:
    """The random inputs of one step: the subsample's random words ``(B,
    N)`` int32 (N = H * W * A anchors), the RoI sample's uniforms ``(B,
    post_nms_top_n)``, and the photometric draws (None: no augmentation)."""

    rpn_pos_bits: torch.Tensor
    rpn_neg_bits: torch.Tensor
    roi_pos_u: torch.Tensor
    roi_neg_u: torch.Tensor
    photometric: augment_device.PhotometricDraws | None = None

    def to(self, device) -> "StepDraws":
        photo = None if self.photometric is None else self.photometric.to(device)
        return StepDraws(self.rpn_pos_bits.to(device), self.rpn_neg_bits.to(device),
                         self.roi_pos_u.to(device), self.roi_neg_u.to(device), photo)


def draw_step(gen: torch.Generator, config: Config, b: int, device,
              photometric: bool = True) -> StepDraws:
    """One step's draws from ``gen`` (a generator on ``device``)."""
    n = config.feat_size * config.feat_size * config.n_anchors
    hi = 1 << subset_bits(n)[1]
    p = config.post_nms_top_n

    def bits():
        return torch.randint(0, hi, (b, n), generator=gen, device=device, dtype=torch.int32)

    draws = StepDraws(bits(), bits(), torch.rand((b, p), generator=gen, device=device),
                      torch.rand((b, p), generator=gen, device=device))
    if (photometric and config.augment_photometric_on_device
            and (config.use_brightness or config.use_noise)):
        s = config.canvas_size
        draws.photometric = augment_device.draw_photometric(
            gen, b, s, s, 3, augment_device.grey_mode(config), device)
    return draws


@dataclasses.dataclass
class StepConstants:
    """Device tensors every step reads, uploaded once: an upload from
    pageable memory waits for the card."""

    img_anchors: torch.Tensor  # (H, W, A, 4) xyxy canvas px
    feat_anchors: torch.Tensor  # (H, W, A, 4) xywh feature units
    std_scaling: torch.Tensor  # () float32
    regr_std: torch.Tensor  # (4,) float32


def step_constants(config: Config, device) -> StepConstants:
    f = config.feat_size
    scales = tuple(config.anchor_box_scales)
    ratios = tuple(tuple(r) for r in config.anchor_box_ratios)

    def up(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return StepConstants(
        up(image_anchors_xyxy(f, f, scales, ratios, config.rpn_stride)),
        up(feature_anchors_xywh(f, f, scales, ratios, config.rpn_stride)),
        up(config.std_scaling), up(config.classifier_regr_std))


def _augment_and_preprocess(config: Config, images: torch.Tensor, draws: StepDraws,
                            deterministic: bool) -> torch.Tensor:
    """Photometric augmentation (training, uint8 canvases) then centring."""
    if not deterministic and draws.photometric is not None and images.dtype == torch.uint8:
        images = augment_device.photometric_augment(
            images, draws.photometric, augment_device.grey_mode(config),
            use_brightness=config.use_brightness, use_noise=config.use_noise,
        ).to(torch.uint8)  # integer-valued 0..255
    return preprocess_on_device(images)


def compute_losses(model: FasterRCNN, config: Config, batch: dict, draws: StepDraws,
                   consts: StepConstants, deterministic: bool,
                   trunk_frozen: bool = False) -> tuple[torch.Tensor, dict]:
    """Forward pass and the four losses of one batch of tiles: (total loss,
    metrics as 0-d tensors on the device)."""
    images = _augment_and_preprocess(config, batch["image"], draws, deterministic)
    sample_valid = batch["sample_valid"].float()
    valid_wh = batch["valid_wh"]

    tg = rpn_targets(
        batch["gt_boxes"], batch["gt_mask"], valid_wh[:, 0], valid_wh[:, 1],
        consts.img_anchors, draws.rpn_pos_bits, draws.rpn_neg_bits,
        rpn_min_overlap=config.rpn_min_overlap, rpn_max_overlap=config.rpn_max_overlap,
        max_regions=config.rpn_max_regions, std_scaling=config.std_scaling,
        reference_neg_budget=config.rpn_reference_neg_budget,
        fallback_min_iou=config.rpn_fallback_min_iou,
    )
    sv = sample_valid[:, None, None, None]  # padded samples contribute nothing
    y_rpn_cls, y_rpn_regr = tg.y_rpn_cls * sv, tg.y_rpn_regr * sv

    fmap = model.features(images)
    if trunk_frozen:
        fmap = fmap.detach()
    rpn_cls, rpn_regr = model.rpn(fmap)
    n_anchors = config.n_anchors
    l_rpn_cls = losses.rpn_loss_cls(y_rpn_cls, rpn_cls, n_anchors)
    l_rpn_regr = losses.rpn_loss_regr(y_rpn_regr, rpn_regr, n_anchors)

    props = decode_proposals(
        rpn_cls.detach(), rpn_regr.detach(),
        feature_extent(valid_wh[:, 0], config.network),
        feature_extent(valid_wh[:, 1], config.network),
        consts.feat_anchors, std_scaling=consts.std_scaling,
        pre_nms_top_n=config.pre_nms_top_n, post_nms_top_n=config.post_nms_top_n,
        nms_thresh=config.rpn_nms_thresh,
    )
    pt = proposal_targets(
        props.boxes, props.valid, batch["gt_boxes"], batch["gt_classes"], batch["gt_mask"],
        draws.roi_pos_u, draws.roi_neg_u, consts.regr_std,
        n_classes=config.n_classes, n_rois=config.n_rois, stride=config.rpn_stride,
        classifier_min_overlap=config.classifier_min_overlap,
        classifier_max_overlap=config.classifier_max_overlap,
    )
    roi_mask = pt.roi_valid.float() * sample_valid[:, None]

    det_cls, det_regr = model.roi_heads(fmap, pt.rois)
    l_det_cls = losses.class_loss_cls(pt.y_class, det_cls, roi_mask)
    l_det_regr = losses.class_loss_regr(pt.y_regr, det_regr, config.n_classes - 1, roi_mask)
    acc = losses.detector_accuracy(pt.y_class, det_cls, roi_mask)

    total = l_rpn_cls + l_rpn_regr + l_det_cls + l_det_regr
    n_valid = sample_valid.sum().clamp_min(1.0)
    metrics = {
        "loss_rpn_cls": l_rpn_cls, "loss_rpn_regr": l_rpn_regr,
        "loss_detector_cls": l_det_cls, "loss_detector_regr": l_det_regr,
        "total_loss": total, "detector_acc": acc,
        # Positive RoIs per image before sampling.
        "mean_overlapping_bboxes": (pt.n_pos.float() * sample_valid).sum() / n_valid,
    }
    return total, {k: v.detach() for k, v in metrics.items()}


def make_train_step(state: TrainState, config: Config, trunk_trainable: bool | None = None):
    """``step(batch, draws) -> metrics``: one Adam update of ``state`` in
    place.  ``trunk_trainable`` must match the partition the optimizer was
    built with (default ``config.base_net_trainable``)."""
    if trunk_trainable is None:
        trunk_trainable = config.base_net_trainable
    consts = step_constants(config, next(state.model.parameters()).device)

    def train_step(batch: dict, draws: StepDraws) -> dict:
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = compute_losses(state.model, config, batch, draws, consts, False,
                                        trunk_frozen=not trunk_trainable)
        total.backward()
        state.optimizer.step()
        state.step += 1
        return metrics

    return train_step


def make_eval_step(state: TrainState, config: Config):
    """``step(batch, draws) -> metrics``: losses only, no augmentation."""
    consts = step_constants(config, next(state.model.parameters()).device)

    @torch.no_grad()
    def eval_step(batch: dict, draws: StepDraws) -> dict:
        return compute_losses(state.model, config, batch, draws, consts, True)[1]

    return eval_step
