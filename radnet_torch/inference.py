"""Inference engine: tiled panel prediction with the cascade on the device.

A panel at least one tile in size, with the uniform tiling, takes the
prescaled path: the whole panel is downscaled once by ``img_size /
tile_size`` (bicubic, on the device), every ``img_size`` window is sliced
from the small panel onto a zero canvas, and batches of canvases run the
tile cascade (:meth:`RADNet._predict_tiles_impl`): centring, ResNet50 trunk,
RPN, proposal decode + NMS, RoI pooling, the stage-5 head, class-specific
decode and per-class NMS.  The host then lifts the boxes to panel
coordinates and merges them across tiles (cluster-average NMS) and across
image types.

Output: a list of ``{'class', 'prob', 'x1', 'y1', 'x2', 'y2'}`` dicts in
panel coordinates.
"""

from __future__ import annotations

import os
from typing import Any, Sequence

import numpy as np
import torch

from radnet_torch.config import Config, feature_extent
from radnet_torch.data.pipeline import preprocess_on_device
from radnet_torch.data.tiling import plan_tiles
from radnet_torch.geometry import decode_boxes, xyxy_to_xywh
from radnet_torch.models.detector import FasterRCNN, build_model
from radnet_torch.ops.anchors import feature_anchors_xywh
from radnet_torch.ops.nms import final_nms_cluster, nms_fixed_point, nms_numpy
from radnet_torch.ops.proposals import Proposals, decode_proposals
from radnet_torch.ops.resize import resize_cubic_u8

WEIGHTS_FILE = "model.pt"


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class RADNet:
    """Rock-art detector: tiled panels -> merged detections."""

    def __init__(self, config: Config, model: FasterRCNN, device="cuda", mesh=None):
        self.device = resolve_device(device)
        if mesh is not None:
            raise _not_ported("multi-device serving (a mesh)", "Queue 1 item 13")
        if config.include_full_img:
            raise _not_ported("include_full_img (shortest-side canvases)", "Queue 1 item 11")
        self.C = config
        self.model = model.to(self.device).eval()
        self.class_mapping = config.inv_class_mapping
        self.bbox_threshold = config.bbox_threshold
        self.tile_batch = config.infer_tile_batch
        f = config.feat_size
        anchors = feature_anchors_xywh(
            f, f,
            tuple(config.anchor_box_scales),
            tuple(tuple(r) for r in config.anchor_box_ratios),
            config.rpn_stride,
        )
        self._feat_anchors = torch.from_numpy(np.array(anchors)).to(self.device)
        self._regr_std = torch.tensor(config.classifier_regr_std, dtype=torch.float32,
                                      device=self.device)

    # ------------------------------------------------------------------ #
    # Host helpers.
    # ------------------------------------------------------------------ #
    @staticmethod
    def _grey_channel(img: np.ndarray) -> np.ndarray | None:
        """The single channel of a grey 3-channel panel, else None."""
        if img.ndim != 3 or img.shape[2] != 3:
            return None
        c0 = img[..., 0]
        if np.array_equal(c0, img[..., 1]) and np.array_equal(c0, img[..., 2]):
            return np.ascontiguousarray(c0)
        return None

    @staticmethod
    def _panel_bucket_pad(img: torch.Tensor, bucket: int) -> torch.Tensor:
        """Zero-pad the panel's dims up to a bucket multiple (windows never
        touch the padding)."""
        h, w = img.shape[:2]
        hb = -(-h // bucket) * bucket
        wb = -(-w // bucket) * bucket
        if (hb, wb) == (h, w):
            return img
        padded = img.new_zeros((hb, wb) + tuple(img.shape[2:]))
        padded[:h, :w] = img
        return padded

    def _batch_schedule(self, n: int) -> list[tuple[int, int]]:
        """(start, batch_size) pairs covering ``n`` tiles; a remainder that
        fits in half a batch goes through a half-size batch."""
        bs = self.tile_batch
        schedule = [(s, bs) for s in range(0, (n // bs) * bs, bs)]
        rem = n - (n // bs) * bs
        if rem:
            half = bs // 2
            if not self.C.infer_tail_subbatch or rem > half or half == 0:
                half = bs
            schedule.append(((n // bs) * bs, half))
        return schedule

    # ------------------------------------------------------------------ #
    # The tile cascade, one stage per method so each can be timed alone.
    # ------------------------------------------------------------------ #
    def _features(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 ``(T, S, S, 3)`` canvases -> channels-last feature map."""
        return self.model.features(preprocess_on_device(images))

    def _proposals(self, fmap: torch.Tensor, valid_wh: torch.Tensor) -> Proposals:
        cfg = self.C
        rpn_cls, rpn_regr = self.model.rpn(fmap)
        return decode_proposals(
            rpn_cls,
            rpn_regr,
            feature_extent(valid_wh[:, 0], cfg.network),
            feature_extent(valid_wh[:, 1], cfg.network),
            self._feat_anchors,
            std_scaling=cfg.std_scaling,
            pre_nms_top_n=cfg.pre_nms_top_n,
            post_nms_top_n=cfg.post_nms_top_n,
            nms_thresh=cfg.rpn_nms_thresh,
        )

    def _head(self, fmap: torch.Tensor, props: Proposals):
        """RoI pooling + stage-5 head over the surviving proposals."""
        cfg = self.C
        prop_boxes, prop_valid = props.boxes, props.valid
        if cfg.max_head_rois and cfg.max_head_rois < prop_boxes.shape[1]:
            prop_boxes = prop_boxes[:, : cfg.max_head_rois]
            prop_valid = prop_valid[:, : cfg.max_head_rois]
        rois = xyxy_to_xywh(prop_boxes)
        det_cls, det_regr = self.model.roi_heads(fmap, rois)
        return det_cls, det_regr, rois, prop_valid

    def _detections(self, det_cls, det_regr, rois, prop_valid):
        """Score cut, class-specific decode and per-class NMS: (boxes (T, K,
        D, 4) in canvas px, scores (T, K, D), valid (T, K, D))."""
        cfg = self.C
        n_fg = cfg.n_classes - 1
        best_prob = det_cls.amax(dim=-1)
        best_cls = torch.argmax(det_cls, dim=-1)  # first maximum, as jnp.argmax
        keep = prop_valid & (best_prob >= self.bbox_threshold) & (best_cls != cfg.bg_class_id)

        t, r = det_regr.shape[:2]
        deltas_by_class = det_regr.reshape(t, r, n_fg, 4)
        cls_idx = best_cls.clamp_max(n_fg - 1)
        deltas = torch.gather(deltas_by_class, 2, cls_idx[..., None, None].expand(t, r, 1, 4))[:, :, 0]
        decoded = decode_boxes(rois, deltas / self._regr_std, round_outputs=True)
        dx, dy, dw, dh = decoded.unbind(-1)
        boxes = cfg.rpn_stride * torch.stack([dx, dy, dx + dw, dy + dh], dim=-1)

        # One NMS over every (tile, class): the class mask folds into validity.
        classes = torch.arange(n_fg, device=boxes.device)
        valid = keep[:, None, :] & (best_cls[:, None, :] == classes[None, :, None])
        d = cfg.max_detections_per_tile
        out_boxes, out_scores, out_valid = nms_fixed_point(
            boxes[:, None].expand(t, n_fg, r, 4).reshape(t * n_fg, r, 4),
            best_prob[:, None].expand(t, n_fg, r).reshape(t * n_fg, r),
            valid.reshape(t * n_fg, r),
            cfg.detection_nms_thresh,
            max_out=d,
        )
        return (
            out_boxes.reshape(t, n_fg, d, 4),
            out_scores.reshape(t, n_fg, d),
            out_valid.reshape(t, n_fg, d),
        )

    @torch.inference_mode()
    def _predict_tiles_impl(self, images: torch.Tensor, valid_wh: torch.Tensor):
        """uint8 ``(T, S, S, 3)`` canvases + ``(T, 2)`` valid extents ->
        per-class detections (see :meth:`_detections`)."""
        if images.shape[-1] != 3 or images.dtype != torch.uint8:
            raise _not_ported("the host-s2d 12-channel tile branch", "Queue 1 item 7")
        fmap = self._features(images)
        props = self._proposals(fmap, valid_wh)
        return self._detections(*self._head(fmap, props))

    # ------------------------------------------------------------------ #
    # Panel orchestration.
    # ------------------------------------------------------------------ #
    def predict(self, images: Sequence[np.ndarray]) -> list[dict[str, Any]]:
        """Multi-tile, multi-image-type prediction."""
        return self.predict_collect(self.predict_dispatch(images))

    def warmup(self, img: np.ndarray) -> None:
        """Run ``img`` and then every tile-batch size serving can hit (the
        full batch and, with ``infer_tail_subbatch``, the half batch), so the
        first real panel pays no first-call cost."""
        self.predict([img])
        cfg = self.C
        if cfg.max_n_tiles_train <= 0:
            return
        tiles = plan_tiles(img.shape[1], img.shape[0], cfg.tile_size, cfg.tile_overlap)
        covered = {bs for _, bs in self._batch_schedule(len(tiles))}
        want = {self.tile_batch}
        half = self.tile_batch // 2
        if cfg.infer_tail_subbatch and half > 0:
            want.add(half)
        for bs in sorted(want - covered, reverse=True):
            pending: list = []
            self._dispatch_tiles(img, np.repeat(tiles[:1], bs, axis=0), pending)
            self._drain_tiles(pending, {}, {})

    def predict_dispatch(self, images: Sequence[np.ndarray]) -> list[list]:
        """Run every image's tile batches; results stay on the device until
        :meth:`predict_collect`."""
        cfg = self.C
        per_image_pending = []
        for img in images:
            pending: list = []
            if cfg.max_n_tiles_train > 0:
                tiles = plan_tiles(img.shape[1], img.shape[0], cfg.tile_size, cfg.tile_overlap)
                self._dispatch_tiles(img, tiles, pending)
            per_image_pending.append(pending)
        return per_image_pending

    def predict_collect(self, per_image_pending: list[list]) -> list[dict[str, Any]]:
        """Fetch dispatched tile batches and run the host-side merges."""
        cfg = self.C
        all_bbox: dict[str, list] = {}
        all_probs: dict[str, list] = {}
        for pending in per_image_pending:
            bbox_total: dict[str, list] = {}
            probs_total: dict[str, list] = {}
            self._drain_tiles(pending, bbox_total, probs_total)
            # Cross-tile cluster-average NMS per class.
            for key in bbox_total:
                nb, np_ = final_nms_cluster(
                    np.array(bbox_total[key]),
                    np.array(probs_total[key]),
                    obj_avg_threshold=0.2,
                    obj_confidence_threshold=0.8,
                    n_obj_avg=5,
                )
                for j in range(len(nb)):
                    all_bbox.setdefault(key, []).append(nb[j].tolist())
                    all_probs.setdefault(key, []).append(float(np_[j]))

        # Cross-image-type merge.
        detections: list[dict[str, Any]] = []
        for key in all_bbox:
            nb, np_ = nms_numpy(
                np.array(all_bbox[key]),
                np.array(all_probs[key]),
                overlap_thresh=cfg.cross_type_nms_thresh,
            )
            for j in range(nb.shape[0]):
                x1, y1, x2, y2 = nb[j]
                detections.append(
                    {"class": key, "prob": float(np_[j]),
                     "x1": int(x1), "y1": int(y1), "x2": int(x2), "y2": int(y2)}
                )
        return detections

    def _prescale_panel(self, img: np.ndarray) -> tuple[torch.Tensor, float, int, int]:
        """The panel downscaled once by ``img_size / tile_size`` on the
        device (one channel for a grey panel), bucket-padded to 128."""
        cfg = self.C
        scale = float(cfg.img_size) / cfg.tile_size
        sw = max(cfg.img_size, int(round(img.shape[1] * scale)))
        sh = max(cfg.img_size, int(round(img.shape[0] * scale)))
        grey = self._grey_channel(img)
        src = torch.from_numpy(grey if grey is not None else np.ascontiguousarray(img))
        small = resize_cubic_u8(src.to(self.device), sw, sh)
        return self._panel_bucket_pad(small, bucket=128), scale, sw, sh

    def _window_canvases(self, small: torch.Tensor, origins: np.ndarray) -> torch.Tensor:
        """``img_size`` windows of the small panel at ``origins`` (x, y), each
        on the top-left of a zero ``canvas_size`` canvas: (T, S, S, 3) uint8."""
        cfg = self.C
        s, out = cfg.canvas_size, cfg.img_size
        canvases = torch.zeros((len(origins), s, s, 3), dtype=torch.uint8, device=self.device)
        for i, (x, y) in enumerate(origins.tolist()):
            win = small[y : y + out, x : x + out]
            canvases[i, :out, :out] = win[..., None] if win.dim() == 2 else win
        return canvases

    def _dispatch_tiles(self, img: np.ndarray, tiles: np.ndarray, pending: list) -> None:
        """Run every tile batch of one image, appending to ``pending``."""
        cfg = self.C
        ts = cfg.tile_size
        uniform_windows = bool(
            len(tiles) > 0
            and (tiles[:, 2] - tiles[:, 0] == ts).all()
            and (tiles[:, 3] - tiles[:, 1] == ts).all()
        )
        device_tiling = (
            cfg.infer_device_tiling and uniform_windows and img.shape[0] >= ts and img.shape[1] >= ts
        )
        prescale = device_tiling and cfg.infer_panel_prescale and cfg.img_size < ts
        if not prescale:
            if device_tiling:
                raise _not_ported("full-resolution device tiling", "Queue 1 item 11")
            if cfg.infer_shortest_side and len(tiles) > 0 and not bool(
                ((tiles[:, 2] - tiles[:, 0]) == (tiles[:, 3] - tiles[:, 1])).all()
            ):
                raise _not_ported("shortest-side rectangular canvases", "Queue 1 item 11")
            raise _not_ported("the host tile path", "Queue 1 item 7")

        small, scale, sw, sh = self._prescale_panel(img)
        valid = float(cfg.img_size)
        for start, bs in self._batch_schedule(len(tiles)):
            chunk = tiles[start : start + bs]
            slice_xy = np.round(chunk[:, :2] * scale).astype(np.int64)
            slice_xy[:, 0] = np.clip(slice_xy[:, 0], 0, sw - cfg.img_size)
            slice_xy[:, 1] = np.clip(slice_xy[:, 1], 0, sh - cfg.img_size)
            origins = np.zeros((bs, 2), np.int64)
            origins[: len(chunk)] = slice_xy
            images = self._window_canvases(small, origins)
            valid_wh = torch.full((bs, 2), valid, dtype=torch.float32, device=self.device)
            out = self._predict_tiles_impl(images, valid_wh)
            # Effective panel-space origins of the rounded slices, so the
            # coordinate lift stays exact to under one panel pixel.
            chunk_eff = np.array(chunk, copy=True)
            chunk_eff[:, 0] = np.round(slice_xy[:, 0] / scale)
            chunk_eff[:, 1] = np.round(slice_xy[:, 1] / scale)
            pending.append((out, np.full(bs, scale), chunk_eff, len(chunk)))

    def _drain_tiles(self, pending: list, bbox_total, probs_total) -> None:
        """Fetch tile-batch results in order and lift them to the panel."""
        n_fg = self.C.n_classes - 1
        for out, scales, chunk, n in pending:
            boxes, scores, valid = (t.cpu().numpy() for t in out)
            for i in range(n):
                tile = chunk[i]
                ratio = scales[i]
                for c in range(n_fg):
                    v = valid[i, c]
                    if not v.any():
                        continue
                    cls_name = self.class_mapping[c]
                    for b, p in zip(boxes[i, c][v], scores[i, c][v]):
                        # floor division by the resize ratio
                        rx1, ry1, rx2, ry2 = (int(v0 // ratio) for v0 in b)
                        if rx2 <= rx1 or ry2 <= ry1:
                            continue
                        bbox_total.setdefault(cls_name, []).append(
                            [tile[0] + rx1, tile[1] + ry1, tile[0] + rx2, tile[1] + ry2]
                        )
                        probs_total.setdefault(cls_name, []).append(float(p))


def save_radnet(model_dir: str, config: Config, model: FasterRCNN) -> None:
    """Write ``config.json`` and the model's float32 state_dict."""
    os.makedirs(model_dir, exist_ok=True)
    config.save(os.path.join(model_dir, "config.json"))
    state = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(model_dir, WEIGHTS_FILE))


def load_radnet(model_dir: str, device="cuda") -> RADNet:
    """Build a RADNet from a model directory written by :func:`save_radnet`."""
    device = resolve_device(device)
    config = Config.load(os.path.join(model_dir, "config.json"))
    path = os.path.join(model_dir, WEIGHTS_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: no torch weights (converting a JAX checkpoint is ROADMAP Queue 1 item 1)"
        )
    model = build_model(config)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return RADNet(config, model, device=device)
