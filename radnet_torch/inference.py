"""Inference engine: tiled panel prediction with the cascade on the device.

Batches of tile canvases run the tile cascade
(:meth:`RADNet._predict_tiles_impl`): centring, the trunk (ResNet50 or
VGG16), RPN, proposal decode + NMS, RoI pooling, the RoI head,
class-specific decode and per-class NMS.  The host then lifts the boxes to
panel coordinates and merges them across tiles (cluster-average NMS) and
across image types.

A panel's windows reach the cascade by one of four paths
(:meth:`RADNet._dispatch_tiles`):

* prescaled (the default for a panel at least one tile in size): the panel
  is downscaled once by ``img_size / tile_size`` on the device and the
  ``img_size`` windows are sliced onto zero canvases.  A grey panel ships
  one channel and its ``(T, S, S)`` canvases run the fused grey stem
  (``ops/grey_stem.py``) on ResNet50, and are repeated to 3 channels on
  the device for VGG16; a colour panel runs the 3-channel trunk;
* full resolution (``infer_panel_prescale=False``): each ``tile_size``
  window is sliced from the panel on the device and resized by two matrix
  products;
* shortest side (non-square windows: sub-tile panels, the
  ``include_full_img`` pass): the host resizes the shortest side to
  ``img_size`` onto a rectangular canvas bucket with its own anchor grid;
* host tiles (the rest): the host resizes each window onto the square
  canvas and ships it as 3 channels.  The JAX package ships these
  space-to-depth'd as 12 channels (``infer_host_s2d``) to fix the TPU's
  layout; that is the same conv on the same bytes, so the port ignores the
  field.

Output: a list of ``{'class', 'prob', 'x1', 'y1', 'x2', 'y2'}`` dicts in
panel coordinates.

On a mesh (``radnet_torch/parallel``: one process a device, every rank
running this class on the same panels), each batch's tiles split over the
data axis: data index d runs tiles ``[d B / dp, (d + 1) B / dp)`` through
the whole cascade, and every rank gathers the per-tile outputs over the
axis, so the host merges run on identical inputs everywhere.  The RoI head
splits over the model axis (``parallel/tp.py``).
"""

from __future__ import annotations

import functools
import os
from typing import Any, Sequence

import sys

import numpy as np
import torch

from radnet_torch.config import Config, backbone_feat_size, feature_extent
from radnet_torch.data.dataset import get_image
from radnet_torch.data.pipeline import (
    IMAGENET_BGR_MEAN,
    preprocess_on_device,
    resize_to_canvas,
    resize_to_canvas_shortest,
    shortest_side_dims,
)
from radnet_torch.data.tiling import plan_tiles
from radnet_torch.geometry import decode_boxes, xyxy_to_xywh
from radnet_torch.models.detector import FasterRCNN, build_model
from radnet_torch.ops.anchors import feature_anchors_xywh
from radnet_torch.ops.grey_stem import StemConsts, make_stem_consts, stem_constants
from radnet_torch.ops.nms import final_nms_cluster, nms_fixed_point, nms_numpy
from radnet_torch.ops.proposals import Proposals, decode_proposals
from radnet_torch.ops.resize import resize_bicubic, resize_cubic_u8
from radnet_torch.parallel.collectives import all_gather
from radnet_torch.parallel.mesh import DATA_AXIS, Mesh
from radnet_torch.parallel.tp import build_tp_head

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


class RADNet:
    """Rock-art detector: tiled panels -> merged detections."""

    def __init__(self, config: Config, model: FasterRCNN, device="cuda", mesh: Mesh | None = None):
        """``mesh``: this rank's :class:`~radnet_torch.parallel.mesh.Mesh`
        (``make_mesh`` inside a launched rank); the model then runs on the
        mesh's device, which must be of ``device``'s type.  The effective
        tile batch (``self.tile_batch``) is raised to a multiple of the data
        axis where needed; the Config is never changed."""
        if mesh is not None:
            if torch.device(device).type != mesh.device.type:
                raise ValueError(f"the mesh runs on {mesh.device}, not {device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.C = config
        self.model = model.to(self.device).eval()
        self.class_mapping = config.inv_class_mapping
        self.bbox_threshold = config.bbox_threshold
        self.mesh = mesh
        self._dp = 1 if mesh is None else mesh.data
        self.tile_batch = config.infer_tile_batch
        if config.infer_tile_batch % self._dp:
            self.tile_batch = -(-config.infer_tile_batch // self._dp) * self._dp
            print(f"infer_tile_batch={config.infer_tile_batch} not divisible by data-parallel "
                  f"size {self._dp}; using {self.tile_batch}", file=sys.stderr)
        # The tensor-parallel head, or None (no mesh, or a model axis of 1).
        self._tp_head = None if mesh is None else build_tp_head(self.model.head, mesh)
        # Anchor grids by canvas (H, W): the square canvas, and the buckets
        # of the shortest-side path.
        self._anchor_cache: dict[tuple[int, int], torch.Tensor] = {}
        self._feat_anchors = self._anchors_for_canvas((config.canvas_size, config.canvas_size))
        # Device constants of the cascade, uploaded once: an upload from
        # pageable memory waits for the card, and the cascade never does.
        self._regr_std = torch.tensor(config.classifier_regr_std, dtype=torch.float32,
                                      device=self.device)
        self._std_scaling = torch.tensor(config.std_scaling, dtype=torch.float32,
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
        fits in half a batch goes through a half-size batch, unless half a
        batch does not split over the mesh's data axis."""
        bs = self.tile_batch
        schedule = [(s, bs) for s in range(0, (n // bs) * bs, bs)]
        rem = n - (n // bs) * bs
        if rem:
            half = bs // 2
            if not self.C.infer_tail_subbatch or rem > half or half == 0 or half % self._dp:
                half = bs
            schedule.append(((n // bs) * bs, half))
        return schedule

    def _anchors_for_canvas(self, canvas_hw: tuple[int, int]) -> torch.Tensor:
        """The decode anchors of a ``(H, W)`` canvas, cached on the device."""
        a = self._anchor_cache.get(canvas_hw)
        if a is None:
            cfg = self.C
            grid = feature_anchors_xywh(
                backbone_feat_size(cfg.network, canvas_hw[0]),
                backbone_feat_size(cfg.network, canvas_hw[1]),
                tuple(cfg.anchor_box_scales),
                tuple(tuple(r) for r in cfg.anchor_box_ratios),
                cfg.rpn_stride,
            )
            a = self._anchor_cache[canvas_hw] = torch.from_numpy(np.array(grid)).to(self.device)
        return a

    @functools.cached_property
    def _grey_consts(self) -> StemConsts:
        """The grey stem's constants for the square canvas (ResNet50), folded
        once from the trunk's stem parameters: ``k7`` in the values of the
        compute type, and the centring as its compact table."""
        trunk = self.model.trunk
        bn = {k: getattr(trunk.bn_conv1, k) for k in ("gamma", "beta", "mean", "var")}
        consts = stem_constants(trunk.conv1.weight, trunk.conv1.bias, bn, self.C.canvas_size,
                                IMAGENET_BGR_MEAN, eps=trunk.bn_conv1.eps)
        return make_stem_consts(consts, self.model.dtype, self.device)

    # ------------------------------------------------------------------ #
    # The tile cascade, one stage per method so each can be timed alone.
    # ------------------------------------------------------------------ #
    def _features(self, images: torch.Tensor) -> torch.Tensor:
        """Canvases -> channels-last feature map.  ``images`` is one of:
        uint8 ``(T, S, S)`` grey canvases (ResNet50: the grey stem; VGG16:
        the channel repeated three times on the device, as the JAX package
        builds its canvases); uint8 ``(T, H, W, 3)`` canvases; float32 ``(T,
        H, W, 3)`` canvases already centred."""
        if images.dim() == 3:
            if self.model.network == "resnet50":
                return self.model.features_grey(images, self._grey_consts)
            images = images[..., None].expand(*images.shape, 3)
        return self.model.features(preprocess_on_device(images))

    def _proposals(self, fmap: torch.Tensor, valid_wh: torch.Tensor,
                   anchors: torch.Tensor | None = None) -> Proposals:
        cfg = self.C
        rpn_cls, rpn_regr = self.model.rpn(fmap)
        return decode_proposals(
            rpn_cls,
            rpn_regr,
            feature_extent(valid_wh[:, 0], cfg.network),
            feature_extent(valid_wh[:, 1], cfg.network),
            self._feat_anchors if anchors is None else anchors,
            std_scaling=self._std_scaling,
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
        det_cls, det_regr = self.model.roi_heads(fmap, rois, quantize=True, head=self._tp_head)
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

    def _data_slice(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's tiles of a batch: its data index's share of the rows."""
        if self._dp == 1:
            return t
        n = t.shape[0] // self._dp
        return t[self.mesh.data_index * n : (self.mesh.data_index + 1) * n]

    def _data_gather(self, outs) -> tuple:
        """Per-tile outputs of this rank's tiles -> the whole batch's, on
        every rank."""
        if self._dp == 1:
            return tuple(outs)
        return tuple(all_gather(t, self.mesh, DATA_AXIS) for t in outs)

    @torch.inference_mode()
    def _predict_tiles_impl(self, images: torch.Tensor, valid_wh: torch.Tensor,
                            feat_anchors: torch.Tensor | None = None):
        """Canvases (any form :meth:`_features` takes) + ``(T, 2)`` valid
        extents -> per-class detections (see :meth:`_detections`).
        ``feat_anchors``: the anchor grid of a non-square canvas.  On a
        mesh, this rank runs its data index's tiles and the outputs are
        gathered."""
        fmap = self._features(self._data_slice(images))
        props = self._proposals(fmap, self._data_slice(valid_wh), feat_anchors)
        return self._data_gather(self._detections(*self._head(fmap, props)))

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
        if len(tiles) == 0:
            return
        covered = {bs for _, bs in self._batch_schedule(len(tiles))}
        want = {self.tile_batch}
        half = self.tile_batch // 2
        if cfg.infer_tail_subbatch and half > 0 and half % self._dp == 0:
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
            if cfg.include_full_img:
                # The whole panel as one more window.
                full = np.array([[0, 0, img.shape[1], img.shape[0]]], dtype=np.int64)
                self._dispatch_tiles(img, full, pending)
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
        if self.device.type == "cuda":
            # Through pinned memory, so the upload does not wait for the card
            # to finish the work queued before it.
            src = src.pin_memory().to(self.device, non_blocking=True)
        small = resize_cubic_u8(src.to(self.device), sw, sh)
        return self._panel_bucket_pad(small, bucket=128), scale, sw, sh

    def _window_canvases(self, small: torch.Tensor, origins: np.ndarray) -> torch.Tensor:
        """``img_size`` windows of the small panel at ``origins`` (x, y), each
        on the top-left of a zero ``canvas_size`` canvas: uint8 (T, S, S)
        for a one-channel panel, else (T, S, S, 3)."""
        cfg = self.C
        s, out = cfg.canvas_size, cfg.img_size
        shape = (len(origins), s, s) + tuple(small.shape[2:])
        canvases = torch.zeros(shape, dtype=torch.uint8, device=self.device)
        for i, (x, y) in enumerate(origins.tolist()):
            canvases[i, :out, :out] = small[y : y + out, x : x + out]
        return canvases

    def _full_res_canvases(self, panel: torch.Tensor, origins: np.ndarray) -> torch.Tensor:
        """``tile_size`` windows of the full panel at ``origins``, each
        resized to ``img_size`` by :func:`resize_bicubic`, saturated and
        rounded as a uint8 resize is, on a zero canvas, centred: float32
        (T, S, S, 3)."""
        cfg = self.C
        ts, s, out = cfg.tile_size, cfg.canvas_size, cfg.img_size
        tiles = torch.stack([panel[y : y + ts, x : x + ts] for x, y in origins.tolist()])
        resized = torch.round(resize_bicubic(tiles, out, out).clamp(0.0, 255.0))
        canvases = torch.zeros((len(origins), s, s, 3), dtype=torch.float32, device=self.device)
        canvases[:, :out, :out] = resized
        return canvases - torch.from_numpy(IMAGENET_BGR_MEAN).to(self.device)

    def _canvas_for_window(self, w: int, h: int) -> tuple[int, int]:
        """Canvas bucket (H, W) of a ``w x h`` window under the shortest-side
        rule; square windows take the square canvas."""
        cfg = self.C
        cs = cfg.canvas_size
        if w == h or not cfg.infer_shortest_side:
            return (cs, cs)
        nw, nh = shortest_side_dims(w, h, cfg.img_size)
        mult_w = max(1, min(cfg.infer_canvas_max_mult, -(-nw // cs)))
        mult_h = max(1, min(cfg.infer_canvas_max_mult, -(-nh // cs)))
        return (cs * mult_h, cs * mult_w)

    def _tile_batches(self, img: np.ndarray, tiles: np.ndarray):
        """Host tile path: yield (images, valid_wh, scales, tiles, n) batches
        of the schedule, each window resized onto the square canvas."""
        cfg = self.C
        s = cfg.canvas_size
        for start, bs in self._batch_schedule(len(tiles)):
            chunk = tiles[start : start + bs]
            imgs = np.zeros((bs, s, s, 3), np.uint8)
            wh = np.full((bs, 2), float(s), np.float32)
            scales = np.ones((bs,), np.float64)
            for i, tile in enumerate(chunk):
                imgs[i], scales[i], vw, vh = resize_to_canvas(
                    img[tile[1] : tile[3], tile[0] : tile[2], :], cfg.img_size, s
                )
                wh[i] = (vw, vh)
            yield imgs, wh, scales, chunk, len(chunk)

    def _rect_window_batches(self, img: np.ndarray, tiles: np.ndarray, canvas_hw):
        """Shortest-side path: batches of up to ``infer_tile_batch`` windows
        on a ``canvas_hw`` bucket, padded only to a multiple of the mesh's
        data axis."""
        cfg = self.C
        for pos in range(0, len(tiles), self.tile_batch):
            chunk = tiles[pos : pos + self.tile_batch]
            n = len(chunk)
            bs = -(-n // self._dp) * self._dp
            imgs = np.zeros((bs,) + tuple(canvas_hw) + (3,), np.uint8)
            wh = np.full((bs, 2), float(cfg.img_size), np.float32)
            scales = np.ones((bs,), np.float64)
            for i, tile in enumerate(chunk):
                imgs[i], scales[i], vw, vh = resize_to_canvas_shortest(
                    img[tile[1] : tile[3], tile[0] : tile[2], :], cfg.img_size, canvas_hw
                )
                wh[i] = (vw, vh)
            yield imgs, wh, scales, chunk, n

    def _predict_host(self, imgs: np.ndarray, wh: np.ndarray, anchors=None):
        return self._predict_tiles_impl(
            torch.from_numpy(imgs).to(self.device), torch.from_numpy(wh).to(self.device), anchors
        )

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
        if prescale:
            self._dispatch_prescaled(img, tiles, pending)
        elif device_tiling:
            panel = self._panel_bucket_pad(torch.from_numpy(img).to(self.device), bucket=512)
            ratio = float(cfg.img_size) / ts
            for start, bs in self._batch_schedule(len(tiles)):
                chunk = tiles[start : start + bs]
                origins = np.zeros((bs, 2), np.int64)
                origins[: len(chunk)] = chunk[:, :2]
                images = self._full_res_canvases(panel, origins)
                valid_wh = torch.full((bs, 2), float(cfg.img_size), device=self.device)
                out = self._predict_tiles_impl(images, valid_wh)
                pending.append((out, np.full(bs, ratio), chunk, len(chunk)))
        elif cfg.infer_shortest_side and len(tiles) > 0 and not bool(
            ((tiles[:, 2] - tiles[:, 0]) == (tiles[:, 3] - tiles[:, 1])).all()
        ):
            # Non-square windows, grouped by canvas bucket.
            groups: dict[tuple[int, int], list[int]] = {}
            for i, t in enumerate(tiles):
                groups.setdefault(self._canvas_for_window(int(t[2] - t[0]), int(t[3] - t[1])), []).append(i)
            for canvas_hw, idx in groups.items():
                anchors = self._anchors_for_canvas(canvas_hw)
                for imgs, wh, scales, chunk, n in self._rect_window_batches(
                    img, tiles[np.asarray(idx)], canvas_hw
                ):
                    pending.append((self._predict_host(imgs, wh, anchors), scales, chunk, n))
        else:
            for imgs, wh, scales, chunk, n in self._tile_batches(img, tiles):
                pending.append((self._predict_host(imgs, wh), scales, chunk, n))

    def _dispatch_prescaled(self, img: np.ndarray, tiles: np.ndarray, pending: list) -> None:
        """The prescaled path: one downscale of the whole panel, then the
        ``img_size`` windows of each batch of the schedule."""
        cfg = self.C
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

    def predict_from_path(self, img_path: str) -> list[dict[str, Any]]:
        """Load the panel of every configured image type (or only the first,
        unless ``use_img_type``) and predict."""
        types = self.C.img_types
        if self.C.use_img_type:
            images = [get_image(img_path, [t]) for t in types]
        else:
            images = [get_image(img_path, types)]
        return self.predict(images)

    # ------------------------------------------------------------------ #
    # RPN-only debug path.
    # ------------------------------------------------------------------ #
    def predict_region_proposals(self, img: np.ndarray) -> list[dict[str, Any]]:
        """The RPN's proposals for every tile of ``img``, in panel pixels, as
        ``{'class': 'object', 'prob': 1.0, 'x1', 'y1', 'x2', 'y2'}`` dicts.
        Every tile takes the host path onto a 3-channel square canvas, as in
        the JAX package (never the grey stem), so the proposal NMS is the
        only kernel; each batch is fetched once."""
        cfg = self.C
        out: list[dict[str, Any]] = []
        tiles = plan_tiles(img.shape[1], img.shape[0], cfg.tile_size, cfg.tile_overlap)
        for imgs, wh, scales, chunk, n in self._tile_batches(img, tiles):
            boxes, valid = self._proposals_only(imgs, wh)
            for i in range(n):
                tile, ratio = chunk[i], scales[i]
                for b in boxes[i][valid[i]] * cfg.rpn_stride:  # feature map -> canvas px
                    rx1, ry1, rx2, ry2 = (int(v // ratio) for v in b)
                    out.append({"class": "object", "prob": 1.0,
                                "x1": tile[0] + rx1, "y1": tile[1] + ry1,
                                "x2": tile[0] + rx2, "y2": tile[1] + ry2})
        return out

    @torch.inference_mode()
    def _proposals_only(self, imgs: np.ndarray, wh: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Host canvases -> the proposals' (boxes, valid), fetched (on a
        mesh, this rank's tiles, gathered over the data axis)."""
        images = self._data_slice(torch.from_numpy(imgs).to(self.device))
        valid_wh = self._data_slice(torch.from_numpy(wh).to(self.device))
        props = self._proposals(self._features(images), valid_wh)
        boxes, valid = self._data_gather((props.boxes, props.valid))
        return boxes.cpu().numpy(), valid.cpu().numpy()


def save_radnet(model_dir: str, config: Config, model: FasterRCNN) -> None:
    """Write ``config.json`` and the model's float32 state_dict."""
    os.makedirs(model_dir, exist_ok=True)
    config.save(os.path.join(model_dir, "config.json"))
    save_weights(model_dir, model)


def save_weights(model_dir: str, model: FasterRCNN) -> str:
    """Write the model's float32 state_dict as ``<model_dir>/model.pt``."""
    path = os.path.join(model_dir, WEIGHTS_FILE)
    torch.save({k: v.detach().float().cpu() for k, v in model.state_dict().items()}, path)
    return path


def load_radnet(model_dir: str, device="cuda", quantize: str | None = None,
                mesh: Mesh | None = None) -> RADNet:
    """Build a RADNet from a model directory written by :func:`save_radnet`.
    ``quantize``: serving-time override of ``config.infer_quantize`` ("int8"
    runs the RoI head in int8, ``""`` clears a saved value, None keeps it);
    the weights are the same either way.  ``mesh``: this rank's mesh (see
    :class:`RADNet`)."""
    device = resolve_device(device if mesh is None else mesh.device)
    config = Config.load(os.path.join(model_dir, "config.json"))
    if quantize is not None:
        config.infer_quantize = quantize or None
    path = os.path.join(model_dir, WEIGHTS_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: no torch weights; convert a JAX model directory with "
            f"scripts/export_jax_model.py on a host with the JAX package"
        )
    model = build_model(config)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return RADNet(config, model, device=device, mesh=mesh)
