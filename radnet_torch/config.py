"""Configuration of the RADNet detector, as the PyTorch port reads it.

A field-for-field copy of the JAX package's ``Config`` so that a model
directory's ``config.json`` loads unchanged in either package.  Two fields
are kept only so the JSON round-trips, and read as nothing:
``infer_host_s2d``, a TPU layout choice (the port's host tiles always ship
3-channel canvases), and ``verbose``, which neither package reads.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import torch


@dataclasses.dataclass
class Config:
    # Model / backbone
    verbose: bool = True
    network: str = "resnet50"  # 'vgg16' or 'resnet50'
    base_net_trainable: bool = False
    base_net_cont_trainable: bool = True
    base_net_weights: str | None = "imagenet"

    # Augmentation switches (training)
    use_horizontal_flips: bool = True
    use_vertical_flips: bool = True
    use_90_rotations: bool = True
    use_rotations: bool = True
    use_shear: bool = True
    use_brightness: bool = True
    use_noise: bool = True
    augment_photometric_on_device: bool = True
    augment_at_canvas_scale: bool = True
    prescaled_tile_cache_mb: int = 256

    # Image types
    use_img_type: bool = False
    img_types: list[str] = dataclasses.field(
        default_factory=lambda: ["enhanced_topo_grey", "topo_grey"]
    )

    # Tiling
    tile_size: int = 2000
    tile_overlap: int = 400  # step between tile origins
    tile_bbox_clip_threshold: float = 0.75
    max_n_tiles_train: int = 1
    max_n_tiles_val: int = 1
    include_full_img: bool = False

    # Anchors
    anchor_box_scales: list[int] = dataclasses.field(
        default_factory=lambda: [64, 128, 256, 512]
    )
    anchor_box_ratios: list[list[float]] = dataclasses.field(
        default_factory=lambda: [[1.0, 1.0], [1.0, 2.0], [2.0, 1.0]]
    )

    # Input geometry
    img_size: int = 600  # longest side of a resized tile
    n_rois: int = 20
    rpn_stride: int = 16

    # Class balancing / regression scaling
    balanced_classes: bool = True
    std_scaling: float = 4.0
    classifier_regr_std: list[float] = dataclasses.field(
        default_factory=lambda: [8.0, 8.0, 4.0, 4.0]
    )
    rpn_min_overlap: float = 0.3
    rpn_max_overlap: float = 0.7
    classifier_min_overlap: float = 0.1
    classifier_max_overlap: float = 0.5

    # Classes; 'bg' maps to the last id.
    class_mapping: dict[str, int] = dataclasses.field(
        default_factory=lambda: {
            "boat": 0,
            "human": 1,
            "other": 2,
            "animal": 3,
            "circle": 4,
            "wheel": 5,
            "bg": 6,
        }
    )

    # Fixed shapes: tiles are resized (longest side -> img_size) and
    # zero-padded onto a square canvas of canvas_size.
    canvas_size: int = 608  # 608 -> 38x38 feature map
    batch_size: int = 8
    train_bundle_steps: int = 4
    train_schedule: str = "joint"
    max_gt_boxes: int = 64
    rpn_max_regions: int = 256
    rpn_reference_neg_budget: bool = False
    rpn_fallback_min_iou: float = 0.0
    pre_nms_top_n: int = 2048  # proposals entering NMS, score top-k
    post_nms_top_n: int = 300  # proposals out of NMS
    rpn_nms_thresh: float = 0.7
    detection_nms_thresh: float = 0.2  # per-class per-tile NMS
    cross_type_nms_thresh: float = 0.4  # cross-image-type merge
    bbox_threshold: float = 0.7  # detector score cut
    max_detections_per_tile: int = 64  # per-class post-NMS budget per tile
    # RoI head on only the top-K surviving proposals per tile (None: all).
    max_head_rois: int | None = None
    infer_tile_batch: int = 12  # tiles per cascade call
    # Remainder tiles go through a half-size batch when they fit.
    infer_tail_subbatch: bool = True
    infer_device_tiling: bool = True
    # Downscale the panel once by img_size/tile_size and slice windows.
    infer_panel_prescale: bool = True
    infer_shortest_side: bool = True
    infer_canvas_max_mult: int = 4
    # Kept so JAX-written config.json files load; the port's host tiles
    # always ship 3-channel canvases (a TPU layout choice, not a function).
    infer_host_s2d: bool = True
    compute_dtype: str = "bfloat16"
    infer_quantize: str | None = None
    vgg_fc_dim: int = 4096

    model_path: str = ""
    weights_path: str = ""

    def __post_init__(self) -> None:
        if not self.model_path:
            self.model_path = "faster_rcnn_" + self.network

    # Derived quantities
    @property
    def n_anchors(self) -> int:
        return len(self.anchor_box_scales) * len(self.anchor_box_ratios)

    @property
    def n_classes(self) -> int:
        """Number of classes including background."""
        return len(self.class_mapping)

    @property
    def bg_class_id(self) -> int:
        return self.class_mapping["bg"]

    @property
    def inv_class_mapping(self) -> dict[int, str]:
        return {v: k for k, v in self.class_mapping.items()}

    @property
    def feat_size(self) -> int:
        """Feature-map side length for the square canvas."""
        return backbone_feat_size(self.network, self.canvas_size)

    # Persistence
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=4)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def vgg_feat_dim(length: int) -> int:
    """VGG16 stride-16 output length."""
    return length // 16


def resnet_feat_dim(length: int) -> int:
    """ResNet50 output length: zero-pad +6, then four strided layers."""
    length += 6
    for filter_size in (7, 3, 1, 1):
        length = (length - filter_size + 2) // 2
    return length


def backbone_feat_size(network: str, length: int) -> int:
    if network == "vgg16":
        return vgg_feat_dim(length)
    if network == "resnet50":
        return resnet_feat_dim(length)
    raise ValueError(f"unknown network {network!r}")


def feature_extent(length: torch.Tensor, network: str) -> torch.Tensor:
    """Feature-map extent of a (per-tile) valid image extent, int32."""
    v = length.to(torch.int32)
    if network == "vgg16":
        return torch.div(v, 16, rounding_mode="floor")
    v = v + 6
    for f in (7, 3, 1, 1):
        v = torch.div(v - f + 2, 2, rounding_mode="floor")
    return v
