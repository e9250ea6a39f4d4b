"""The two-stage detector as one module with three entry points.

* :meth:`FasterRCNN.features`  - the shared trunk;
* :meth:`FasterRCNN.features_grey` - the trunk on grey canvases, through
  the fused grey stem (``ops/grey_stem.py``);
* :meth:`FasterRCNN.rpn`       - the RPN heads on a feature map;
* :meth:`FasterRCNN.roi_heads` - RoI pooling + the RoI head.

Two backbones: ResNet50 (stages 1-4, then the stage-5 head over 7x7 pools
on the even centres of a 14x14 grid) and VGG16 (blocks 1-5, then the dense
head over 7x7 pools at stride 1).  Layouts at these entry points follow the
JAX package: images ``(B, S, S, 3)``, RoIs ``(B, R, 4)`` xywh in feature
units, RPN outputs ``(B, H, W, A)``.  The feature map itself is NCHW in
channels-last memory format.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from radnet_torch.config import Config
from radnet_torch.models import resnet, vgg
from radnet_torch.models.layers import Conv
from radnet_torch.models.rpn import RPNHead
from radnet_torch.ops.grey_stem import grey_stem
from radnet_torch.ops.roi_align import batched_roi_pool


class FasterRCNN(nn.Module):
    def __init__(self, network: str, n_classes: int, num_anchors: int,
                 dtype: torch.dtype = torch.bfloat16, vgg_fc_dim: int = 4096,
                 head_quant: str | None = None):
        super().__init__()
        if head_quant not in (None, "int8"):
            raise ValueError(f"infer_quantize must be None or 'int8', not {head_quant!r}")
        self.network = network
        self.dtype = dtype
        # "int8": the RoI head runs quantized where roi_heads is asked to
        # (inference, the eval step); training always runs it float.
        self.head_quant = head_quant
        quant = head_quant == "int8"
        if network == "vgg16":
            self.trunk = vgg.VGG16Trunk(dtype=dtype)
            self.head = vgg.VGG16RoIHead(n_classes, dtype=dtype, fc_dim=vgg_fc_dim, quantize=quant)
            self.pool_size = vgg.POOL_SIZE
            self.pool_center_stride = 1
            channels = vgg.FEATURE_CHANNELS
        elif network == "resnet50":
            self.trunk = resnet.ResNet50Trunk(dtype=dtype)
            # 7x7 pool on the even centres of the 14x14 grid, feeding the
            # pre-strided head.
            self.head = resnet.ResNet50RoIHead(n_classes, dtype=dtype, quantize=quant)
            self.pool_size = resnet.POOL_SIZE // 2
            self.pool_center_stride = 2
            channels = resnet.FEATURE_CHANNELS
        else:
            raise ValueError(f"unknown network {network!r}")
        self.rpn_head = RPNHead(channels, num_anchors, dtype=dtype)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) centred images -> (B, C, h, w) channels-last features."""
        return self.trunk(images)

    def features_grey(self, grey: torch.Tensor, consts) -> torch.Tensor:
        """uint8 ``(B, S, S)`` grey canvases, not centred -> features, through
        the fused grey stem (ResNet50 only).

        ``consts``: the :class:`~radnet_torch.ops.grey_stem.StemConsts` of
        this canvas and of ``self.dtype``
        (:func:`~radnet_torch.ops.grey_stem.make_stem_consts`)."""
        pooled = grey_stem(grey, consts, out_dtype=self.dtype)
        return self.trunk.stages(pooled.permute(0, 3, 1, 2))  # channels-last NCHW view

    def rpn(self, fmap: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Feature map -> (objectness (B, h, w, A), deltas (B, h, w, 4A))."""
        return self.rpn_head(fmap)

    def roi_heads(self, fmap: torch.Tensor, rois_xywh: torch.Tensor, masks=None, *,
                  quantize: bool = False, head=None):
        """Pool + classify RoIs: (class probs (B, R, n_classes), box deltas
        (B, R, 4 * (n_classes - 1))).  ``masks``: the VGG16 head's two
        dropout masks, bool ``(B * R, fc_dim)``; None runs it deterministic
        (the ResNet50 head has no dropout).  ``quantize``: the caller runs
        deterministic (inference, the eval step), so a model built with
        ``head_quant="int8"`` runs its head in int8; the train step passes
        False.  The head takes the NHWC pool.  ``head``: another head to
        run in ``self.head``'s place (a tensor-parallel one, from
        ``radnet_torch/parallel/tp.py``)."""
        b, r = rois_xywh.shape[:2]
        fmap_nhwc = fmap.permute(0, 2, 3, 1).contiguous()
        pooled = batched_roi_pool(
            fmap_nhwc, rois_xywh.float().contiguous(),
            pool_size=self.pool_size, center_stride=self.pool_center_stride,
        )
        pooled = pooled.reshape((b * r,) + pooled.shape[2:])
        int8 = quantize and self.head_quant == "int8"
        head = self.head if head is None else head
        if self.network == "vgg16":
            cls, regr = head(pooled, masks, quantize=int8)
        else:
            cls, regr = head(pooled, quantize=int8)
        return cls.reshape(b, r, -1), regr.reshape(b, r, -1)


def build_model(config: Config) -> FasterRCNN:
    return FasterRCNN(
        network=config.network,
        n_classes=config.n_classes,
        num_anchors=config.n_anchors,
        dtype=getattr(torch, config.compute_dtype),
        vgg_fc_dim=config.vgg_fc_dim,
        head_quant=config.infer_quantize or None,
    )


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Truncated normal with variance 1/fan_in (the JAX package's conv init)."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_weights(model: FasterRCNN, generator: torch.Generator) -> FasterRCNN:
    """Seeded init in the JAX package's manner: lecun-normal convs and VGG16
    ``fc1``/``fc2`` with zero bias, frozen BN at identity, RPN conv N(0,
    0.05), objectness U(-0.05, 0.05), zero regression and output layers."""
    for name, m in model.named_modules():
        if isinstance(m, vgg.Dense):
            m.bias.zero_()
            _lecun_normal_(m.weight, generator)
        elif isinstance(m, Conv):
            m.bias.zero_()
            if name.endswith("rpn_conv1"):
                m.weight.normal_(0.0, 0.05, generator=generator)
            elif name.endswith("rpn_out_class"):
                m.weight.uniform_(-0.05, 0.05, generator=generator)
            elif name.endswith("rpn_out_regress"):
                m.weight.zero_()
            else:
                _lecun_normal_(m.weight, generator)
        elif isinstance(m, nn.Linear):
            m.weight.zero_()
            m.bias.zero_()
    return model
