"""ResNet50 trunk (stages 1-4) and the per-RoI stage-5 head.

:class:`ResNet50Trunk`: zero-pad 3, 7x7/2 conv, frozen BN, ReLU, 3x3/2
max-pool, then the bottleneck stages 2-4; stride 16, 1024 channels.
:class:`ResNet50RoIHead`: stage 5 over pooled RoIs, 7x7 average pool, then
the float32 softmax class head and the per-class box regression.  The RoI
pool already sampled the even positions of the 14x14 grid, so s5a's
stride-2 1x1 convs run at stride 1 on a 7x7 input.

Convs compute in the model's type (bf16 on the card) with float32
parameters; convolutions themselves are cuDNN's.  A head built with
``quantize`` can also run every stage-5 conv in int8 (``models/quant.py``),
deterministic only, on the NHWC pool: each int8 conv's float32 result is
cast to the model's type before its batch norm, as the JAX package's
``FrozenBatchNorm`` casts, inside the product's epilogue.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from radnet_torch.models.layers import Conv, FrozenBatchNorm
from radnet_torch.models.quant import QuantConv
from radnet_torch.ops import quant

FEATURE_CHANNELS = 1024
POOL_SIZE = 14


class Bottleneck(nn.Module):
    """Bottleneck residual block, with a projection shortcut if ``project``."""

    def __init__(self, cin: int, filters: tuple[int, int, int], stride: int = 1,
                 project: bool = False, dtype: torch.dtype = torch.float32,
                 quantize: bool = False):
        super().__init__()
        f1, f2, f3 = filters
        conv = QuantConv if quantize else Conv
        self.conv2a = conv(cin, f1, 1, stride=stride, dtype=dtype)
        self.bn2a = FrozenBatchNorm(f1)
        self.conv2b = conv(f1, f2, 3, padding=1, dtype=dtype)
        self.bn2b = FrozenBatchNorm(f2)
        self.conv2c = conv(f2, f3, 1, dtype=dtype)
        self.bn2c = FrozenBatchNorm(f3)
        self.project = project
        if project:
            self.conv_sc = conv(cin, f3, 1, stride=stride, dtype=dtype)
            self.bn_sc = FrozenBatchNorm(f3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn2a(self.conv2a(x)))
        y = F.relu(self.bn2b(self.conv2b(y)))
        y = self.bn2c(self.conv2c(y))
        sc = self.bn_sc(self.conv_sc(x)) if self.project else x
        return F.relu(y + sc)

    def int8(self, x: torch.Tensor) -> torch.Tensor:
        """The block with int8 convs on NHWC ``x`` in the model's type.  Each
        conv's product runs its batch norm, and the ReLU or the residual sum
        and ReLU after it, in its epilogue, in that type (as the eager ops
        round), so each conv writes the block's next tensor once.  ``x`` is
        quantized once for ``conv2a`` and the projection, which read the
        same values; ``conv2c`` adds the shortcut."""
        dt = x.dtype
        xq = quant.quantize_rows(x)
        y = self.conv2a.int8(xq, bn=self.bn2a.affine(dt), relu=True)
        sc = self.conv_sc.int8(xq, bn=self.bn_sc.affine(dt)) if self.project else x
        y = self.conv2b.int8(y, bn=self.bn2b.affine(dt), relu=True)
        return self.conv2c.int8(y, bn=self.bn2c.affine(dt), residual=sc, relu=True)


def _stage(cin, filters, n_blocks, stride, prefix, dtype):
    blocks = [(f"{prefix}a", Bottleneck(cin, filters, stride, project=True, dtype=dtype))]
    for i in range(1, n_blocks):
        blocks.append((f"{prefix}{'abcdef'[i]}", Bottleneck(filters[2], filters, dtype=dtype)))
    return blocks


class ResNet50Trunk(nn.Module):
    """Stages 1-4: ``(B, S, S, 3)`` centred image -> ``(B, 1024, S', S')``
    in channels-last memory format.  :meth:`stem` and :meth:`stages` split
    it, so a stem computed elsewhere (the grey stem) feeds stage 2."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(3, 64, 7, stride=2, dtype=dtype)
        self.bn_conv1 = FrozenBatchNorm(64)
        blocks = (
            _stage(64, (64, 64, 256), 3, 1, "s2", dtype)
            + _stage(256, (128, 128, 512), 4, 2, "s3", dtype)
            + _stage(512, (256, 256, 1024), 6, 2, "s4", dtype)
        )
        for name, blk in blocks:
            self.add_module(name, blk)
        self.block_names = [name for name, _ in blocks]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stages(self.stem(x))

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """7x7/2 conv, frozen BN, ReLU and 3x3/2 max-pool: ``(B, 64, S', S')``
        channels-last.

        ``x`` is the centred NHWC image, not yet padded: padding after the
        centring keeps the pad ring at true zero."""
        x = F.pad(x.to(self.dtype), (0, 0, 3, 3, 3, 3))  # ZeroPadding2D((3, 3))
        x = self.conv1(x.permute(0, 3, 1, 2))  # NCHW view with channels-last strides
        x = F.relu(self.bn_conv1(x))
        return F.max_pool2d(x, 3, stride=2)

    def stages(self, x: torch.Tensor) -> torch.Tensor:
        """Stages 2-4 on a pooled stem output ``(B, 64, S', S')``."""
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


class ResNet50RoIHead(nn.Module):
    """Stage 5 over pooled RoIs: ``(N, 7, 7, 1024)`` -> (class probs ``(N,
    n_classes)`` float32, box deltas ``(N, 4 * (n_classes - 1))`` float32).

    Pre-strided: the RoI pool samples the even positions of the 14x14 grid,
    so s5a's 1x1 entry convs run at stride 1."""

    def __init__(self, n_classes: int, dtype: torch.dtype = torch.float32,
                 quantize: bool = False):
        super().__init__()
        self.dtype = dtype
        self.quantize = quantize
        kw = {"dtype": dtype, "quantize": quantize}
        self.s5a = Bottleneck(FEATURE_CHANNELS, (512, 512, 2048), project=True, **kw)
        self.s5b = Bottleneck(2048, (512, 512, 2048), **kw)
        self.s5c = Bottleneck(2048, (512, 512, 2048), **kw)
        self.dense_class = nn.Linear(2048, n_classes)
        self.dense_regress = nn.Linear(2048, 4 * (n_classes - 1))

    def forward(self, rois: torch.Tensor, quantize: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """``rois``: the NHWC pool ``(N, 7, 7, 1024)``.  ``quantize``: the
        stage-5 convs in int8 (a head built with ``quantize``)."""
        x = rois.to(self.dtype)
        if quantize:
            if not self.quantize:
                raise ValueError("the int8 head needs a head built with quantize")
            x = self.s5c.int8(self.s5b.int8(self.s5a.int8(x.contiguous()))).permute(0, 3, 1, 2)
        else:  # an NCHW view of channels-last memory, as the int8 result
            x = self.s5c(self.s5b(self.s5a(x.permute(0, 3, 1, 2))))
        x = F.avg_pool2d(x, 7, stride=7).flatten(1).float()
        cls = torch.softmax(self.dense_class(x), dim=-1)
        regr = self.dense_regress(x)
        return cls, regr
