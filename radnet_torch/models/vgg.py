"""VGG16 trunk (blocks 1-5, through ``block5_conv3``) and its dense RoI head.

:class:`VGG16Trunk`: 13 3x3 SAME convs with ReLU in five blocks, a VALID
2x2/2 max-pool after each of the first four; stride 16, 512 channels.
:class:`VGG16RoIHead`: the 7x7 pool flattened in (row, column, channel)
order, as the JAX package flattens its NHWC pool, then two 4096-wide dense
layers with ReLU and dropout 0.5, then the float32 softmax class head and
the per-class box regression.

Dropout is an input here: ``masks`` is a pair of bool ``(N, fc_dim)``
tensors (True keeps), drawn by the train step, and a kept value is scaled
by 1/0.5 as flax's ``Dropout`` does.  Without masks the head is
deterministic (inference, validation).

The convs and ``fc1``/``fc2`` compute in the model's type (bf16 on the
card) with float32 parameters; the output layers run in float32.  A head
built with ``quantize`` can also run ``fc1``/``fc2`` in int8
(``models/quant.py``), deterministic only: both then give float32, as the
JAX package's ``QuantDense`` does, with the ReLU in the product's epilogue.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from radnet_torch.models.layers import Conv, Dense
from radnet_torch.models.quant import QuantDense

FEATURE_CHANNELS = 512
POOL_SIZE = 7
KEEP_PROB = 0.5  # 1 - the dropout rate

# (block, convs, features, max-pool after): Keras VGG16 up to block5_conv3.
PLAN = ((1, 2, 64, True), (2, 2, 128, True), (3, 3, 256, True), (4, 3, 512, True),
        (5, 3, 512, False))


class VGG16Trunk(nn.Module):
    """``(B, S, S, 3)`` centred image -> ``(B, 512, S / 16, S / 16)`` in
    channels-last memory format."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = []  # (conv name, pool after it)
        cin = 3
        for block, n_convs, feats, pool in PLAN:
            for i in range(1, n_convs + 1):
                name = f"block{block}_conv{i}"
                self.add_module(name, Conv(cin, feats, 3, padding=1, dtype=dtype))
                self.layers.append((name, pool and i == n_convs))
                cin = feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view with channels-last strides
        for name, pool in self.layers:
            x = F.relu(getattr(self, name)(x))
            if pool:
                x = F.max_pool2d(x, 2, stride=2)
        return x


def dropout(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Kept values scaled by 1 / KEEP_PROB, the rest zero; identity without
    a mask."""
    if mask is None:
        return x
    return torch.where(mask, x / KEEP_PROB, torch.zeros((), dtype=x.dtype, device=x.device))


class VGG16RoIHead(nn.Module):
    """``(N, 7, 7, 512)`` pooled RoIs (NHWC) -> (class probs ``(N,
    n_classes)`` float32, box deltas ``(N, 4 * (n_classes - 1))`` float32)."""

    def __init__(self, n_classes: int, dtype: torch.dtype = torch.float32, fc_dim: int = 4096,
                 quantize: bool = False):
        super().__init__()
        self.dtype = dtype
        self.fc_dim = fc_dim
        self.quantize = quantize
        dense = QuantDense if quantize else Dense
        self.fc1 = dense(POOL_SIZE * POOL_SIZE * FEATURE_CHANNELS, fc_dim, dtype=dtype)
        self.fc2 = dense(fc_dim, fc_dim, dtype=dtype)
        self.dense_class = nn.Linear(fc_dim, n_classes)
        self.dense_regress = nn.Linear(fc_dim, 4 * (n_classes - 1))

    def forward(self, rois: torch.Tensor, masks=None,
                quantize: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """``quantize``: ``fc1``/``fc2`` in int8 (a head built with
        ``quantize``, no dropout masks)."""
        x = rois.reshape(rois.shape[0], -1)  # (row, column, channel) order
        if quantize:
            if not self.quantize or masks is not None:
                raise ValueError("the int8 head needs a head built with quantize and no dropout")
            x = self.fc1.int8(x.to(self.dtype), relu=True)
            x = self.fc2.int8(x, relu=True)
        else:
            m1, m2 = masks if masks is not None else (None, None)
            x = dropout(F.relu(self.fc1(x)), m1)
            x = dropout(F.relu(self.fc2(x)), m2)
        x = x.float()
        cls = torch.softmax(self.dense_class(x), dim=-1)
        regr = self.dense_regress(x)
        return cls, regr
