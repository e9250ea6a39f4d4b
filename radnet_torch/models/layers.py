"""Shared layers: the frozen batch norm, and a conv and a dense layer that
compute in a set type.

Activations are NCHW tensors, in ``torch.channels_last`` memory format on
the trunk.  Parameters are float32; a layer casts them to its compute type
when it runs, as the JAX package does.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class FrozenBatchNorm(nn.Module):
    """Batch norm with stored statistics only: ``x * k + b`` with ``k =
    gamma / sqrt(var + eps)``, computed in the input's type.  The four
    tensors are buffers, never trained."""

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.register_buffer("gamma", torch.ones(features))
        self.register_buffer("beta", torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, b = self.affine(x.dtype)
        return x * k[:, None, None] + b[:, None, None]

    def nhwc(self, x: torch.Tensor) -> torch.Tensor:
        """The same on channels-last ``(..., C)`` values."""
        k, b = self.affine(x.dtype)
        return x * k + b

    def affine(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """``(k, b)`` in ``dtype``."""
        k = self.gamma / torch.sqrt(self.var + self.eps)
        b = self.beta - self.mean * k
        return k.to(dtype), b.to(dtype)


class Conv(nn.Module):
    """2-D convolution in ``dtype``: the conv, then the bias added in
    ``dtype``.  ``padding`` is an int (VALID is 0, 3x3 SAME is 1)."""

    def __init__(self, cin: int, cout: int, ksize: int, stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, ksize, ksize))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride = stride
        self.padding = padding
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)
        return y + self.bias.to(dt)[:, None, None]


class Dense(nn.Module):
    """``x @ W^T`` in ``dtype``, then the bias added in ``dtype`` (flax's
    ``Dense`` with float32 parameters and a compute type)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)
