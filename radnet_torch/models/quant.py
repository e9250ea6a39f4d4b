"""Int8 layers of the RoI head: ``radnet_tpu/models/quant.py``'s ``QuantConv``
and ``QuantDense``.

Each has the parameters of the float layer it stands for (:class:`Conv`,
:class:`Dense`: same names, shapes and types), so a
float checkpoint loads into it and the weight bridge needs no case of its
own.  ``forward`` is the float layer's, which training runs; :meth:`int8`
is the quantized product the head runs at inference and in the eval step:
weights quantized on each call (one scale an output channel), activations
one scale a sample, int32 sums, and a float32 result with the bias added
(``ops/quant.py``).  It also takes what follows the layer into the
product's epilogue: a frozen batch norm's ``(k, b)`` in the model's type
(the result is then in that type), a residual to add after it, and a ReLU.
"""

from __future__ import annotations

import torch

from radnet_torch.models.layers import Conv, Dense
from radnet_torch.ops.quant import BatchNorm, Quantized, int8_conv, int8_dense


class QuantConv(Conv):
    """:class:`Conv` with an int8 path over NHWC activations."""

    def int8(self, x: torch.Tensor | Quantized, *, bn: BatchNorm | None = None,
             residual: torch.Tensor | None = None, relu: bool = False) -> torch.Tensor:
        """``x`` (N, H, W, C), float or already quantized one scale a sample
        -> (N, H', W', O): float32, or with ``bn`` the batch norm applied in
        its type, then ``+ residual`` (N, H', W', O), then ReLU."""
        return int8_conv(x, self.weight, self.bias, padding=self.padding, stride=self.stride,
                         bn=bn, residual=residual, relu=relu)


class QuantDense(Dense):
    """:class:`Dense` with an int8 path."""

    def int8(self, x: torch.Tensor, *, relu: bool = False) -> torch.Tensor:
        """``x`` (N, D) float -> float32 (N, O), ReLU'd if ``relu``."""
        return int8_dense(x, self.weight, self.bias, relu=relu)
