"""Region Proposal Network head.

A 3x3/512 'same' ReLU conv on the shared feature map in the compute type,
then two 1x1 heads in float32: sigmoid objectness over ``num_anchors``
channels and linear box regression over ``4 * num_anchors`` channels.
Outputs are channels-last ``(B, H, W, A)`` and ``(B, H, W, 4A)``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from radnet_torch.models.layers import Conv


class RPNHead(nn.Module):
    def __init__(self, cin: int, num_anchors: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rpn_conv1 = Conv(cin, 512, 3, padding=1, dtype=dtype)
        self.rpn_out_class = Conv(512, num_anchors, 1, dtype=torch.float32)
        self.rpn_out_regress = Conv(512, 4 * num_anchors, 1, dtype=torch.float32)

    def forward(self, fmap: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.rpn_conv1(fmap)).float()
        cls = torch.sigmoid(self.rpn_out_class(x))
        regr = self.rpn_out_regress(x)
        return cls.permute(0, 2, 3, 1), regr.permute(0, 2, 3, 1)
