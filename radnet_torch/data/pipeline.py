"""Input preprocessing of the inference path.

Keras 'caffe' convention: BGR images minus the ImageNet BGR means.  Tiles
ship as uint8 canvases and are centred on the device, over the whole
canvas including its zero padding, before the trunk's own zero padding.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_BGR_MEAN = np.array([103.939, 116.779, 123.68], dtype=np.float32)


def preprocess_on_device(images: torch.Tensor) -> torch.Tensor:
    """uint8 ``(B, H, W, 3)`` BGR canvases -> mean-centred float32."""
    mean = torch.from_numpy(IMAGENET_BGR_MEAN).to(images.device)
    return images.float() - mean
