"""Input preprocessing and the host-side canvas construction of the inference path.

Keras 'caffe' convention: BGR images minus the ImageNet BGR means.  Tiles
ship as uint8 canvases and are centred on the device, over the whole
canvas including its zero padding, before the trunk's own zero padding.

The host tile path resizes a window (longest side, or for non-square
windows shortest side, to ``img_size``) onto a zero canvas with the port's
OpenCV-``INTER_CUBIC`` bicubic (``ops/resize.py::resize_cubic_u8``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from radnet_torch.ops.resize import resize_cubic_u8

IMAGENET_BGR_MEAN = np.array([103.939, 116.779, 123.68], dtype=np.float32)


def preprocess_image(img_bgr: np.ndarray) -> np.ndarray:
    """BGR uint8 -> float32, ImageNet-mean-centred, on the host."""
    return img_bgr.astype(np.float32) - IMAGENET_BGR_MEAN


def preprocess_on_device(images: torch.Tensor) -> torch.Tensor:
    """uint8 ``(B, H, W, 3)`` BGR canvases -> mean-centred float32; float
    canvases are taken as already centred."""
    if images.dtype != torch.uint8:
        return images.float()
    return images.float() - _mean_on(images.device)


@functools.lru_cache(maxsize=8)
def _mean_on(device: torch.device) -> torch.Tensor:
    """The BGR means, uploaded once per device (an upload waits for the card)."""
    return torch.from_numpy(IMAGENET_BGR_MEAN).to(device)


def _resize(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    return resize_cubic_u8(torch.from_numpy(np.ascontiguousarray(img)), new_w, new_h).numpy()


def longest_side_dims(w: int, h: int, img_size: int) -> tuple[int, int]:
    """Longest side to ``img_size``, aspect kept, at least 1 px."""
    scale = float(img_size) / max(h, w)
    return max(1, int(round(w * scale))), max(1, int(round(h * scale)))


def resize_to_canvas(img: np.ndarray, img_size: int,
                     canvas_size: int) -> tuple[np.ndarray, float, int, int]:
    """Resize the longest side to ``img_size``, then zero-pad bottom and
    right to ``canvas_size``: (canvas, scale, valid_w, valid_h)."""
    h, w = img.shape[:2]
    scale = float(img_size) / max(h, w)
    new_w, new_h = longest_side_dims(w, h, img_size)
    # A 1:1 bicubic lands exactly on the source pixels.
    resized = img if (new_w, new_h) == (w, h) else _resize(img, new_w, new_h)
    canvas = np.zeros((canvas_size, canvas_size, 3), dtype=resized.dtype)
    canvas[:new_h, :new_w] = resized
    return canvas, scale, new_w, new_h


def shortest_side_dims(w: int, h: int, img_size: int) -> tuple[int, int]:
    """Shortest side to ``img_size``, the other scaled by the same factor and
    truncated to an int."""
    if w <= h:
        f = float(img_size) / w
        return img_size, int(f * h)
    f = float(img_size) / h
    return int(f * w), img_size


def resize_to_canvas_shortest(img: np.ndarray, img_size: int,
                              canvas_hw: tuple[int, int]) -> tuple[np.ndarray, float, int, int]:
    """Shortest side to ``img_size`` onto a ``canvas_hw`` bucket, zero-padded
    bottom and right: (canvas, scale, valid_w, valid_h) with one uniform
    scale.  Resized dims beyond the bucket shrink the short side by the fit
    factor and derive the long side from the one scale returned."""
    h, w = img.shape[:2]
    new_w, new_h = shortest_side_dims(w, h, img_size)
    ch, cw = canvas_hw
    scale = float(img_size) / min(h, w)
    if new_w > cw or new_h > ch:
        g = min(cw / new_w, ch / new_h)
        if w <= h:
            new_w = max(1, int(new_w * g))
            scale = new_w / w
            new_h = min(ch, max(1, int(h * scale)))
        else:
            new_h = max(1, int(new_h * g))
            scale = new_h / h
            new_w = min(cw, max(1, int(w * scale)))
    resized = img if (new_w, new_h) == (w, h) else _resize(img, new_w, new_h)
    canvas = np.zeros((ch, cw, 3), dtype=resized.dtype)
    canvas[:new_h, :new_w] = resized
    return canvas, scale, new_w, new_h
