"""Input preprocessing, the host-side canvases, and the training data path.

Keras 'caffe' convention: BGR images minus the ImageNet BGR means.  Tiles
ship as uint8 canvases and are centred on the device, over the whole
canvas including its zero padding, before the trunk's own zero padding.

The host tile path resizes a window (longest side, or for non-square
windows shortest side, to ``img_size``) onto a zero canvas with the port's
OpenCV-``INTER_CUBIC`` bicubic (``ops/resize.py::resize_cubic_u8``).

Training: :func:`tile_sample_generator` picks tiles of the annotated panels
(class-balanced, boxes clipped to the tile), prescales each to canvas scale
through a byte-bounded cache, augments it on the host (``data/augment.py``)
and yields fixed-shape samples; :func:`parallel_sample_generator` runs it on
worker threads, :func:`batched` stacks samples, and
:func:`prefetch_to_device` pins the batches on a thread and uploads them,
non-blocking, on the consumer's stream.
"""

from __future__ import annotations

import functools
import os
import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from radnet_torch.data import augment as aug
from radnet_torch.data.dataset import SampleSelector, choose_img_type, get_image
from radnet_torch.data.tiling import clip_boxes_to_tile, plan_tiles
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
    src = torch.from_numpy(np.require(img, requirements=["C", "W"]))  # cached panels are read-only
    return resize_cubic_u8(src, new_w, new_h).numpy()


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


# --------------------------------------------------------------------------- #
# Training samples.
# --------------------------------------------------------------------------- #
def prescale_for_augment(img: np.ndarray, meta: dict[str, Any], config) -> tuple[np.ndarray, dict]:
    """Resize ``img`` (longest side to ``img_size``) and scale its boxes, so
    the geometric augmentation runs at canvas scale; no-op when the image is
    already at or below that size."""
    h, w = img.shape[:2]
    if max(h, w) <= config.img_size:
        return img, meta
    new_w, new_h = longest_side_dims(w, h, config.img_size)
    return _resize(img, new_w, new_h), scale_meta_boxes(meta, w, h, new_w, new_h)


def scale_meta_boxes(meta: dict[str, Any], w: int, h: int, new_w: int, new_h: int) -> dict:
    """Scale ``meta``'s boxes from (w, h) to (new_w, new_h), as floats;
    boxes left empty are dropped."""
    sx, sy = new_w / float(w), new_h / float(h)
    boxes = []
    for b in meta["bboxes"]:
        nb = dict(b)
        nb["x1"] = b["x1"] * sx
        nb["y1"] = b["y1"] * sy
        nb["x2"] = min(b["x2"] * sx, float(new_w))
        nb["y2"] = min(b["y2"] * sy, float(new_h))
        if nb["x2"] > nb["x1"] and nb["y2"] > nb["y1"]:
            boxes.append(nb)
    meta = dict(meta)
    meta["bboxes"] = boxes
    meta["width"] = new_w
    meta["height"] = new_h
    return meta


# Prescaled-tile cache: the crop and bicubic prescale of a window depend
# only on (panel, image type, window, size), and every epoch revisits the
# same windows.  Entries are read-only; eviction is first in, first out.
_tile_cache: dict[tuple, np.ndarray] = {}
_tile_cache_lock = threading.Lock()
_tile_cache_bytes = 0


def crop_tile_prescaled(img: np.ndarray, tile: tuple[int, int, int, int], config,
                        cache_key: tuple | None = None, prescale: bool = True) -> np.ndarray:
    """Crop ``tile`` (x1, y1, x2, y2) out of ``img`` and, with ``prescale``,
    resize its longest side down to ``img_size``; memoized under
    ``cache_key`` within ``config.prescaled_tile_cache_mb``."""
    global _tile_cache_bytes
    budget = config.prescaled_tile_cache_mb * 1024 * 1024
    if cache_key is not None and budget > 0:
        with _tile_cache_lock:
            hit = _tile_cache.get(cache_key)
        if hit is not None:
            return hit
    out = np.ascontiguousarray(img[tile[1]:tile[3], tile[0]:tile[2], :])
    if prescale:
        h, w = out.shape[:2]
        if max(h, w) > config.img_size:
            out = _resize(out, *longest_side_dims(w, h, config.img_size))
    if cache_key is not None and 0 < out.nbytes <= budget:
        out.setflags(write=False)
        with _tile_cache_lock:
            prev = _tile_cache.pop(cache_key, None)
            if prev is not None:
                _tile_cache_bytes -= prev.nbytes
            while _tile_cache and _tile_cache_bytes + out.nbytes > budget:
                _tile_cache_bytes -= _tile_cache.pop(next(iter(_tile_cache))).nbytes
            _tile_cache[cache_key] = out
            _tile_cache_bytes += out.nbytes
    return out


def make_sample(img_bgr: np.ndarray, bboxes: list[dict], config,
                class_mapping: dict[str, int]) -> dict[str, np.ndarray]:
    """One fixed-shape sample of an augmented tile: the uint8 canvas, up to
    ``max_gt_boxes`` boxes in canvas pixels with their classes and mask, the
    valid extent, and ``sample_valid``."""
    h, w = img_bgr.shape[:2]
    canvas, _, valid_w, valid_h = resize_to_canvas(img_bgr, config.img_size, config.canvas_size)
    g = config.max_gt_boxes
    gt_boxes = np.zeros((g, 4), dtype=np.float32)
    gt_classes = np.zeros((g,), dtype=np.int32)
    gt_mask = np.zeros((g,), dtype=bool)
    sx, sy = valid_w / float(w), valid_h / float(h)
    for i, b in enumerate(bboxes[:g]):
        gt_boxes[i] = (b["x1"] * sx, b["y1"] * sy, b["x2"] * sx, b["y2"] * sy)
        gt_classes[i] = class_mapping[b["class"]]
        gt_mask[i] = True
    return {
        "image": np.ascontiguousarray(canvas, dtype=np.uint8),
        "gt_boxes": gt_boxes,
        "gt_classes": gt_classes,
        "gt_mask": gt_mask,
        "valid_wh": np.array([valid_w, valid_h], dtype=np.float32),
        "sample_valid": np.asarray(True),
    }


def pad_sample(config) -> dict[str, np.ndarray]:
    """An all-masked sample that fills a partial validation batch."""
    s, g = config.canvas_size, config.max_gt_boxes
    return {
        "image": np.zeros((s, s, 3), dtype=np.uint8),
        "gt_boxes": np.zeros((g, 4), dtype=np.float32),
        "gt_classes": np.zeros((g,), dtype=np.int32),
        "gt_mask": np.zeros((g,), dtype=bool),
        "valid_wh": np.array([s, s], np.float32),
        "sample_valid": np.asarray(False),
    }


def image_sample_generator(data: list[dict], config, class_mapping: dict[str, int],
                           train_mode: bool = True, seed: int = 0,
                           image_loader=get_image) -> Iterator[dict[str, np.ndarray]]:
    """Whole-image samples: shuffle (train mode), augment, resize; one pass
    in eval mode, endless in train mode."""
    rng = np.random.default_rng(seed)
    data = list(data)
    while True:
        if train_mode:
            rng.shuffle(data)
        for img_data in data:
            img_type = (choose_img_type(config.img_types, rng) if config.use_img_type
                        else config.img_types[0])
            img = image_loader(img_data["filepath"], [img_type], random_type=False)
            meta = {"filepath": img_data["filepath"], "width": img.shape[1],
                    "height": img.shape[0], "bboxes": [dict(b) for b in img_data["bboxes"]]}
            if train_mode and config.augment_at_canvas_scale:
                img, meta = prescale_for_augment(img, meta, config)
            meta, img = aug.augment(meta, img, config, do_augment=train_mode, rng=rng)
            if meta["bboxes"]:
                yield make_sample(img, meta["bboxes"], config, class_mapping)
        if not train_mode:
            return


def tile_sample_generator(data: list[dict], config, class_count: dict[str, int],
                          class_mapping: dict[str, int], train_mode: bool = True, seed: int = 0,
                          image_loader=get_image) -> Iterator[dict[str, np.ndarray]]:
    """Fixed-shape samples of tiled panels: class-balanced image and tile
    skipping, random tiles up to ``max_n_tiles_{train,val}`` a panel, boxes
    clipped at ``tile_bbox_clip_threshold``, augmentation in train mode, an
    optional whole-panel sample.  Endless in train mode, one pass in eval
    mode.  The generator draws each tile's image type itself and calls
    ``image_loader(filepath, [type], random_type=False)``; only the default
    loader's tiles are cached, keyed by absolute path."""
    rng = np.random.default_rng(seed)
    selector = SampleSelector(class_count)
    data = list(data)
    cacheable = image_loader is get_image
    while True:
        if train_mode:
            rng.shuffle(data)
        for img_data in data:
            if train_mode and config.balanced_classes and selector.skip_image_for_balanced_class(img_data):
                continue
            tiles = plan_tiles(img_data["width"], img_data["height"], config.tile_size,
                               config.tile_overlap)
            if len(tiles) == 0:
                continue
            try:
                img = image_loader(img_data["filepath"], config.img_types, random_type=False)
            except (FileNotFoundError, OSError) as e:
                print(f"skipping {img_data['filepath']}: {e}")
                continue
            n_tiles = min(len(tiles), config.max_n_tiles_train if train_mode else config.max_n_tiles_val)
            remaining = np.arange(len(tiles))
            emitted = 0
            while emitted < n_tiles and remaining.size > 0:
                pick = rng.integers(0, remaining.size)
                tile = tiles[remaining[pick]]
                remaining = np.delete(remaining, pick)
                img_type = config.img_types[0]
                if config.use_img_type:
                    img_type = choose_img_type(config.img_types, rng)
                # Box survival and the class-balance skip are decided before
                # paying for the crop and prescale.
                boxes_arr = np.array([[b["x1"], b["y1"], b["x2"], b["y2"]] for b in img_data["bboxes"]])
                clipped, keep = clip_boxes_to_tile(boxes_arr, tile, config.tile_bbox_clip_threshold)
                tile_boxes = [dict(img_data["bboxes"][i]) for i in range(len(keep)) if keep[i]]
                if not tile_boxes:
                    continue
                for i in range(clipped.shape[0]):
                    tile_boxes[i]["x1"] = int(clipped[i, 0] - tile[0])
                    tile_boxes[i]["y1"] = int(clipped[i, 1] - tile[1])
                    tile_boxes[i]["x2"] = int(np.ceil(clipped[i, 2] - tile[0]))
                    tile_boxes[i]["y2"] = int(np.ceil(clipped[i, 3] - tile[1]))
                tw, th = int(tile[2] - tile[0]), int(tile[3] - tile[1])
                tile_data = {"filepath": img_data["filepath"], "width": tw, "height": th,
                             "bboxes": tile_boxes}
                if train_mode and config.balanced_classes and selector.skip_tile_for_balanced_class(tile_data):
                    continue
                if config.use_img_type:
                    img = image_loader(img_data["filepath"], [img_type], random_type=False)
                prescale = train_mode and config.augment_at_canvas_scale
                window = tuple(int(v) for v in tile)
                key = ((os.path.abspath(img_data["filepath"]), img_type, window,
                        config.img_size if prescale else 0) if cacheable else None)
                tile_img = crop_tile_prescaled(img, window, config, cache_key=key, prescale=prescale)
                if (tile_img.shape[1], tile_img.shape[0]) != (tw, th):
                    tile_data = scale_meta_boxes(tile_data, tw, th, tile_img.shape[1], tile_img.shape[0])
                tile_data, tile_img = aug.augment(tile_data, tile_img, config,
                                                  do_augment=train_mode, rng=rng)
                if not tile_data["bboxes"]:
                    continue
                emitted += 1
                yield make_sample(tile_img, tile_data["bboxes"], config, class_mapping)

            if config.include_full_img and img_data["bboxes"]:
                full_data = {"filepath": img_data["filepath"], "width": img_data["width"],
                             "height": img_data["height"],
                             "bboxes": [dict(b) for b in img_data["bboxes"]]}
                full_img = img
                if train_mode and config.augment_at_canvas_scale:
                    full_img, full_data = prescale_for_augment(full_img, full_data, config)
                full_data, full_img = aug.augment(full_data, full_img, config,
                                                  do_augment=train_mode, rng=rng)
                if full_data["bboxes"]:
                    yield make_sample(full_img, full_data["bboxes"], config, class_mapping)
        if not train_mode:
            return


def batch_samples(samples: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def batched(sample_iter: Iterator[dict], batch_size: int, config,
            drop_remainder: bool = False) -> Iterator[dict[str, np.ndarray]]:
    """Fixed-size batches; a partial last batch is padded with masked
    samples unless dropped."""
    buf: list[dict] = []
    for s in sample_iter:
        buf.append(s)
        if len(buf) == batch_size:
            yield batch_samples(buf)
            buf = []
    if buf and not drop_remainder:
        while len(buf) < batch_size:
            buf.append(pad_sample(config))
        yield batch_samples(buf)


class _WorkerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


def parallel_sample_generator(data: list[dict], config, class_count: dict[str, int],
                              class_mapping: dict[str, int], *, num_workers: int = 4,
                              seed: int = 0, queue_size: int = 64,
                              image_loader=get_image) -> Iterator[dict[str, np.ndarray]]:
    """Endless training samples from ``num_workers`` threads, each running
    :func:`tile_sample_generator` with its own seed (``seed + 1000 *
    worker``).  numpy and torch's CPU ops release the GIL for the heavy work.
    The order across workers is not deterministic; a worker's exception is
    raised here."""
    q: queue.Queue = queue.Queue(maxsize=queue_size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker(wid: int) -> None:
        try:
            gen = tile_sample_generator(data, config, class_count, class_mapping, train_mode=True,
                                        seed=seed + 1000 * wid, image_loader=image_loader)
            while not stop.is_set():
                if not put(next(gen)):
                    return
        except BaseException as e:
            put(_WorkerError(e))

    threads = [threading.Thread(target=worker, args=(w,), daemon=True) for w in range(num_workers)]
    for t in threads:
        t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, _WorkerError):
                raise item.exc
            yield item
    finally:
        stop.set()


def upload_batch(batch: dict, device) -> dict[str, torch.Tensor]:
    """A host batch (numpy or pinned tensors) onto ``device``, non-blocking,
    on the calling thread's current stream."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(device, non_blocking=device.type == "cuda")
    return out


def _pin(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory() for k, v in batch.items()}


def _background(batch_iter: Iterator[dict], size: int, prepare=None) -> Iterator[dict]:
    """``batch_iter``'s items (``prepare``d) pulled ahead by a thread, up to
    ``size`` of them; the thread stops when the consumer does."""
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    error: list[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in batch_iter:
                if stop.is_set() or not put(prepare(batch) if prepare else batch):
                    return
        except BaseException as e:
            error.append(e)
        finally:
            put(sentinel)

    threading.Thread(target=producer, daemon=True, name="prefetch_to_device").start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def rank_rows(batch: dict, mesh) -> dict:
    """This rank's rows of a whole batch: its data index's equal slice."""
    n = len(next(iter(batch.values()))) // mesh.data
    return {k: v[mesh.data_index * n:(mesh.data_index + 1) * n] for k, v in batch.items()}


def prefetch_to_device(batch_iter: Iterator[dict] | None, device, size: int = 2,
                       mesh=None) -> Iterator[dict]:
    """Device batches of ``batch_iter``.  A thread pulls the host batches and,
    for a CUDA device, copies them into pinned memory; the upload itself
    runs here, on the consumer's stream, so it is ordered with the step that
    reads it.  The thread stops when the consumer does.

    On a ``mesh`` there is one stream, as the JAX package has one
    controller: rank 0's ``batch_iter`` (the other ranks pass None).  Each
    whole batch goes to every rank as a broadcast of CPU tensors
    (``collectives.broadcast_arrays``, on this thread, so the ranks'
    collectives keep one order), and each rank uploads its data index's
    rows (:func:`rank_rows`)."""
    device = torch.device(device)
    pin = device.type == "cuda"
    if mesh is None:
        for batch in _background(batch_iter, size, _pin if pin else None):
            yield upload_batch(batch, device)
        return
    from radnet_torch.parallel.collectives import broadcast_arrays

    host = _background(batch_iter, size) if mesh.is_main else None
    try:
        while True:
            batch = broadcast_arrays(None if host is None else next(host, None), mesh)
            if batch is None:
                return
            rows = rank_rows(batch, mesh)
            yield upload_batch(_pin(rows) if pin else rows, device)
    finally:
        if host is not None:
            host.close()
