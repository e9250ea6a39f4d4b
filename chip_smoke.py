#!/usr/bin/env python3
"""Smoke test of radnet_torch, the PyTorch port, on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. device     card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build      nvcc builds every kernel of radnet_torch/csrc for sm_90a;
  3. kernel 1   the fused NMS (relation + Jacobi rounds in one launch) vs its
                plain version at (12, 2048), (72, 300), a ragged N = 1000, and
                on a suppression chain of 2048, all-tied scores, all-invalid
                sets, N = 1 and N = MAX_N: kept sets, round counts and the
                packed relation (on pairs of valid candidates) must be equal;
  4. kernel 2   RoI pooling vs its plain version at (12, 38, 38, 1024) x
                (12, 300), P = 7, center_stride 2 and 1, bf16 and f32, and
                on four tiles of edge RoIs (near the whole map, so all 14
                taps distinct; single pixels; zero sizes; 300 identical):
                f32 within 1e-5 absolute, bf16 within one bf16 ulp of the
                plain version computed in f32 from the same bf16 inputs;
  5. kernel 3   the grey stem vs its plain version at (12, 608), (6, 608),
                (2, 64) and on two all-255 canvases of 608 (every input
                at its largest), bf16 and f32: f32 within 1e-5 of the largest
                magnitude; bf16 within one bf16 ulp of the plain version
                computed in f32 with the same bf16-rounded weights (or 1e-6
                of the largest magnitude, for values within float32
                accumulation noise of zero); it also counts the bf16 values
                beyond one ulp of a plain version with unrounded weights,
                which the gate does not use; then vs the port's 3-channel
                cuDNN stem on 3-equal-channel canvases at the criterion of
                tests/test_pallas_stem.py;
  6. timings    device time of each kernel, CUDA-event medians of its plain
                version and of a library call, beside the kernel's bound on
                this card; the earlier designs (radnet_torch/csrc/earlier/)
                timed on the same inputs: the RoI pool, the grey stem, and the
                whole earlier NMS call (byte relation + host-synced rounds);
                the RoI-pool backward's in phases 10 and 13;
  7. main path  the default Config (ResNet50, canvas 608, bf16, 12 tiles a
                batch) with seeded random weights, saved to a model dir and
                served through radnet_torch.cli.serve: three 4400 x 3000 grey
                PNG panels, 28 tiles each; every kernel's launch count is
                read around this run, and the NMS round counts the kernel
                left on the card; then per-stage times of one batch, host
                dispatch beside device busy time; the fused NMS on the
                proposal and per-class sets of one batch, beside the whole
                earlier call on the same sets; then one batch and one
                panel's dispatch under torch.cuda.set_sync_debug_mode("error"):
                any operation that waits for the card fails the run;
  8. predict    radnet_torch.cli.predict on a scan directory of two 4400 x
                3000 grey panels and a blended map (launch counts read around
                it), then one panel down each other path through
                RADNet.predict: host tiles on a shortest-side canvas, host
                tiles on the square canvas, full-resolution device tiling and
                include_full_img;
  9. card/CPU   one 2-tile batch of the cascade in float32 (TF32 off) on the
                card and on the CPU, grey canvases (the grey stem) and the
                same canvases as 3 channels: the detection sets must match.
 10. kernel 4   (phase kernel2_backward, run beside kernels 1-3) the RoI-pool
                backward kernel vs roi_pool_backward_plain at (8, 20) and
                (12, 300) RoIs on a 38 x 38 x 1024 map, random and edge RoIs,
                bf16 and f32, both strides: f32 within 1e-5 of the largest
                magnitude (the kernel sums in another fixed order than
                index_add_), bf16 within one bf16 ulp of the float32 result
                (or 1e-6 of the largest); two launches bit-equal; the earlier
                atomic kernel's error beside it, and both timed at bf16,
                stride 2; and torch.autograd.gradcheck of the plain pool in
                float64;
 11. train      six synthetic 2400 x 2400 grey panels with train.csv and
                val.csv; radnet_torch.cli.train at the default config (2
                epochs of 8 steps, validation, --allow-random-init), then
                cli.cont_train (1 epoch of 8 steps, trunk trainable), then
                load_radnet(...).predict on a panel: record.csv has 3 rows,
                the checkpoints, model.pt and each run's dashboard.html exist,
                and each run launched one NMS and one RoI forward per step or
                validation batch, and the backward once per trainable step
                (never when frozen);
 12. evaluate   on the model cli.train wrote, a test set of 12 synthetic
                2400 x 2400 panels (the two validation panels and 22 more):
                radnet_torch.cli.test --coco-map (every class and mAP in
                test_accuracy.json, AP50 == mAP over 10 thresholds in
                test_accuracy_coco.json, a PNG a panel and the SVG curve; per
                batch exactly one grey stem, two NMS and one RoI pool, no
                backward), --compare exiting 0 against its own file and 2
                against 0.01 more mAP; float32 card vs CPU on one panel: the
                trained model's proposals, and the calibrated serving
                weights' detections (at most 5% unmatched each; mAP within
                0.005 against the panel's boxes and against every second
                CPU detection); cli.test_rpn over the test set (a PNG a
                panel, the recall line, one NMS a host tile batch and
                nothing else); cli.test_data drawing 2 samples and its
                anchor report;
 13. train_step ms per step and the card's busy share over 10 steps, frozen
                and trainable, peak memory, the host's samples/s, and each
                kernel at the train step's shapes (library: F.grid_sample and
                its backward); the backward also bit-equal across two
                launches, beside the earlier atomic kernel, and the whole
                RoIPoolFunction backward before (zero fill, atomic kernel,
                cast) and after (one kernel, the only one a call launches);
 14. train_sync_free  one train step under set_sync_debug_mode("error");
 15. learning   60 steps on one fixed batch, photometric augmentation off:
                the mean loss of the last 10 below that of the first 5;
 16. train_card_vs_cpu  one float32 joint step (TF32 off, batch 2, trunk
                trainable) on the card and the CPU with the same weights and
                draws: the proposal sets at most 5% unmatched; with the
                card's proposals given to the CPU step, losses within 1e-4
                relative and updates within 1e-4 of the largest.

VGG16 (vgg_config(): the default Config with network="vgg16", vgg_fc_dim
4096), beside the ResNet50 phases above:
  vgg_kernels   (beside phases 4 and 10) RoI pooling at (12, 38, 38, 512) x
                (12, 300) and its backward at (8, 20) and (12, 300) RoIs,
                C = 512, P = 7, stride 1, random and edge RoIs, bf16 and f32,
                against their plain versions at the tolerances of phases 4
                and 10; the backward bit-equal across two launches;
  vgg_serve     seeded full-width weights (output layers calibrated) served
                through radnet_torch.cli.serve on three 4400 x 3000 grey
                panels: exactly 2 NMS and 1 RoI pool a batch, no grey stem;
  vgg_stages    one 12-tile batch by stage (trunk, RPN + proposals, RoI
                pool, head, per-class NMS) with its launches; the sync check
                on a batch and a panel's dispatch (vgg_sync_free); the NMS
                and RoI pool on the inputs this batch gave them
                (vgg_kernels_main_path), held and timed;
  vgg_predict   radnet_torch.cli.predict on a scan directory;
  vgg_card_vs_cpu  one float32 2-tile grey batch, card vs CPU;
  vgg_train     cli.train --network vgg16 --train-schedule alternating (2
                epochs of 8 steps, validation), then cli.cont_train (4 steps,
                trunk trainable): 3 record rows, both Adam states in the
                checkpoint, exact launches per step, the backward once per
                trainable step;
  vgg_evaluate  cli.test --coco-map on that directory over 6 test panels
                (exact launches a batch), and the calibrated serving weights
                on one panel card vs CPU (at most 5% unmatched; mAP against
                the panel's boxes above 0 and within 0.005, against every
                second CPU detection within 0.05);
  vgg_train_step  ms a step and busy share at batch 8, joint and
                alternating, frozen and trainable; the kernels on one
                trainable alternating step's inputs (vgg_train_kernels);
  vgg_train_sync_free  one alternating step under the sync check;
  vgg_learning  40 alternating steps on a fixed batch: the loss falls;
  vgg_train_card_vs_cpu  one float32 alternating step card vs CPU, trunk
                trainable, plain SGD in both phases, each phase on identical
                inputs (the detector phase from the card's parameters after
                its RPN phase, on its proposals): proposals at most 5%
                unmatched, losses within 1e-4 relative, the output layers'
                updates within 1e-4 of the largest, the other updates and
                the feature map's gradient within 0.1 (float32 flips ReLUs:
                alternating_card_vs_cpu_phase's docstring).

The int8 RoI head (infer_quantize="int8"), on the model dirs the float
serve phases saved and the ones cli.train wrote:
  int8_kernels  (beside phase 6) the quantizer (csrc/quantize_rows.cu) and
                the int8 product (csrc/int8_gemm.cu: wgmma on a TMA-fed ring,
                the dequantize, bias, batch norm, residual sum and ReLU in
                its epilogue) at every shape a 12-tile batch gives them
                (ResNet50's s5a.conv2a, conv_sc, the 3x3 conv2b through the
                implicit im2col, conv2c, s5b.conv2a; VGG16's fc1, fc2; M =
                176 400 or 3600 rows): q and scales bit-equal to the plain
                version (activations as seeded, and with a seeded half of
                them zero, as ReLU outputs, which the quantizer is timed
                on), the int32 sums bit-equal (every row at 8 samples,
                every 37th sample at the full M), the outputs bit-equal on
                every row under each epilogue of INT8_EPILOGUES (float32, its
                ReLU, the batch norm in bf16 and float32 alone, with ReLU,
                with the residual sum and ReLU; the 3x3's edge rows counted),
                and the earlier kernel (csrc/earlier/int8_gemm_mma_sync.cu)
                bit-equal to the float32 epilogue; device ms with the
                epilogue the head runs at that layer beside the fused
                function's bound, plain ms, the earlier kernel's ms and
                torch._int_mm plus the dequantize and the eager cast, batch
                norm, sum and ReLU passes;
  int8_serve    cli.serve --quantize int8 on the three panels: exactly 10
                products and 19 quantizations a ResNet50 batch (2 and 4 a
                VGG16 batch, vgg_int8_serve) besides the float path's
                kernels;
  int8_batch    one 12-tile batch: its launches, the RoI pool + head and
                the batch timed in turns with the float head, the int8
                head's device time by kernel, its device work pinned
                (INT8_HEAD_KERNELS) and no elementwise op over its
                activations (HEAD_ELEMENTWISE_OPS), int8 against float
                detections; the quantizer's device ms launch by launch in
                the head beside the same kernel alone on the same inputs,
                with each activation's share of zeros and seeded inputs of
                its shape with and without zeros; the batch and a panel's
                dispatch under the sync check (int8_batch_sync_free);
  int8_predict  cli.predict --quantize int8 on the scan directory;
  int8_card_vs_cpu  float32: the head on identical pooled inputs within
                INT8_HEAD_LIMIT of its largest output, a 2-tile batch's
                detections at most INT8_UNMATCHED_SHARE unmatched (limits
                from scripts/int8_card_vs_cpu_probe.py's readings);
  int8_test     cli.test --quantize int8 on the trained model (exact
                launches a batch); a saved infer_quantize runs the int8
                head, --quantize none does not.
Each int8 phase runs for VGG16 too, named vgg_int8_*.

Pretrained backbone weights, on the training set of phase 11:
  pretrained_train  radnet_torch.cli.train at the default Config
                (base_net_weights="imagenet") with --weights and without
                --allow-random-init: ResNet50 from a converted Keras file of
                seeded full-width arrays (2 epochs of 8 steps, validation),
                from a seeded torchvision resnet50 dict (2 steps), VGG16 with
                the alternating schedule from a converted file (4 steps):
                the "Loaded pretrained" line, every loaded tensor that does
                not train bit-equal in model.pt to the host's mapping of the
                file and trained ones moved, exactly one NMS and one RoI
                forward a step or validation batch and nothing else, finite
                losses and the four loss plots (SVG); the load's seconds and
                the median gap between train steps; then without a file or
                the flag, the exit with JAX's message.

The last lines are the kernels JSON line (six kernels; launches over each
kernel's main path: the served run, cont_train for the backward, the int8
served run for the int8 kernels; beside them the launches of the train,
cont_train, test and test_rpn runs, under "launches_vgg16" those of the
VGG16 runs, under "launches_int8" those of the int8 runs and under
"launches_pretrained_train" those of pretrained_train's runs; each kernel's
rows at the VGG16 shapes under "vgg16"), the nvidia-smi line, and {"ok":
true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
PANEL_HW = (3000, 4400)
N_PANELS = 3
NO_INT8 = {"quantize_rows": 0, "int8_gemm": 0}  # launches of the float head's runs
SEED = 0
# (B, N, IoU threshold, box extent, unit, kind): the proposal NMS, the
# per-class NMS, a ragged N, then the adversarial sets: a suppression chain as
# long as N (one box settles a round, so the N-round cap is reached), all
# scores tied (the index decides), all invalid, N = 1, and the largest N.
NMS_CASES = [(12, 2048, 0.7, 10, 1.0, "random"), (72, 300, 0.2, 8, 16.0, "random"),
             (5, 1000, 0.5, 12, 1.0, "random"), (1, 2048, 0.7, 0, 1.0, "chain"),
             (4, 2048, 0.7, 10, 1.0, "tied"), (3, 300, 0.2, 8, 16.0, "invalid"),
             (8, 1, 0.7, 10, 1.0, "random"), (2, None, 0.5, 40, 1.0, "random")]
# (B, S, canvases) of the grey stem: a full batch, a half batch, a small
# canvas, and all-255 canvases, every input at its largest.
STEM_CASES = [(12, 608, "random"), (6, 608, "random"), (2, 64, "random"), (2, 608, "white")]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def bf16_ulp(x):
    """One bf16 ulp at the magnitude of each element of float32 ``x``."""
    import torch

    mag = x.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def roi_forward_error(got, ref, dtype) -> tuple[bool, float, str]:
    """(within tolerance, max abs error, tolerance) of the RoI-pool kernel's
    output against its plain version's float32 ``ref``: f32 1e-5 abs, bf16
    one ulp."""
    import torch

    err = (got.float() - ref).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if dtype == torch.float32:
        return max_err <= 1e-5, max_err, "1e-5 abs"
    ulps = float((err / bf16_ulp(ref)).max()) if err.numel() else 0.0
    return ulps <= 1.0, max_err, f"1 bf16 ulp (max {ulps:.3f} ulp)"


def roi_backward_error(got, ref) -> tuple[bool, float, float, str]:
    """(within tolerance, max abs error, largest magnitude, tolerance) of a
    backward kernel's map gradient ``got``, in the map's type, against the
    plain version's float32 ``ref``: f32 1e-5 of the largest magnitude (the
    kernel sums in another fixed order than index_add_); bf16 one ulp of the
    float32 result (at least 1e-6 of the largest)."""
    import torch

    top = float(ref.abs().max())
    e = (got.float() - ref).abs()
    if got.dtype == torch.float32:
        err = float(e.max())
        return err <= 1e-5 * top, err, top, "1e-5 of the largest magnitude"
    ok = bool((e <= torch.clamp(bf16_ulp(ref), min=1e-6 * top)).all())
    return (ok, float(e.max()), top,
            "1 bf16 ulp of the float32 result (at least 1e-6 of the largest)")


def time_cuda(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` CUDA-event pairs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, symbol: str, iters: int = 20) -> float | None:
    """Mean device milliseconds per launch of the kernels whose name holds
    ``symbol``, from ``torch.profiler`` over ``iters`` calls (None if the
    profiler saw no such kernel).  Unlike CUDA events around the call, this
    leaves out the host time of the Python wrapper."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a profiler window has once missed the kernel: ask twice
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for e in prof.key_averages():
            if symbol in e.key:
                total_us += getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
                count += e.count
        if count:
            return total_us / count / 1e3
    return None


def device_work_per_call(fn) -> int:
    """Device kernels, memsets and copies one call of ``fn`` puts on the
    card: the nodes of a CUDA graph captured from one call, read with
    libcuda's cuGraphGetNodes (torch.profiler windows have missed kernels on
    the card)."""
    import ctypes

    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    torch.cuda.synchronize()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        kinds.append(kind.value)
    graph.reset()
    return sum(k in (0, 1, 2) for k in kinds)  # CU_GRAPH_NODE_TYPE_KERNEL, MEMCPY, MEMSET


def call_device_ms(fn, iters: int = 20) -> float:
    """Device milliseconds per call of ``fn``: the mean device time of each
    kernel it launches (a library call's fills included), from
    ``torch.profiler``, summed over the kernels, each once a call.  Means by
    kernel, not the window's sum, since a profiler window on the card has
    missed some of the kernels it ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    return sum(statistics.mean(v) for v in by_name.values()) / 1e3


def device_busy(fn) -> tuple[float, float]:
    """(wall ms of ``fn()`` to a synchronise, ms in which the card ran a
    kernel): the union of the kernel intervals ``torch.profiler`` saw."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return wall_ms, busy_us / 1e3


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------- #
# Inputs made from a seed.
# --------------------------------------------------------------------------- #
def nms_inputs(b, n, seed, extent, unit, device, kind="random"):
    """Integer-valued boxes (some degenerate), tied scores, 15% invalid
    (scored -inf, as nms_fixed_point scores them); or one of the adversarial
    sets of NMS_CASES.  Returns boxes, scores, valid on ``device``."""
    import torch

    rng = np.random.default_rng(seed)
    if kind == "chain":  # box k overlaps k + 1 at IoU 9/11, k + 2 at 8/12
        x = np.arange(n * b, dtype=np.float32).reshape(b, n)
        boxes = np.stack([x, 0 * x, x + 10, 0 * x + 10], -1).astype(np.float32)
        scores = (1.0 - x / (2 * n)).astype(np.float32)
        valid = np.ones((b, n), bool)
    else:
        x1 = rng.integers(0, extent, (b, n))
        y1 = rng.integers(0, extent, (b, n))
        w = rng.integers(0, 8, (b, n))  # w == 0: degenerate
        h = rng.integers(0, 8, (b, n))
        boxes = (np.stack([x1, y1, x1 + w, y1 + h], -1) * unit).astype(np.float32)
        scores = rng.choice(np.linspace(0.05, 1.0, 40), (b, n)).astype(np.float32)
        valid = rng.random((b, n)) >= 0.15
        if kind == "tied":
            scores[:] = np.float32(0.5)
            valid[:] = True
        elif kind == "invalid":
            valid[:] = False
        scores[~valid] = -np.inf
    return (torch.from_numpy(boxes).to(device), torch.from_numpy(scores).to(device),
            torch.from_numpy(valid).to(device))


def roi_inputs(dtype, seed, device, b=12, hw=38, c=1024, r=300):
    import torch

    rng = np.random.default_rng(seed)
    fmap = torch.from_numpy(rng.normal(0, 1, (b, hw, hw, c)).astype(np.float32))
    xy = rng.integers(-3, hw + 3, (b, r, 2))
    wh = rng.integers(0, 20, (b, r, 2))  # w or h of 0 included
    rois = np.concatenate([xy, wh], -1).astype(np.float32)
    rois[:, 0] = (0, 0, hw - 1, hw - 1)
    rois[:, 1] = (hw - 1, hw - 1, 0.5, 0.0)
    rois[:, 2] = (hw + 4, 2, 5, 5)  # past the map
    return fmap.to(device=device, dtype=dtype), torch.from_numpy(rois).to(device)


def roi_edge_inputs(dtype, seed, device, hw=38, c=1024, r=300):
    """Four tiles of RoIs at the edges of the kernel's staging: near the
    whole map (every one of the 2P row and column taps distinct), single
    pixels, zero sizes, and one RoI repeated 300 times."""
    import torch

    rng = np.random.default_rng(seed)
    fmap = torch.from_numpy(rng.normal(0, 1, (4, hw, hw, c)).astype(np.float32))
    rois = np.empty((4, r, 4), np.float32)
    rois[0, :, :2] = rng.integers(-2, 3, (r, 2))
    rois[0, :, 2:] = rng.integers(hw - 4, hw + 3, (r, 2))
    rois[0, 0] = (0, 0, hw, hw)
    for t, size in ((1, 1), (2, 0)):
        rois[t, :, :2] = rng.integers(0, hw, (r, 2))
        rois[t, :, 2:] = size
    rois[1, :4, :2] = ((0, 0), (hw - 1, 0), (0, hw - 1), (hw - 1, hw - 1))
    rois[3] = (5, 7, 12, 9)
    return fmap.to(device=device, dtype=dtype), torch.from_numpy(rois).to(device)


def synthetic_grey_panel(seed: int, hw=None) -> np.ndarray:
    """A grey panel: dark textured rock with bright carved figures."""
    rng = np.random.default_rng(seed)
    h, w = hw or PANEL_HW
    img = rng.integers(20, 60, (-(-h // 4), -(-w // 4)), dtype=np.uint8)
    img = np.repeat(np.repeat(img, 4, axis=0), 4, axis=1)[:h, :w]
    n = max(8, 120 * h * w // (PANEL_HW[0] * PANEL_HW[1]))
    for _ in range(n):
        x, y = rng.integers(0, max(1, w - 300)), rng.integers(0, max(1, h - 300))
        bw, bh = rng.integers(40, 300, 2)
        img[y : y + bh, x : x + bw] = rng.integers(110, 250)
    return np.ascontiguousarray(img)


def bgr(grey: np.ndarray) -> np.ndarray:
    """A grey panel as the three equal BGR channels a PNG decode gives."""
    return np.repeat(grey[..., None], 3, axis=-1)


def synthetic_colour_panel(seed: int, hw) -> np.ndarray:
    """The grey panel tinted per channel, with colour noise: BGR uint8."""
    grey = synthetic_grey_panel(seed, hw).astype(np.int16)
    rng = np.random.default_rng(seed + 1000)
    tint = np.array([-12, 0, 14], np.int16)
    noise = rng.integers(-6, 7, grey.shape + (3,), dtype=np.int16)
    return np.clip(grey[..., None] + tint + noise, 0, 255).astype(np.uint8)


def stem_params(seed: int):
    """Stem weights in test_pallas_stem.py's distribution: the 3-channel 7x7
    conv (OIHW), its bias and the frozen batch norm."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.05, (64, 3, 7, 7)).astype(np.float32)
    bias = rng.normal(0, 0.05, (64,)).astype(np.float32)
    bn = {"gamma": rng.normal(1, 0.1, 64), "beta": rng.normal(0, 0.1, 64),
          "mean": rng.normal(0, 1.0, 64), "var": rng.uniform(0.5, 2.0, 64)}
    return w, bias, {k: v.astype(np.float32) for k, v in bn.items()}


def grey_canvases(b: int, s: int, seed: int, device, kind: str = "random"):
    """uint8 (B, S, S) canvases: random content (S - 8 square) that leaves a
    dead band, so the centring map's edge is exercised; or all 255."""
    import torch

    if kind == "white":
        return torch.full((b, s, s), 255, dtype=torch.uint8, device=device)
    rng = np.random.default_rng(seed)
    g = np.zeros((b, s, s), np.uint8)
    g[:, : s - 8, : s - 8] = rng.integers(0, 255, (b, s - 8, s - 8))
    return torch.from_numpy(g).to(device)


def stem_trunk(w, bias, bn, dtype, device):
    """The port's ResNet50 trunk with these stem weights (its 3-channel
    stem is what the grey stem replaces)."""
    import torch

    from radnet_torch.models.resnet import ResNet50Trunk

    trunk = ResNet50Trunk(dtype=dtype)
    with torch.no_grad():
        trunk.conv1.weight.copy_(torch.from_numpy(w))
        trunk.conv1.bias.copy_(torch.from_numpy(bias))
        for k, v in bn.items():
            getattr(trunk.bn_conv1, k).copy_(torch.from_numpy(v))
    return trunk.to(device).eval()


def stem_consts(w, bias, bn, s, dtype, device):
    """The grey stem's StemConsts on the card for an output type, and the
    unrounded float32 ``k7``."""
    import torch

    from radnet_torch.data.pipeline import IMAGENET_BGR_MEAN
    from radnet_torch.ops.grey_stem import make_stem_consts, stem_constants

    arrays = stem_constants(w, bias, bn, s, IMAGENET_BGR_MEAN)
    return make_stem_consts(arrays, dtype, device), torch.from_numpy(arrays[0]).to(device)


def grid_sample_centres(rois, p, stride, hw):
    """Normalised grid_sample coordinates of the RoI pool's sample centres
    (align_corners=True: -1 and 1 are the centres of the first and last cell)."""
    import torch

    from radnet_torch.ops.roi_align import _sample_centers

    sy = _sample_centers(rois[..., 1], rois[..., 3], p, hw, stride)  # (B, R, P)
    sx = _sample_centers(rois[..., 0], rois[..., 2], p, hw, stride)
    gy = sy / (hw - 1) * 2 - 1
    gx = sx / (hw - 1) * 2 - 1
    b, r = rois.shape[:2]
    grid = torch.stack(
        [gx[:, :, None, :].expand(b, r, p, p), gy[:, :, :, None].expand(b, r, p, p)], -1
    )
    return grid.reshape(b, r * p, p, 2)


@contextlib.contextmanager
def count_flops(model):
    """FLOPs (two per multiply-add) of every conv and dense layer run inside
    the block, summed by top-level module (trunk, rpn_head, head)."""
    import torch

    from radnet_torch.models.layers import Conv
    from radnet_torch.models.vgg import Dense

    totals: dict[str, int] = {}
    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, (Conv, Dense, torch.nn.Linear)):
            def hook(mod, inp, out, top=name.split(".")[0]):
                totals[top] = totals.get(top, 0) + 2 * out.numel() * mod.weight[0].numel()

            hooks.append(m.register_forward_hook(hook))
    try:
        yield totals
    finally:
        for h in hooks:
            h.remove()


# --------------------------------------------------------------------------- #
# Seeded weights that give spread, decisive scores.
# --------------------------------------------------------------------------- #
def calibrate_heads(radnet, canvases, gen):
    """Random output-layer weights, scaled and centred on a calibration batch
    so objectness logits have std 3, class logits std 4 and box deltas a
    modest spread: scores neither saturate to ties nor sit in float noise,
    and detections clear bbox_threshold."""
    import torch
    from torch.nn import functional as F

    from radnet_torch.geometry import xyxy_to_xywh
    from radnet_torch.ops.roi_align import batched_roi_pool

    model = radnet.model
    dev = radnet.device

    def fit(layer, feats, target_std):
        w = torch.randn(layer.weight.shape[:2], generator=gen).to(dev)
        logits = feats @ w.t()
        w = w * (target_std / logits.std(0).clamp_min(1e-6))[:, None]
        layer.weight.copy_(w.reshape(layer.weight.shape))
        layer.bias.copy_(-(feats @ w.t()).mean(0))

    with torch.no_grad():
        fmap = radnet._features(canvases)
        hid = F.relu(model.rpn_head.rpn_conv1(fmap)).float().permute(0, 2, 3, 1).reshape(-1, 512)
        fit(model.rpn_head.rpn_out_class, hid, 3.0)
        fit(model.rpn_head.rpn_out_regress, hid, 0.8)
        valid_wh = torch.full((len(canvases), 2), float(radnet.C.img_size), device=dev)
        props = radnet._proposals(fmap, valid_wh)
        rois = xyxy_to_xywh(props.boxes)
        p = batched_roi_pool(
            fmap.permute(0, 2, 3, 1).contiguous(), rois.contiguous(),
            pool_size=model.pool_size, center_stride=model.pool_center_stride,
        )
        head = model.head
        if model.network == "vgg16":  # fc1 and fc2 on the flattened NHWC pool
            x = F.relu(head.fc2(F.relu(head.fc1(p.reshape(p.shape[0] * p.shape[1], -1)))))
        else:
            x = p.reshape((-1,) + p.shape[2:]).permute(0, 3, 1, 2)
            x = F.avg_pool2d(head.s5c(head.s5b(head.s5a(x.to(head.dtype)))), 7).flatten(1)
        feats = x.float()[props.valid.reshape(-1)]
        fit(head.dense_class, feats, 4.0)
        fit(head.dense_regress, feats, 0.5)


def nms_checks(dev) -> float:
    """Phase 3: the fused NMS against its plain version on the card: kept
    sets, round counts and the packed relation all equal.  Returns the
    largest kept-set difference (0)."""
    import torch

    from radnet_torch.ops import nms

    nms_err = 0.0
    for i, (b, n, thr, extent, unit, kind) in enumerate(NMS_CASES):
        n = nms.MAX_N if n is None else n
        boxes, scores, valid = nms_inputs(b, n, SEED + i, extent, unit, dev, kind)
        kept, rounds, words = nms.nms_kept_cuda(boxes, scores, valid, thr, with_relation=True)
        want_kept, want_rounds = nms.nms_kept_plain(boxes, scores, valid, thr)
        dom = nms.dominates_plain(boxes, scores, thr) & valid[:, :, None] & valid[:, None, :]
        want_words = nms.pack_relation(dom)
        torch.cuda.synchronize()
        kept_mism = int((kept != want_kept).sum())
        rel_mism = int((words != want_words).sum())
        nms_err = max(nms_err, float((kept.float() - want_kept.float()).abs().max()))
        emit({"phase": "kernel1", "kind": kind, "shape": [b, n], "thresh": thr,
              "kept_mismatches": kept_mism, "relation_word_mismatches": rel_mism,
              "rounds": rounds.tolist(), "plain_rounds": want_rounds.tolist(),
              "kept": int(kept.sum()), "valid": int(valid.sum()),
              "relation_true_frac": float(dom.float().mean())})
        check(kept_mism == 0, f"nms_fused kept set disagrees with its plain version ({kind}, {(b, n)})")
        check(rel_mism == 0, f"nms_fused relation disagrees with dominates_plain ({kind}, {(b, n)})")
        check(torch.equal(rounds, want_rounds), f"nms_fused rounds differ ({kind}, {(b, n)})")
        del dom, want_words, words
    return nms_err


def kernel_checks(dev) -> dict:
    """Phases 3-5: every kernel against its plain version on the card."""
    import torch

    from radnet_torch.data.pipeline import preprocess_on_device
    from radnet_torch.ops import grey_stem, roi_align

    errs = {"nms_fused": nms_checks(dev)}

    # 4. kernel 2 vs plain: f32 <= 1e-5 abs; bf16 within one bf16 ulp.
    for dtype in (torch.bfloat16, torch.float32):
        for stride in (2, 1):
            for case, make_inputs in (("random", roi_inputs), ("edges", roi_edge_inputs)):
                fmap, rois = make_inputs(dtype, SEED + stride, dev)
                got = roi_align.roi_pool_cuda(fmap, rois, pool_size=7, center_stride=stride)
                ref = roi_align.roi_pool_plain(fmap.float(), rois, pool_size=7,
                                               center_stride=stride)
                torch.cuda.synchronize()
                ok, max_err, tol = roi_forward_error(got, ref, dtype)
                if dtype == torch.bfloat16 and stride == 2 and case == "random":
                    errs["roi_pool"] = max_err
                emit({"phase": "kernel2", "rois": case, "shape": list(got.shape),
                      "dtype": str(dtype), "center_stride": stride, "max_abs_err": max_err,
                      "tolerance": tol, "exact": max_err == 0})
                check(ok, f"roi_pool disagrees with its plain version ({case}, {dtype}, "
                          f"stride {stride})")
                del fmap, got, ref

    # 5. kernel 3 vs plain, then vs the 3-channel stem it replaces.
    w, bias, bn = stem_params(SEED)
    for b, s, kind in STEM_CASES:
        g = grey_canvases(b, s, SEED + b + s, dev, kind)
        for dtype in (torch.bfloat16, torch.float32):
            consts, k7 = stem_consts(w, bias, bn, s, dtype, dev)
            b0, scale = consts.centring_map(), consts.scale  # the full map, for the plain version
            got = grey_stem.grey_stem_cuda(g, consts, dtype)
            ref = grey_stem.grey_stem_plain(g, consts.k7, b0, scale, torch.float32)
            torch.cuda.synchronize()
            err = (got.float() - ref).abs()
            max_err, top = float(err.max()), float(ref.abs().max())
            extra = {}
            if dtype == torch.float32:
                ok, tol = max_err <= 1e-5 * top, "1e-5 of the largest magnitude"
            else:
                beyond = err > bf16_ulp(ref)
                ok = bool((err <= torch.clamp(bf16_ulp(ref), min=1e-6 * top)).all())
                tol = "1 bf16 ulp, at least 1e-6 of the largest magnitude"
                ref_unrounded = grey_stem.grey_stem_plain(g, k7, b0, scale, torch.float32)
                extra = {"max_ulps": float((err / bf16_ulp(ref)).max()),
                         "n_beyond_1_ulp": int(beyond.sum()),
                         "largest_ref_beyond_1_ulp": float(ref.abs()[beyond].max()) if beyond.any() else None,
                         "n_values": got.numel(),
                         "n_beyond_1_ulp_of_plain_with_unrounded_weights": int(
                             ((got.float() - ref_unrounded).abs() > bf16_ulp(ref_unrounded)).sum())}
                del ref_unrounded
            if (b, s, kind) == STEM_CASES[0] and dtype == torch.bfloat16:
                errs["grey_stem"] = max_err
            emit({"phase": "kernel3", "shape": [b, s], "canvases": kind, "dtype": str(dtype),
                  "weight_pieces": consts.pieces.shape[0], "max_abs_err": max_err, **extra,
                  "largest": top, "tolerance": tol, "exact": bool(err.max() == 0)})
            check(ok, f"grey_stem disagrees with its plain version ({dtype}, {(b, s, kind)})")
            del got, ref, err, b0

    b, s, _ = STEM_CASES[0]
    consts, _ = stem_consts(w, bias, bn, s, torch.bfloat16, dev)
    g = grey_canvases(b, s, SEED, dev)
    with torch.inference_mode():
        img = preprocess_on_device(g[..., None].expand(b, s, s, 3))
        ref32 = stem_trunk(w, bias, bn, torch.float32, dev).stem(img).permute(0, 2, 3, 1).float()
        ref16 = stem_trunk(w, bias, bn, torch.bfloat16, dev).stem(img).permute(0, 2, 3, 1).float()
        out = grey_stem.grey_stem_cuda(g, consts, torch.bfloat16).float()
        mag = ref32.abs().clamp_min(8.0)
        rel_kernel = float(((out - ref32).abs() / mag).max())
        rel_bf16path = float(((ref16 - ref32).abs() / mag).max())
    emit({"phase": "kernel3_vs_three_channel_stem", "shape": [b, s],
          "rel_grey_stem_bf16": rel_kernel, "rel_three_channel_bf16": rel_bf16path,
          "criterion": "rel_grey_stem_bf16 < max(0.02, 2 * rel_three_channel_bf16)"})
    check(rel_kernel < max(0.02, 2.0 * rel_bf16path),
          f"grey stem vs 3-channel stem: {rel_kernel} vs bf16 path {rel_bf16path}")
    return errs


def earlier_kernels() -> dict:
    """The earlier designs of the NMS (a byte relation in device memory), the
    RoI pool (one block per output cell), the grey stem (float32 products on
    the CUDA cores, a full centring map), the RoI-pool backward (float32
    atomics into a zeroed map) and the int8 product (mma.sync tiles fed by
    cp.async, a float32 output), kept in radnet_torch/csrc/earlier/ to be
    timed beside the current kernels."""
    import ctypes

    from radnet_torch.ops.cuda_kernels import CudaKernel

    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return {
        "nms_dominance": CudaKernel("earlier/nms_dominance.cu", "radnet_nms_dominance",
                                    [ptr] * 3 + [i32, i32, ctypes.c_float],
                                    extra_flags=("--fmad=false",)),
        "roi_pool": CudaKernel("earlier/roi_pool_per_cell.cu", "radnet_earlier_roi_pool",
                               [ptr] * 3 + [i32] * 8, extra_flags=("--fmad=false",)),
        "grey_stem": CudaKernel("earlier/grey_stem_scalar.cu", "radnet_earlier_grey_stem",
                                [ptr] * 5 + [i32] * 3),
        "roi_pool_backward": CudaKernel(
            "earlier/roi_pool_backward_atomic.cu", "radnet_earlier_roi_pool_backward",
            [ptr] * 3 + [i32] * 8, extra_flags=("--fmad=false",), headers=("roi_taps.cuh",)),
        "int8_gemm": CudaKernel("earlier/int8_gemm_mma_sync.cu", "radnet_int8_gemm",
                                [ptr] * 6 + [i32] * 8, extra_flags=("--fmad=false",)),
    }


def earlier_roi_backward(kernel, g, rois, map_hw, *, pool_size, center_stride):
    """The earlier backward kernel as its wrapper ran it: float32 sums into a
    zeroed map."""
    import torch

    from radnet_torch.ops.cuda_kernels import ptr

    b, r, _, _, c = g.shape
    out = torch.zeros((b, *map_hw, c), dtype=torch.float32, device=g.device)
    kernel.launch(ptr(g), ptr(rois), ptr(out), b, *map_hw, c, r, pool_size, center_stride,
                  {torch.float32: 0, torch.bfloat16: 1}[g.dtype])
    return out


def earlier_nms_kept(kernel, boxes, scores, valid, thresh):
    """The whole earlier NMS call: the byte relation from the earlier kernel,
    then Jacobi rounds on the host's loop, each ending in a device -> host
    read of the convergence test."""
    import ctypes

    import torch

    from radnet_torch.ops.cuda_kernels import ptr

    b, n = scores.shape
    dom = torch.empty((b, n, n), dtype=torch.uint8, device=boxes.device)
    kernel.launch(ptr(boxes), ptr(scores), ptr(dom), b, n, ctypes.c_float(thresh))
    dom = dom.view(torch.bool)
    kept, rounds = valid, 0
    while rounds < n:
        new_kept = valid & ~(dom & kept[:, None, :]).any(dim=-1)
        rounds += 1
        changed = bool((new_kept != kept).any())  # device -> host sync
        kept = new_kept
        if not changed:
            break
    return kept


def versus_earlier(kernel, boxes, scores, valid, thresh, kept) -> dict:
    """The whole earlier NMS call on the same inputs: its time, its kernel's
    device time, and whether its kept set equals ``kept``."""
    import torch

    def call():
        return earlier_nms_kept(kernel, boxes, scores, valid, thresh)

    return {"earlier_call_ms": time_cuda(call, iters=10),
            "earlier_kernel_ms": device_ms(call, "dominance_kernel", iters=5),
            "earlier_equal": bool(torch.equal(call(), kept))}


def nms_work(boxes, scores, valid, rounds) -> tuple[float, float]:
    """(bytes, operations) the NMS function needs on these inputs: it reads 21
    bytes and writes one a candidate, and 4 a set; it tests every pair of
    live candidates (valid, non-degenerate, a score that is not NaN) once, in
    the direction of the higher score, at ~16 float operations, and each
    round ANDs and ORs every row's N / 32 words."""
    import torch

    b, n = scores.shape
    live = (valid & (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
            & ~torch.isnan(scores)).sum(-1).double()
    pairs = float((live * (live - 1) / 2).sum())
    ops = 16.0 * pairs + 2.0 * float(rounds.double().sum()) * n * -(-n // 32)
    return b * n * 22 + 4 * b, ops


def timed(kernel_fn, symbol, plain_fn, n_bytes, n_ops, shape, ops_per_s=F32_OPS_PER_S) -> dict:
    """A kernel's device time (profiler) and call time (CUDA events), its
    plain version's time, and its bound on this card."""
    call_ms = time_cuda(kernel_fn)
    dev_ms = device_ms(kernel_fn, symbol)
    bnd, by = bound_ms(n_bytes, n_ops, ops_per_s)
    return {"shape": shape, "ms": dev_ms if dev_ms is not None else call_ms,
            "call_ms": call_ms, "ms_source": "profiler" if dev_ms is not None else "cuda_events",
            "plain_ms": time_cuda(plain_fn, iters=5), "bound_ms": bnd, "bound_by": by}


def nms_timings(dev, err: float, earlier: dict) -> dict:
    """Phase 6, kernel 1: the fused NMS at the proposal and per-class shapes,
    beside the whole earlier call on the same inputs."""
    from radnet_torch.ops import nms

    nms_times = []
    for i, (b, n, thr, extent, unit, kind) in enumerate(NMS_CASES[:2]):  # proposal, per-class
        boxes, scores, valid = nms_inputs(b, n, SEED + i, extent, unit, dev, kind)
        kept, rounds = nms.nms_kept_cuda(boxes, scores, valid, thr)
        t = timed(lambda: nms.nms_kept_cuda(boxes, scores, valid, thr), "nms_fused_kernel",
                  lambda: nms.nms_kept_plain(boxes, scores, valid, thr),
                  *nms_work(boxes, scores, valid, rounds), [b, n])
        t["rounds"] = rounds.tolist()
        t.update(versus_earlier(earlier["nms_dominance"], boxes, scores, valid, thr, kept))
        nms_times.append(t)
        check(t["earlier_equal"], f"the earlier NMS call disagrees with nms_fused at {(b, n)}")
    line = {"nms_fused": {
        "name": "nms_fused", "route": "cuda", "source": "radnet_torch/csrc/nms_fused.cu",
        "replaces": "radnet_tpu/ops/pallas_nms.py:31",
        "replaces_also": "the Jacobi loop of radnet_tpu/ops/nms.py:151-162",
        **nms_times[0], "library_ms": None, "max_abs_err": err,
        "per_class_shape": nms_times[1],
        "earlier_design": ("byte relation in device memory (radnet_torch/csrc/earlier/"
                           "nms_dominance.cu) + Jacobi rounds on the host, each synced"),
    }}
    return line


def nms_main_path(net, images, earlier: dict) -> dict:
    """The fused NMS on the inputs the main path gives it: the proposal and
    per-class NMS sets of one 12-tile batch, captured as the cascade calls
    it, timed beside the whole earlier call on the same sets."""
    import torch

    from radnet_torch.ops import nms

    captured, real = [], nms.nms_kept

    def capture(boxes, scores, valid, thresh):
        captured.append((boxes.clone(), scores.clone(), valid.clone(), thresh))
        return real(boxes, scores, valid, thresh)

    valid_wh = torch.full((len(images), 2), float(net.C.img_size), device=net.device)
    nms.nms_kept = capture
    try:
        net._predict_tiles_impl(images, valid_wh)
    finally:
        nms.nms_kept = real
    check(len(captured) == 2, f"one batch made {len(captured)} NMS calls, not 2")
    out = {}
    for site, (boxes, scores, valid, thr) in zip(("proposal", "per_class"), captured):
        kept, rounds = nms.nms_kept_cuda(boxes, scores, valid, thr)
        bnd, by = bound_ms(*nms_work(boxes, scores, valid, rounds))
        out[site] = {
            "shape": list(scores.shape), "thresh": thr, "valid": int(valid.sum()),
            "kept": int(kept.sum()), "rounds_max": int(rounds.max()),
            "ms": device_ms(lambda: nms.nms_kept_cuda(boxes, scores, valid, thr), "nms_fused_kernel"),
            "call_ms": time_cuda(lambda: nms.nms_kept_cuda(boxes, scores, valid, thr)),
            "bound_ms": bnd, "bound_by": by,
            **versus_earlier(earlier["nms_dominance"], boxes, scores, valid, thr, kept),
        }
        check(out[site]["earlier_equal"], f"the earlier NMS call disagrees on the main path's {site} sets")
    emit({"phase": "nms_main_path", **out})
    return out


def timings(dev, errs: dict, earlier: dict) -> dict:
    """Phase 6: each kernel's time at the main path's shapes beside its bound,
    its plain version, a library call and the earlier design on the same
    inputs."""
    import torch

    from radnet_torch.data.pipeline import preprocess_on_device
    from radnet_torch.ops import grey_stem, roi_align
    from radnet_torch.ops.cuda_kernels import ptr

    line = nms_timings(dev, errs["nms_fused"], earlier)

    fmap, rois = roi_inputs(torch.bfloat16, SEED, dev)
    b, hw, _, c = fmap.shape
    r, p, elt = rois.shape[1], 7, fmap.element_size()
    grid = grid_sample_centres(rois, p, 2, hw).to(fmap.dtype)
    fmap_nchw = fmap.permute(0, 3, 1, 2)  # channels-last NCHW view

    def library():
        return torch.nn.functional.grid_sample(
            fmap_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)

    def earlier_roi():
        out = torch.empty((b, r, p, p, c), dtype=fmap.dtype, device=dev)
        earlier["roi_pool"].launch(ptr(fmap), ptr(rois), ptr(out), b, hw, hw, c, r, p, 2, 1)
        return out

    lib_dev_ms = device_ms(library, "grid_sampler")
    earlier_equal = bool(torch.equal(
        earlier_roi(), roi_align.roi_pool_cuda(fmap, rois, pool_size=p, center_stride=2)))
    line["roi_pool"] = {
        "name": "roi_pool", "route": "cuda", "source": "radnet_torch/csrc/roi_pool.cu",
        "replaces": "radnet_tpu/ops/pallas_roi.py:37",
        **timed(lambda: roi_align.roi_pool_cuda(fmap, rois, pool_size=p, center_stride=2),
                "roi_pool_kernel",
                lambda: roi_align.roi_pool_plain(fmap, rois, pool_size=p, center_stride=2),
                b * hw * hw * c * elt + b * r * 16 + b * r * p * p * c * elt,
                9.0 * b * r * p * p * c, [b, hw, hw, c, r, p]),
        "library_ms": lib_dev_ms if lib_dev_ms is not None else time_cuda(library),
        "max_abs_err": errs["roi_pool"],
        "earlier_ms": device_ms(earlier_roi, "roi_pool_kernel"),
        "earlier_design": "one block per output cell (radnet_torch/csrc/earlier/roi_pool_per_cell.cu)",
        "earlier_output_equal": earlier_equal,
    }
    del fmap, rois, grid, fmap_nchw

    # Grey stem at one 12-tile batch of 608 canvases, bf16.  Bytes the
    # function needs: canvases, output, and its parameters (k7, the
    # mean-weighted kernel, bias, BN scale and shift, the 7-tap edge vectors
    # of the centring).  Operations: 2 per multiply-add of the single-channel
    # conv over the conv outputs the pool reads, at the bf16 tensor-core rate.
    b, s, _ = STEM_CASES[0]
    ch, ph = grey_stem.stem_geometry(s)
    cn = 2 * ph + 1  # conv rows and columns the 3x3/2 pool reads
    w, bias, bn = stem_params(SEED)
    consts, _ = stem_consts(w, bias, bn, s, torch.bfloat16, dev)
    b0 = consts.centring_map()  # for the plain version and the earlier design only
    g = grey_canvases(b, s, SEED, dev)
    param_bytes = 2 * 49 * 64 * 4 + 3 * 64 * 4 + ch * 7 * 4
    io_bytes = b * s * s + b * ph * ph * 64 * 2

    def earlier_stem():
        out = torch.empty((b, ph, ph, 64), dtype=torch.bfloat16, device=dev)
        earlier["grey_stem"].launch(ptr(g), ptr(consts.k7), ptr(b0), ptr(consts.scale), ptr(out),
                                    b, s, 1)
        return out

    earlier_err = float((earlier_stem().float()
                         - grey_stem.grey_stem_cuda(g, consts, torch.bfloat16).float()).abs().max())
    line["grey_stem"] = {
        "name": "grey_stem", "route": "cuda", "source": "radnet_torch/csrc/grey_stem.cu",
        "replaces": "radnet_tpu/ops/pallas_stem.py:54",
        **timed(lambda: grey_stem.grey_stem_cuda(g, consts, torch.bfloat16), "grey_stem_kernel",
                lambda: grey_stem.grey_stem_plain(g, consts.k7, b0, consts.scale, torch.bfloat16),
                io_bytes + param_bytes, 2.0 * 49 * b * cn * cn * 64, [b, s],
                ops_per_s=BF16_OPS_PER_S),
        "library_ms": None, "max_abs_err": errs["grey_stem"],
        "earlier_ms": device_ms(earlier_stem, "grey_stem_kernel"),
        "earlier_design": ("float32 products on the CUDA cores, full float32 centring map "
                           "(radnet_torch/csrc/earlier/grey_stem_scalar.cu)"),
        "earlier_max_abs_diff": earlier_err,
    }
    trunk16 = stem_trunk(w, bias, bn, torch.bfloat16, dev)
    canv3 = g[..., None].expand(b, s, s, 3).contiguous()
    with torch.inference_mode():
        line["grey_stem"]["replaced_three_channel_stem_ms"] = time_cuda(
            lambda: trunk16.stem(preprocess_on_device(canv3)))
    line["grey_stem"]["replaced_three_channel_stem"] = (
        "centring + pad + cuDNN conv2d + BN + ReLU + max_pool2d on (12, 608, 608, 3) uint8, "
        "CUDA-event median")
    del g, canv3, trunk16, b0
    emit({"phase": "timings", "kernels": list(line.values())})
    return line


class Stamped(io.StringIO):
    """Keeps the time of every line written; forwards to ``echo``."""

    def __init__(self, echo=None):
        super().__init__()
        self.stamps = []
        self.echo = echo

    def write(self, s):
        self.stamps += [time.perf_counter()] * s.count("\n")
        if self.echo is not None:
            self.echo.write(s)
        return super().write(s)


def nms_round_counts() -> dict:
    """The NMS calls since the last reset and their Jacobi rounds, read from
    the round counts the kernel left on the card, after a synchronise:
    ``nms_rounds`` sums the largest count of each call (the rounds a batched
    host loop would have run), ``nms_set_rounds`` every set's own count."""
    import torch

    from radnet_torch.ops import nms

    torch.cuda.synchronize()
    calls, recent = nms.NMS_STATS["calls"], [r.cpu() for r in nms.RECENT_ROUNDS]
    check(len(recent) == calls, f"{calls} NMS calls but {len(recent)} round counts kept")
    return {"nms_calls": calls, "nms_rounds": sum(int(r.max()) for r in recent if len(r)),
            "nms_set_rounds": sum(int(r.sum()) for r in recent)}


def launch_counts(kernels=None) -> dict:
    from radnet_torch.ops import cuda_kernels

    return {k.name: k.launches for k in (kernels or cuda_kernels.KERNELS)}


def serve_phase(tmp, cfg, device, kind, smi):
    """Phase 7: the main path through radnet_torch.cli.serve.  Returns the
    served RADNet reloaded from its model dir, the prescaled first panel and
    its window origins, and the launch counts of the run."""
    import torch

    from radnet_torch.cli import serve
    from radnet_torch.data.png import decode_png, write_png
    from radnet_torch.data.tiling import plan_tiles
    from radnet_torch.inference import RADNet, load_radnet, save_radnet
    from radnet_torch.models.detector import build_model, init_weights
    from radnet_torch.ops import cuda_kernels, nms

    gen = torch.Generator().manual_seed(SEED)
    model = init_weights(build_model(cfg), gen)
    radnet = RADNet(cfg, model, device=device)
    panels = [synthetic_grey_panel(SEED + k) for k in range(N_PANELS)]
    panel3 = bgr(panels[0])
    small, scale, sw, sh = radnet._prescale_panel(panel3)
    tiles = plan_tiles(PANEL_HW[1], PANEL_HW[0], cfg.tile_size, cfg.tile_overlap)
    origins = np.round(tiles[:, :2] * scale).astype(np.int64)
    calib = radnet._window_canvases(small, origins[:2])
    calibrate_heads(radnet, calib, gen)

    save_radnet(os.path.join(tmp, "models", "smoke"), cfg, radnet.model)
    paths = []
    t0 = time.perf_counter()
    for k, img in enumerate(panels):
        path = os.path.join(tmp, f"panel{k}.png")
        write_png(path, img)
        paths.append(path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    decode_png(open(paths[0], "rb").read())
    decode_s = time.perf_counter() - t0

    cuda_kernels.reset_launch_counts()
    nms.NMS_STATS.update(calls=0)
    nms.RECENT_ROUNDS.clear()
    out, err = Stamped(), Stamped(echo=sys.stderr)
    t0 = time.perf_counter()
    real_stderr, sys.stderr = sys.stderr, err
    try:
        rc = serve.main(
            ["--models-path", os.path.join(tmp, "models"), "--model-name", "smoke",
             "--warmup-size", str(cfg.tile_size), "--device", str(device)],
            stdin=io.StringIO("\n".join(paths) + "\n"), stdout=out,
        )
    finally:
        sys.stderr = real_stderr
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = launch_counts(cuda_kernels.SERVING_KERNELS)
    nms_rounds = nms_round_counts()
    check(rc == 0, f"serve exited {rc}")
    recs = [json.loads(line) for line in out.getvalue().splitlines()]
    check([r.get("path") for r in recs] == paths, f"serve output out of order: {recs}")
    for rec in recs:
        check("detections" in rec and len(rec["detections"]) > 0,
              f"no detections for {rec.get('path')}: {rec}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched on the main path")
    t_ready = next(t for t, line in zip(err.stamps, err.getvalue().splitlines())
                   if line == "READY")
    results_s = [t - t_ready for t in out.stamps]
    emit({"phase": "serve", "kind": kind, "nvidia_smi": smi, "panels": len(recs),
          "tiles_per_panel": len(tiles), "batches_per_panel": len(radnet._batch_schedule(len(tiles))),
          "detections": [len(r["detections"]) for r in recs],
          "sec_field": [r["sec"] for r in recs],
          "panels_per_s": len(recs) / results_s[-1],
          "result_s_after_ready": results_s, "serve_wall_s": serve_s,
          "launches": launches, **nms_rounds,
          "png_write_s": write_s / N_PANELS, "png_decode_filter0_s": decode_s})
    net = load_radnet(os.path.join(tmp, "models", "smoke"), device=device)
    return net, panel3, small, origins, launches


def stages_phase(net, panel3, small, origins, kind, smi):
    """Per-stage times of one 12-tile grey batch, with the trunk split into
    the grey stem and stages 2-4; per-batch launch counts."""
    import torch

    from radnet_torch.data.png import decode_png
    from radnet_torch.ops import cuda_kernels, nms
    from radnet_torch.ops.grey_stem import grey_stem, stem_geometry

    cfg, dev = net.C, net.device
    images = net._window_canvases(small, origins[: cfg.infer_tile_batch])
    check(images.dim() == 3, f"grey panel canvases are {tuple(images.shape)}, not (T, S, S)")
    valid_wh = torch.full((len(images), 2), float(cfg.img_size), device=dev)
    names = ["stem", "stages_2_4", "rpn_proposals", "roi_pool_head", "class_nms"]

    def stages():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        with torch.inference_mode():
            ev[0].record()
            pooled = grey_stem(images, net._grey_consts, out_dtype=net.model.dtype)
            ev[1].record()
            fmap = net.model.trunk.stages(pooled.permute(0, 3, 1, 2))
            ev[2].record()
            props = net._proposals(fmap, valid_wh)
            ev[3].record()
            head = net._head(fmap, props)
            ev[4].record()
            net._detections(*head)
            ev[5].record()
        ev[-1].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))]

    stages()
    runs = [stages() for _ in range(5)]
    stage_ms = {k: statistics.median(r[i] for r in runs) for i, k in enumerate(names)}
    stage_ms["trunk"] = stage_ms["stem"] + stage_ms["stages_2_4"]
    batch_ms = time_cuda(lambda: net._predict_tiles_impl(images, valid_wh), iters=5, warmup=1)
    # The same batch through the 3-channel stem, in turns with the grey one.
    images3 = images[..., None].expand(*images.shape, 3).contiguous()
    ab = {"grey_stem": [], "three_channel_stem": []}
    for name in ("grey_stem", "three_channel_stem", "three_channel_stem", "grey_stem"):
        canv = images if name == "grey_stem" else images3
        ab[name].append(time_cuda(lambda: net._predict_tiles_impl(canv, valid_wh), iters=5, warmup=1))
    saved = launch_counts()
    cuda_kernels.reset_launch_counts()
    nms.NMS_STATS.update(calls=0)
    nms.RECENT_ROUNDS.clear()
    with count_flops(net.model) as flops:
        net._predict_tiles_impl(images, valid_wh)
    per_batch = launch_counts(cuda_kernels.SERVING_KERNELS)
    rounds_per_batch = nms_round_counts()
    for k in cuda_kernels.KERNELS:  # the main path's counts stay the reported ones
        k.launches = saved[k.name]
    ch, _ = stem_geometry(cfg.canvas_size)
    flops["stem"] = 2 * 49 * len(images) * ch * ch * 64
    prescale_ms = time_cuda(lambda: net._prescale_panel(panel3), iters=5, warmup=1)
    panel_wall_ms, panel_busy_ms = device_busy(lambda: net.predict([panel3]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net._grey_channel(panel3)
    t1 = time.perf_counter()
    pending = net.predict_dispatch([panel3])
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    net.predict_collect(pending)
    t4 = time.perf_counter()
    # "dispatch" is the host's time to queue the panel; the card is still
    # busy after it returns until "dispatch_until_card_done".
    host_ms = {"grey_check": (t1 - t0) * 1e3, "dispatch": (t2 - t1) * 1e3,
               "dispatch_until_card_done": (t3 - t1) * 1e3, "collect": (t4 - t3) * 1e3}
    paeth = paeth_png(1000, 1000)
    t0 = time.perf_counter()
    decode_png(paeth)
    paeth_s = time.perf_counter() - t0
    emit({"phase": "stages", "kind": kind, "nvidia_smi": smi, "batch_tiles": len(images),
          "stage_ms": stage_ms, "batch_ms": batch_ms, "batch_ms_by_stem": ab,
          "launches_per_batch": per_batch,
          "tflop_per_batch": {k: v / 1e12 for k, v in flops.items()},
          "tflop_per_s": {"stem": flops["stem"] / stage_ms["stem"] / 1e9,
                          "stages_2_4": flops["trunk"] / stage_ms["stages_2_4"] / 1e9,
                          "head": flops["head"] / stage_ms["roi_pool_head"] / 1e9},
          "nms_per_batch": rounds_per_batch, "prescale_panel_ms": prescale_ms,
          "panel_predict_ms": panel_wall_ms, "panel_device_busy_ms": panel_busy_ms,
          "panel_device_idle_share": 1.0 - panel_busy_ms / panel_wall_ms,
          "panel_host_ms": host_ms,
          "png_decode_paeth_1000x1000_s": paeth_s})
    return images, per_batch


def sync_free_phase(net, images, panel3, phase: str = "sync_free"):
    """One 12-tile batch of the cascade, then one panel's predict_dispatch,
    under torch.cuda.set_sync_debug_mode("error"): any operation that waits
    for the card raises.  Each runs once before, so first-use constants
    (kernel libraries, cached plans, pinned buffers) are built."""
    import torch

    valid_wh = torch.full((len(images), 2), float(net.C.img_size), device=net.device)
    net._predict_tiles_impl(images, valid_wh)
    net.predict_collect(net.predict_dispatch([panel3]))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        out = net._predict_tiles_impl(images, valid_wh)
        t1 = time.perf_counter()
        pending = net.predict_dispatch([panel3])
        t2 = time.perf_counter()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    dets = net.predict_collect(pending)
    emit({"phase": phase, "batch_queue_ms": (t1 - t0) * 1e3,
          "panel_dispatch_queue_ms": (t2 - t1) * 1e3, "card_done_after_ms": (t3 - t0) * 1e3,
          "batch_detections": int(out[2].sum()), "panel_detections": len(dets)})
    check(len(dets) > 0, "the panel dispatched under the sync check found nothing")


def predict_phase(tmp, net, kind, smi):
    """Phase 8: radnet_torch.cli.predict on a scan directory at the full
    config, then one panel down each other path of RADNet.predict."""
    import torch

    from radnet_torch.cli import predict
    from radnet_torch.data.png import read_png, write_png
    from radnet_torch.inference import RADNet
    from radnet_torch.ops import cuda_kernels

    cfg = net.C
    scan = os.path.join(tmp, "scan")
    for k, img_type in enumerate(cfg.img_types + ["blended_map_grey"]):
        path = predict.resolve_type_path(scan, img_type)
        path.parent.mkdir(parents=True, exist_ok=True)
        write_png(str(path), synthetic_grey_panel(SEED + 10 + k))
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = predict.main(["--models-path", os.path.join(tmp, "models"), "--model-name", "smoke",
                           "--scan-data-path", scan, "--device", str(net.device)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts(cuda_kernels.SERVING_KERNELS)
    check(rc == 0, f"predict exited {rc}")
    with open(os.path.join(scan, "arrays", "predictions.json")) as f:
        preds = json.load(f)
    pngs = {}
    for name in ("all", "boat", "human", "other"):
        out = os.path.join(scan, "img", "predictions", f"{name}_predictions.png")
        check(os.path.isfile(out), f"predict wrote no {out}")
        pngs[name] = list(read_png(out).shape)
    emit({"phase": "predict_cli", "kind": kind, "nvidia_smi": smi, "img_types": cfg.img_types,
          "panel_hw": list(PANEL_HW), "detections": len(preds), "wall_s": wall_s,
          "launches": launches, "prediction_pngs": pngs})
    check(len(preds) > 0, "predict wrote no detections")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched by the predict CLI")

    # Panels smaller than a tile (1100 x 1500 and 1800 x 1800 at the
    # default 2000-px tile) take the host paths.
    ts, cs = cfg.tile_size, cfg.canvas_size
    cases = [
        ("host tiles, shortest-side canvas", {},
         bgr(synthetic_grey_panel(SEED + 20, (ts * 11 // 20, ts * 3 // 4))),
         lambda shapes: all(len(s) == 4 and s[1:] == [cs, 2 * cs, 3] for s in shapes)),
        ("host tiles, square canvas", {}, synthetic_colour_panel(SEED + 21, (ts * 9 // 10,) * 2),
         lambda shapes: all(s[1:] == [cs, cs, 3] for s in shapes)),
        ("full-resolution device tiling", {"infer_panel_prescale": False},
         synthetic_colour_panel(SEED + 22, PANEL_HW),
         lambda shapes: all(s[1:] == [cs, cs, 3] for s in shapes)),
        ("include_full_img", {"include_full_img": True}, bgr(synthetic_grey_panel(SEED + 23)),
         lambda shapes: len(shapes[-1]) == 4 and all(len(s) == 3 for s in shapes[:-1])),
    ]
    for name, overrides, img, shapes_ok in cases:
        r = RADNet(dataclasses.replace(cfg, **overrides), net.model, device=net.device)
        shapes = []
        features = r._features

        def recording(images, features=features, shapes=shapes):
            shapes.append(list(images.shape))
            return features(images)

        r._features = recording
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = r.predict([img])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        emit({"phase": "predict_path", "path": name, "panel_shape": list(img.shape),
              "overrides": overrides, "batch_shapes": shapes, "detections": len(dets),
              "wall_s": wall_s})
        check(shapes and shapes_ok(shapes), f"{name}: unexpected batch shapes {shapes}")
        check(len(dets) > 0, f"{name}: no detections")


def card_vs_cpu_phase(net, images, dev, kinds=("grey", "three_channel"), phase="card_vs_cpu"):
    """Phase 9: one 2-tile float32 batch on the card and on the CPU, grey
    (through the grey stem on ResNet50) and as 3 channels."""
    import torch

    from radnet_torch.inference import RADNet
    from radnet_torch.models.detector import build_model

    cfg32 = dataclasses.replace(net.C, compute_dtype="float32")
    state = {k: v.detach().cpu() for k, v in net.model.state_dict().items()}
    m_gpu = build_model(cfg32)
    m_gpu.load_state_dict(state)
    m_cpu = copy.deepcopy(m_gpu)
    gpu = RADNet(cfg32, m_gpu, device=dev)
    cpu = RADNet(cfg32, m_cpu, device="cpu")
    torch.set_num_threads(os.cpu_count() or 1)
    grey = images[2:4]
    wh = torch.full((2, 2), float(cfg32.img_size))
    for name, canv in (("grey", grey), ("three_channel", grey[..., None].expand(2, *grey.shape[1:], 3))):
        if name not in kinds:
            continue
        canv = canv.contiguous()
        t0 = time.perf_counter()
        got = [t.cpu().numpy() for t in gpu._predict_tiles_impl(canv, wh.to(dev))]
        want = [t.numpy() for t in cpu._predict_tiles_impl(canv.cpu(), wh)]
        cmp_s = time.perf_counter() - t0
        n_g, n_w, unmatched = int(got[2].sum()), int(want[2].sum()), 0
        for t in range(2):
            for k in range(cfg32.n_classes - 1):
                g = [(tuple(b), s) for b, s in zip(got[0][t, k][got[2][t, k]], got[1][t, k][got[2][t, k]])]
                w = [(tuple(b), s) for b, s in zip(want[0][t, k][want[2][t, k]], want[1][t, k][want[2][t, k]])]
                for box, s in g:
                    hit = next((j for j, (bw, sw_) in enumerate(w) if bw == box and abs(s - sw_) <= 1e-3), None)
                    if hit is None:
                        unmatched += 1
                    else:
                        w.pop(hit)
                unmatched += len(w)
        pooled = n_g + n_w
        emit({"phase": phase, "network": cfg32.network, "canvases": name, "dtype": "float32", "tf32": False,
              "tiles": 2, "detections_card": n_g, "detections_cpu": n_w,
              "unmatched": unmatched, "seconds": cmp_s})
        check(pooled > 0, f"float32 {name} comparison has no detections")
        check(unmatched <= 0.05 * pooled, f"{name}: {unmatched} of {pooled} detections unmatched card vs CPU")


# --------------------------------------------------------------------------- #
# Training: the backward kernel, the CLIs, per-step numbers, learning.
# --------------------------------------------------------------------------- #
TRAIN_PANEL = 2400
# The evaluate phase's test set: the two validation panels and fresh ones.
N_TEST_PANELS = 12
FG_CLASSES = ["boat", "human", "other", "animal", "circle", "wheel"]
# (B, R) of the backward checks: the train step's RoI sample, the cascade's.
BACKWARD_CASES = [(8, 20), (12, 300)]


def roi_backward_inputs(dtype, seed, device, b, r, kind, hw=38, c=1024):
    """A pooled-cell gradient and RoIs, random or at the edges (tile 0 of the
    edge set: near the whole map; 1: single pixels; 2: zero sizes; 3: one
    RoI repeated, so every cell's taps collide)."""
    import torch

    _, rois = roi_inputs(dtype, seed, device, b=b, hw=hw, c=8, r=r)
    if kind == "edges":
        _, edge = roi_edge_inputs(dtype, seed, device, hw=hw, c=8, r=r)
        rois = edge.repeat((b + 3) // 4, 1, 1)[:b].contiguous()
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn((b, r, 7, 7, c), generator=gen, device=device)
    return g.to(dtype), rois


def roi_backward_checks(dev, earlier: dict) -> float:
    """Phase kernel2_backward: csrc/roi_pool_backward.cu against
    roi_pool_backward_plain, bit-equal across two launches, beside the
    earlier atomic kernel (its error; both timed at bf16, stride 2), and
    gradcheck of the plain pool in float64.  Returns the largest error at
    the train step's shape, bf16."""
    import torch

    from radnet_torch.ops import roi_align

    err_main = 0.0
    for b, r in BACKWARD_CASES:
        for kind, seed in (("random", 2), ("edges", 3)):
            for dtype in (torch.bfloat16, torch.float32):
                g, rois = roi_backward_inputs(dtype, SEED + seed, dev, b, r, kind)
                for stride in (2, 1):
                    kw = {"pool_size": 7, "center_stride": stride}
                    got = roi_align.roi_pool_backward_cuda(g, rois, (38, 38), **kw)
                    again = roi_align.roi_pool_backward_cuda(g, rois, (38, 38), **kw)
                    ref = roi_align.roi_pool_backward_plain(g.float(), rois, (38, 38), **kw)
                    sums = earlier_roi_backward(earlier["roi_pool_backward"], g, rois, (38, 38), **kw)
                    sums_again = earlier_roi_backward(earlier["roi_pool_backward"], g, rois, (38, 38),
                                                      **kw)
                    torch.cuda.synchronize()
                    deterministic = bool(torch.equal(got, again))
                    ok, err, top, tol = roi_backward_error(got, ref)
                    _, err_earlier, _, _ = roi_backward_error(sums.to(dtype), ref)
                    if (b, r, kind, dtype, stride) == (8, 20, "random", torch.bfloat16, 2):
                        err_main = err
                    line = {"phase": "kernel2_backward", "shape": [b, 38, 38, 1024, r, 7],
                            "rois": kind, "dtype": str(dtype), "center_stride": stride,
                            "max_abs_err": err, "largest": top, "tolerance": tol,
                            "deterministic": deterministic, "earlier_max_abs_err": err_earlier,
                            "earlier_deterministic_float32_sums": bool(torch.equal(sums, sums_again))}
                    if dtype == torch.bfloat16 and stride == 2:
                        line["ms"] = device_ms(
                            lambda: roi_align.roi_pool_backward_cuda(g, rois, (38, 38), **kw),
                            "roi_pool_backward_kernel", iters=10)
                        line["earlier_ms"] = device_ms(
                            lambda: earlier_roi_backward(earlier["roi_pool_backward"], g, rois,
                                                         (38, 38), **kw),
                            "roi_pool_backward_atomic_kernel", iters=10)
                    emit(line)
                    check(ok, f"roi_pool_backward disagrees with its plain version "
                              f"({b}, {r}, {kind}, {dtype}, stride {stride})")
                    check(deterministic, f"roi_pool_backward gave two results on the same inputs "
                                         f"({b}, {r}, {kind}, {dtype}, stride {stride})")
                    del got, again, ref, sums, sums_again
    fm = torch.randn(2, 6, 6, 3, dtype=torch.float64, device=dev, requires_grad=True)
    rois = torch.tensor([[[0, 0, 6, 6], [1, 2, 3, 1], [5, 5, 0, 0]],
                         [[2, 1, 4, 4], [0, 3, 6, 2], [1, 1, 1, 1]]], dtype=torch.float32, device=dev)
    ok = torch.autograd.gradcheck(
        lambda x: roi_align.roi_pool_plain(x, rois, pool_size=3, center_stride=2), (fm,),
        eps=1e-6, atol=1e-7)
    emit({"phase": "kernel2_backward_gradcheck", "dtype": "float64", "rois": 6, "ok": bool(ok)})
    check(ok, "gradcheck of roi_pool_plain failed")
    return err_main


def synthetic_training_panel(seed: int, n_figures: int = 7):
    """A 2400 x 2400 grey panel of dark rock with filled figures of 300-1200
    px (90-360 px at the 0.3 tile scale, where the 64-512 anchors are), and
    their boxes, one class each in turn."""
    rng = np.random.default_rng(seed)
    s = TRAIN_PANEL
    img = rng.integers(20, 60, (s // 4, s // 4), dtype=np.uint8)
    img = np.repeat(np.repeat(img, 4, axis=0), 4, axis=1)
    yy, xx = np.mgrid[0:s, 0:s]
    boxes = []
    for k in range(n_figures):
        bw, bh = rng.integers(300, 1200, 2)
        x, y = int(rng.integers(0, s - bw)), int(rng.integers(0, s - bh))
        level = int(rng.integers(110, 250))
        if k % 2:  # an ellipse filling its box
            inside = (((xx[y:y + bh, x:x + bw] - x - bw / 2) / (bw / 2)) ** 2
                      + ((yy[y:y + bh, x:x + bw] - y - bh / 2) / (bh / 2)) ** 2) <= 1.0
            img[y:y + bh, x:x + bw][inside] = level
        else:
            img[y:y + bh, x:x + bw] = level
        boxes.append((x, y, x + int(bw), y + int(bh), FG_CLASSES[(seed + k) % len(FG_CLASSES)]))
    return img, boxes


def write_split(root: str, split: str, seeds) -> None:
    """data/<split>/<img type>/panel<k>.png, one synthetic panel a seed, and
    data/<split>.csv."""
    import csv

    from radnet_torch.data.png import write_png

    folder = os.path.join(root, "data", split, "enhanced_topo_grey")
    os.makedirs(folder, exist_ok=True)
    rows = []
    for k, seed in enumerate(seeds):
        img, boxes = synthetic_training_panel(seed)
        write_png(os.path.join(folder, f"panel{k}.png"), img)
        rows += [[f"panel{k}.png", cls, x1, y1, x2, y2] for x1, y1, x2, y2, cls in boxes]
    with open(os.path.join(root, "data", f"{split}.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["img_path", "label", "xmin", "ymin", "xmax", "ymax"])
        w.writerows(rows)


def write_training_set(root: str, n_train: int = 4, n_val: int = 2) -> None:
    """data/{train,val}/<img type>/panel*.png and data/{train,val}.csv."""
    write_split(root, "train", [SEED + 100 + k for k in range(n_train)])
    write_split(root, "val", [SEED + 200 + k for k in range(n_val)])


# cli.train's arguments past the data, the model dir it writes, steps an
# epoch of cli.train (2 epochs) and of cli.cont_train (1 epoch), per backbone.
TRAIN_RUNS = {
    "resnet50": (["--model-name", "smoke", "--allow-random-init"], "faster_rcnn_resnet50_smoke", 8, 8),
    "vgg16": (["--network", "vgg16", "--train-schedule", "alternating", "--model-name", "alt"],
              "faster_rcnn_vgg16_alt", 8, 4),
}


def training_cli_args(tmp: str, dev) -> list:
    """The training CLIs' device, model and data arguments on the training
    set under ``tmp``."""
    d = os.path.join(tmp, "data")
    return ["--device", str(dev), "--models-path", os.path.join(tmp, "train_models"),
            "--train-annot", os.path.join(d, "train.csv"), "--train-data", os.path.join(d, "train"),
            "--val-annot", os.path.join(d, "val.csv"), "--val-data", os.path.join(d, "val")]


@contextlib.contextmanager
def counting_steps():
    """Counts the train steps and validation batches fit drives, and stamps
    each train step's start (``train_step_t``): the CLIs import the step
    factories when they run, so the factories are wrapped."""
    from radnet_torch.engine import steps as engine_steps

    calls = {"train_step": 0, "eval_step": 0, "train_step_t": []}
    factories = {"make_train_step": "train_step", "make_alternating_train_step": "train_step",
                 "make_eval_step": "eval_step"}
    real = {f: getattr(engine_steps, f) for f in factories}

    def counting(make, key):
        def made(*args, **kwargs):
            fn = make(*args, **kwargs)

            def step(*a, **kw):
                calls[key] += 1
                if key == "train_step":
                    calls["train_step_t"].append(time.perf_counter())
                return fn(*a, **kw)
            return step
        return made

    for f, key in factories.items():
        setattr(engine_steps, f, counting(real[f], key))
    try:
        yield calls
    finally:
        for f in factories:
            setattr(engine_steps, f, real[f])


def train_phase(tmp: str, dev, smi, network: str = "resnet50", phase: str = "train") -> dict:
    """Phase train: radnet_torch.cli.train (2 epochs, with validation) and
    cli.cont_train (1 epoch, trunk trainable) at the default config
    (ResNet50: the joint step; VGG16: the alternating schedule, from random
    init), then load_radnet on the directory they wrote.  Writes the six
    training panels unless they exist."""
    import csv

    import torch

    from radnet_torch.cli import cont_train, train
    from radnet_torch.data.png import read_png
    from radnet_torch.inference import load_radnet
    from radnet_torch.ops import cuda_kernels, nms

    argv, name, epoch_len, cont_len = TRAIN_RUNS[network]
    d = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    if not os.path.isfile(os.path.join(d, "train.csv")):
        write_training_set(tmp)
    write_s = time.perf_counter() - t0
    common = training_cli_args(tmp, dev)
    out = {}
    model_dir = os.path.join(tmp, "train_models", name)
    dashboard = os.path.join(model_dir, "dashboard.html")
    for run, fn, run_argv, steps, epochs in (
            ("train", train.main, argv + ["--epoch-length", str(epoch_len), "--n-epochs", "2"],
             2 * epoch_len, 2),
            ("cont_train", cont_train.main, ["--model-name", name, "--epoch-length", str(cont_len),
                                             "--n-epochs", "1"], cont_len, 1)):
        if os.path.exists(dashboard):  # each run renders its own
            os.remove(dashboard)
        cuda_kernels.reset_launch_counts()
        nms.NMS_STATS.update(calls=0)
        t0 = time.perf_counter()
        with counting_steps() as calls, contextlib.redirect_stdout(sys.stderr):
            rc = fn(common + run_argv)
        torch.cuda.synchronize()
        out[run] = {"wall_s": time.perf_counter() - t0, "steps": steps, "epochs": epochs, "rc": rc,
                    "launches": launch_counts(), "nms_calls": nms.NMS_STATS["calls"],
                    "train_steps_run": calls["train_step"], "val_batches_run": calls["eval_step"],
                    "dashboard": os.path.isfile(dashboard)}
        check(rc == 0, f"{phase}: {run} exited {rc}")
        check(out[run]["dashboard"], f"{phase}: {run} wrote no {dashboard}")
    with open(os.path.join(model_dir, "record.csv"), newline="") as f:
        record = list(csv.DictReader(f))
    files = {n: os.path.exists(os.path.join(model_dir, n))
             for n in ("ckpt_best/train_state.pt", "ckpt_last/train_state.pt", "model.pt",
                       "config.json", "metrics.jsonl")}
    opt = torch.load(os.path.join(model_dir, "ckpt_last", "train_state.pt"),
                     weights_only=True)["optimizer"]
    adam_counts = {k: int(v["count"]) for k, v in opt.items()} if "rpn" in opt else None
    net = load_radnet(model_dir, device=dev)
    panel = read_png(os.path.join(d, "val", "enhanced_topo_grey", "panel0.png"))
    dets = net.predict([panel])
    emit({"phase": phase, "network": network, "nvidia_smi": smi, "panel": TRAIN_PANEL,
          "write_s": write_s, **out, "record_rows": len(record),
          "record_total_loss": [r["total_loss"] for r in record],
          "record_val_total_loss": [r["val_total_loss"] for r in record],
          "files": files, "alternating_adam_counts": adam_counts, "predict_detections": len(dets)})
    check(len(record) == 3, f"{phase}: record.csv has {len(record)} rows, not 3")
    check(all(files.values()), f"{phase}: missing outputs: {files}")
    if network == "vgg16":  # the alternating checkpoint: both Adam states
        check(adam_counts is not None and adam_counts["rpn"] == cont_len
              and adam_counts["det"] <= cont_len, f"{phase}: checkpoint Adam counts {adam_counts}")
    for run in ("train", "cont_train"):
        o, launches = out[run], out[run]["launches"]
        val = o["val_batches_run"]
        check(o["train_steps_run"] == o["steps"],
              f"{phase}: {run}: fit ran {o['train_steps_run']} train steps, not {o['steps']}")
        check(val >= o["epochs"] and val % o["epochs"] == 0,
              f"{phase}: {run}: {val} validation batches over {o['epochs']} epochs")
        # Exactly one proposal NMS and one RoI-pool forward a step, train or eval.
        want = o["steps"] + val
        check(o["nms_calls"] == want and launches["nms_fused"] == want,
              f"{phase}: {run}: {o['nms_calls']} NMS calls, {launches['nms_fused']} launches for "
              f"{o['steps']} steps + {val} validation batches")
        check(launches["roi_pool"] == want and launches["grey_stem"] == 0,
              f"{phase}: {run}: launches {launches} for {o['steps']} steps + {val} validation batches")
    check(out["train"]["launches"]["roi_pool_backward"] == 0,
          f"{phase}: the frozen-trunk run launched the backward kernel")
    check(out["cont_train"]["launches"]["roi_pool_backward"] == cont_len,
          f"{phase}: cont_train launched the backward kernel "
          f"{out['cont_train']['launches']['roi_pool_backward']} times in {cont_len} steps")
    return out


# --------------------------------------------------------------------------- #
# Pretrained backbone weights: cli.train from a converted Keras file and from a
# torchvision dict, at full width.
# --------------------------------------------------------------------------- #
def keras_backbone_layers(network: str, seed: int) -> dict:
    """Seeded arrays at every Keras layer name of ``network``'s backbone, as
    ``scripts/h5_to_torch.py`` reads them from an ``.h5``: conv kernels HWIO
    at lecun-normal scale and small biases; batch norm gamma in [0.5, 1.5),
    small beta and mean, variance in [0.5, 2) (so the eps matters)."""
    import torch

    from radnet_torch.models import weights
    from radnet_torch.models.bridge import _name
    from radnet_torch.models.detector import FasterRCNN

    with torch.device("meta"):
        model = FasterRCNN(network, n_classes=7, num_anchors=9)
    rng = np.random.default_rng(seed)
    layers = {}
    for keras_name, path, kind in weights._name_map(network):
        mod = model.get_submodule(_name(path))
        if kind == "conv":
            o, i, h, w = mod.weight.shape
            kernel = rng.standard_normal((h, w, i, o), dtype=np.float32) / np.float32(math.sqrt(h * w * i))
            layers[keras_name] = [(f"{keras_name}/kernel:0", kernel),
                                  (f"{keras_name}/bias:0", rng.normal(0, 0.01, o).astype(np.float32))]
        else:
            c = mod.gamma.shape[0]
            layers[keras_name] = list(zip(
                [f"{keras_name}/{n}:0" for n in ("gamma", "beta", "moving_mean", "moving_variance")],
                [rng.uniform(0.5, 1.5, c).astype(np.float32), rng.normal(0, 0.05, c).astype(np.float32),
                 rng.normal(0, 0.05, c).astype(np.float32), rng.uniform(0.5, 2.0, c).astype(np.float32)]))
    return layers


def torchvision_resnet50_dict(seed: int, var_range: tuple[float, float] = (0.5, 2.0)) -> dict:
    """A seeded state_dict of torchvision's resnet50 layout at full width
    (its fc layer included, which the port does not load); every batch
    norm's running variance is uniform in ``var_range``."""
    import torch

    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, out_c, in_c, k):
        sd[name + ".weight"] = torch.from_numpy(
            rng.standard_normal((out_c, in_c, k, k), dtype=np.float32) / np.float32(math.sqrt(in_c * k * k)))

    def bn(name, c):
        for f, (lo, hi) in (("weight", (0.5, 1.5)), ("bias", (-0.05, 0.05)), ("running_mean", (-0.05, 0.05)),
                            ("running_var", var_range)):
            sd[f"{name}.{f}"] = torch.from_numpy(rng.uniform(lo, hi, c).astype(np.float32))
        sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    for layer, blocks, mid, out in ((1, 3, 64, 256), (2, 4, 128, 512), (3, 6, 256, 1024), (4, 3, 512, 2048)):
        in_c = {1: 64, 2: 256, 3: 512, 4: 1024}[layer]
        for i in range(blocks):
            src, c_in = f"layer{layer}.{i}", in_c if i == 0 else out
            for j, (ci, co, k) in enumerate(((c_in, mid, 1), (mid, mid, 3), (mid, out, 1)), start=1):
                conv(f"{src}.conv{j}", co, ci, k)
                bn(f"{src}.bn{j}", co)
            if i == 0:
                conv(f"{src}.downsample.0", out, c_in, 1)
                bn(f"{src}.downsample.1", out)
    sd["fc.weight"] = torch.from_numpy(rng.normal(0, 0.01, (1000, 2048)).astype(np.float32))
    sd["fc.bias"] = torch.zeros(1000)
    return sd


# JAX's apply_pretrained_weights refusal at the default Config, word for word.
PRETRAINED_REFUSAL = (
    "base_net_weights='imagenet' is set but no weight file was found (looked at --weights and the "
    "conventional locations; see models/weights.py). resnet50 with FrozenBatchNorm is NOT trainable "
    "from random init; provide --weights or pass --allow-random-init.")
# The arms of pretrained_train: the weight file, cli.train's arguments past
# the data and the file, epochs, steps an epoch, validation.
PRETRAINED_RUNS = {
    "resnet50_keras": ("keras", "resnet50", ["--model-name", "pre_keras"], 2, 8, True),
    "resnet50_torchvision": ("torchvision", "resnet50", ["--model-name", "pre_tv"], 1, 2, False),
    "vgg16_keras": ("keras", "vgg16", ["--network", "vgg16", "--train-schedule", "alternating",
                                       "--model-name", "pre_vgg"], 1, 4, False),
}


def pretrained_train_phase(tmp: str, dev, smi) -> dict:
    """Phase pretrained_train: radnet_torch.cli.train at the default Config
    (base_net_weights="imagenet", bf16, batch 8) with --weights and no
    --allow-random-init, on the training set under ``tmp``: ResNet50 from a
    converted Keras file (2 epochs of 8 steps, validation), from a
    torchvision dict (2 steps), and VGG16 with the alternating schedule
    from a converted file (4 steps).  Each run prints the "Loaded
    pretrained" line; every loaded tensor that does not train (the frozen
    trunk, every batch norm) reaches model.pt bit-equal to the host's
    mapping of the file, and the trained ones moved; exactly one NMS and one
    RoI forward a step or validation batch, no grey stem, no backward; the
    losses are finite and the four loss plots drawn.  Then the run without a
    file or the flag stops with JAX's message.  Returns each run's launch
    counts."""
    import csv
    import xml.etree.ElementTree as ET

    import torch

    from radnet_torch.cli import train
    from radnet_torch.config import Config
    from radnet_torch.engine.train_state import trainability_labels
    from radnet_torch.models import weights
    from radnet_torch.models.bridge import _name
    from radnet_torch.models.detector import build_model
    from radnet_torch.ops import cuda_kernels, nms

    common = training_cli_args(tmp, dev)
    out = {}
    for arm, (source, network, argv, epochs, epoch_len, val) in PRETRAINED_RUNS.items():
        t0 = time.perf_counter()
        path = os.path.join(tmp, f"{arm}.pt")
        cfg = dataclasses.replace(Config(), network=network)
        host = build_model(cfg)  # the host's mapping of the file, to compare with
        if source == "keras":
            layers = keras_backbone_layers(network, SEED + 300)
            weights.save_keras_layers(path, layers)
            del layers
            weights.load_keras_layers(weights.read_weight_file(path)[1], host, network)
            loaded_modules = {_name(p) for _, p, _ in weights._name_map(network)}
            loaded = [k for k in host.state_dict() if k.rsplit(".", 1)[0] in loaded_modules]
        else:
            sd = torchvision_resnet50_dict(SEED + 301)
            torch.save(sd, path)
            weights.load_torchvision_resnet50(sd, host)
            loaded = [k for k in host.state_dict() if k.startswith(("trunk.", "head.s5"))
                      and not k.endswith(".bias")]  # torchvision's convs have no bias
        want = {k: host.state_dict()[k] for k in loaded}
        make_s = time.perf_counter() - t0

        load_s = []
        real_load = weights.maybe_load_pretrained

        def timed_load(*a, **k):
            t = time.perf_counter()
            try:
                return real_load(*a, **k)
            finally:
                load_s.append(time.perf_counter() - t)

        cuda_kernels.reset_launch_counts()
        nms.NMS_STATS.update(calls=0)
        run_argv = common + argv + ["--weights", path, "--n-epochs", str(epochs),
                                    "--epoch-length", str(epoch_len)] + ([] if val else ["--no-validation"])
        weights.maybe_load_pretrained = timed_load
        try:
            with counting_steps() as calls:
                rc, text, wall = run_cli(train.main, run_argv)
        finally:
            weights.maybe_load_pretrained = real_load
        launches = launch_counts()
        model_dir = os.path.join(tmp, "train_models", f"faster_rcnn_{network}_{argv[-1]}")
        trained = torch.load(os.path.join(model_dir, "model.pt"), weights_only=True)
        labels = trainability_labels(host, network, cfg.base_net_trainable)
        frozen = [k for k in loaded if labels.get(k, "frozen") == "frozen"]
        moved = [k for k in loaded if k not in frozen and not torch.equal(trained[k], want[k])]
        unequal = [k for k in frozen if not torch.equal(trained[k], want[k])]
        with open(os.path.join(model_dir, "record.csv"), newline="") as f:
            record = list(csv.DictReader(f))
        losses = [float(r[k]) for r in record for k in ("total_loss", "val_total_loss") if r[k] != ""]
        plots = {}
        for name in ("accuracy", "rpn_loss", "detector_loss", "total_loss"):
            try:
                plots[name] = ET.parse(os.path.join(model_dir, "viz", f"{name}.svg")).getroot().tag
            except (OSError, ET.ParseError) as e:
                plots[name] = repr(e)
        stamps = calls["train_step_t"]
        gaps = [1e3 * (b - a) for e in range(epochs) for a, b in
                zip(stamps[e * epoch_len: (e + 1) * epoch_len], stamps[e * epoch_len + 1: (e + 1) * epoch_len])]
        steps, val_batches = calls["train_step"], calls["eval_step"]
        line = f"Loaded pretrained base-net weights from {path}"
        out[arm] = {"source": source, "network": network, "schedule": "alternating" if "alternating" in argv
                    else "joint", "rc": rc, "wall_s": wall, "file_s": make_s, "load_s": load_s,
                    "steps": steps, "val_batches": val_batches, "step_gap_ms_median":
                    statistics.median(gaps) if gaps else None, "step_gaps_ms": gaps,
                    "launches": launches, "nms_calls": nms.NMS_STATS["calls"],
                    "loaded_tensors": len(loaded), "frozen_bit_equal": len(frozen) - len(unequal),
                    "frozen": len(frozen), "trained_moved": len(moved), "trained": len(loaded) - len(frozen),
                    "record_total_loss": losses, "plots": plots,
                    "loaded_line": line in text.getvalue(),
                    "torchvision_warning": "WARNING: loaded torchvision weights" in text.getvalue()}
        emit({"phase": "pretrained_train", "arm": arm, "nvidia_smi": smi, **out[arm]})
        check(rc == 0, f"pretrained_train: {arm} exited {rc}")
        check(out[arm]["loaded_line"], f"pretrained_train: {arm} printed no '{line}'")
        check(out[arm]["torchvision_warning"] == (source == "torchvision"),
              f"pretrained_train: {arm}: the torchvision warning {'missing' if source == 'torchvision' else 'printed'}")
        check(len(load_s) == 1, f"pretrained_train: {arm}: {len(load_s)} weight loads")
        check(not unequal, f"pretrained_train: {arm}: frozen loaded tensors changed: {unequal[:5]}")
        check(moved or len(loaded) == len(frozen),
              f"pretrained_train: {arm}: none of the {len(loaded) - len(frozen)} trained tensors moved")
        check(steps == epochs * epoch_len and (val_batches > 0) == val,
              f"pretrained_train: {arm}: {steps} steps, {val_batches} validation batches")
        want_k = steps + val_batches  # one proposal NMS and one RoI-pool forward a batch
        check(launches["nms_fused"] == want_k and out[arm]["nms_calls"] == want_k
              and launches["roi_pool"] == want_k and launches["grey_stem"] == 0
              and launches["roi_pool_backward"] == 0,
              f"pretrained_train: {arm}: launches {launches} for {steps} steps + {val_batches} batches")
        check(losses and all(math.isfinite(v) for v in losses), f"pretrained_train: {arm}: losses {losses}")
        check(all(t.endswith("svg") for t in plots.values()), f"pretrained_train: {arm}: plots {plots}")
        del host, want, trained
        os.remove(path)

    # No file and no --allow-random-init: the run stops with JAX's message.
    try:
        rc, text, _ = run_cli(train.main, common + ["--model-name", "pre_none", "--n-epochs", "1",
                                                    "--epoch-length", "1", "--no-validation"])
        refusal = f"exited {rc}"
    except SystemExit as e:
        refusal = str(e)
    emit({"phase": "pretrained_train", "arm": "refusal", "message": refusal})
    check(refusal == PRETRAINED_REFUSAL, f"pretrained_train: without a file: {refusal!r}")
    return {arm: o["launches"] for arm, o in out.items()}


# --------------------------------------------------------------------------- #
# Evaluation: cli.test, cli.test_rpn and cli.test_data on the trained model.
# --------------------------------------------------------------------------- #
def unmatched(got: list, want: list, prob_tol: float = 1e-3) -> int:
    """Detections of either list without a partner in the other: the same
    class and box, confidences within ``prob_tol``."""
    pool: dict = {}
    for d in want:
        pool.setdefault((d["class"], d["x1"], d["y1"], d["x2"], d["y2"]), []).append(d["prob"])
    missing = 0
    for d in got:
        probs = pool.get((d["class"], d["x1"], d["y1"], d["x2"], d["y2"]), [])
        j = next((j for j, p in enumerate(probs) if abs(p - d["prob"]) <= prob_tol), None)
        if j is None:
            missing += 1
        else:
            probs.pop(j)
    return missing + sum(len(v) for v in pool.values())


@contextlib.contextmanager
def counting_calls(cls, method: str, record=None):
    """Counts the calls of ``cls.method`` (``record(*args)`` is kept per call)."""
    calls = []
    real = getattr(cls, method)

    def wrapped(self, *args, **kwargs):
        calls.append(record(*args) if record else None)
        return real(self, *args, **kwargs)

    setattr(cls, method, wrapped)
    try:
        yield calls
    finally:
        setattr(cls, method, real)


def run_cli(main, argv) -> tuple[int, Stamped, float]:
    """(exit code, standard output with its line times, wall seconds) of a
    CLI run in process, its output echoed to stderr."""
    import torch

    out = Stamped(echo=sys.stderr)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    torch.cuda.synchronize()
    return rc, out, time.perf_counter() - t0


def card_and_cpu(weights: dict, cfg, dev, run) -> dict:
    """``run(net)`` on a float32 (TF32 off) RADNet of ``weights``, on the card
    and on the CPU: both results, their counts, how many of either have no
    partner in the other, and each side's seconds."""
    from radnet_torch.inference import RADNet
    from radnet_torch.models.detector import build_model

    # A smaller tile batch than serving's 12 keeps the CPU half short; the
    # widths are the configuration's own.
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32", infer_tile_batch=4)
    got, secs = [], []
    for where in (dev, "cpu"):
        m = build_model(cfg32)
        m.load_state_dict(weights)
        t0 = time.perf_counter()
        got.append(run(RADNet(cfg32, m, device=where)))
        secs.append(time.perf_counter() - t0)
    return {"card": got[0], "cpu": got[1], "n_card": len(got[0]), "n_cpu": len(got[1]),
            "unmatched": unmatched(*got), "card_s": secs[0], "cpu_s": secs[1]}


def map_card_vs_cpu(weights: dict, cfg, dev, panel, boxes) -> dict:
    """card_and_cpu's detections on ``panel``, and each side's mAP against
    the panel's ``boxes`` (``map_card``, ``map_cpu``) and against every
    second CPU detection (``map_pseudo_gt_card``, ``map_pseudo_gt_cpu``),
    so that the two mAPs have something to differ on."""
    from radnet_torch.evaluation import evaluate_detections

    dets = card_and_cpu(weights, cfg, dev, lambda net: net.predict([panel]))
    pseudo = [{k: det[k] for k in ("class", "x1", "y1", "x2", "y2")} for det in dets["cpu"][::2]]
    for key, truth in (("map", boxes), ("map_pseudo_gt", pseudo)):
        dets[key + "_card"] = evaluate_detections(dets["card"], truth)["mAP"]
        dets[key + "_cpu"] = evaluate_detections(dets["cpu"], truth)["mAP"]
    return dets


def evaluate_phase(tmp: str, dev, smi, serve_weights: dict) -> dict:
    """Phase evaluate, on the model directory cli.train wrote, over a test set
    of N_TEST_PANELS 2400 x 2400 panels (the two validation panels first):
    cli.test --coco-map (launches exact a batch, outputs, --compare's exit
    codes), one panel card vs CPU, cli.test_rpn, and cli.test_data drawing
    samples and reporting anchors.  Returns each serving kernel's launches on
    the cli.test and cli.test_rpn runs."""
    import shutil

    import torch

    from radnet_torch.cli import test, test_data, test_rpn
    from radnet_torch.config import Config
    from radnet_torch.data.dataset import get_data, get_image
    from radnet_torch.data.png import read_png
    from radnet_torch.inference import RADNet
    from radnet_torch.ops import cuda_kernels

    t_phase = time.perf_counter()
    models = os.path.join(tmp, "train_models")
    name = "faster_rcnn_resnet50_smoke"
    model_dir = os.path.join(models, name)
    cfg = Config.load(os.path.join(model_dir, "config.json"))
    d = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    write_split(tmp, "test", [SEED + 200, SEED + 201] + [SEED + 300 + k for k in range(N_TEST_PANELS - 2)])
    write_s = time.perf_counter() - t0
    test_csv, test_dir = os.path.join(d, "test.csv"), os.path.join(d, "test")
    test_args = ["--models-path", models, "--model-name", name, "--test-annot", test_csv,
                 "--test-data", test_dir, "--device", str(dev)]

    # cli.test: every kernel launch counted against the cascade's batches.
    cuda_kernels.reset_launch_counts()
    with counting_calls(RADNet, "_predict_tiles_impl", lambda images, *_: images.dim()) as batches:
        rc, stdout, test_s = run_cli(test.main, test_args + ["--coco-map"])
    stdout = stdout.getvalue()
    launches_test = launch_counts()
    check(rc == 0, f"cli.test exited {rc}")
    with open(os.path.join(model_dir, "test_accuracy.json")) as f:
        acc = json.load(f)
    with open(os.path.join(model_dir, "test_accuracy_coco.json")) as f:
        coco = json.load(f)
    data, _, _ = get_data(test_csv, test_dir, cfg.img_types)
    classes = {b["class"] for img in data for b in img["bboxes"]}
    seconds = {k: float(line.split(": ")[1].rstrip("s")) for line in stdout.splitlines()
               for k in ("Average prediction time", "Steady-state prediction time (excl. first panel)")
               if line.startswith(k + ": ")}
    pngs = [os.path.join(model_dir, "test", img["filepath"].split("/")[-1]) for img in data]
    svg = os.path.join(model_dir, "viz", "precision_recall.svg")
    n_b = len(batches)
    emit({"phase": "evaluate_test", "nvidia_smi": smi, "panels": len(data), "write_s": write_s,
          "wall_s": test_s, "sec_per_panel": seconds, "batches": n_b, "grey_batches": batches.count(3),
          "launches": launches_test, "mAP": acc.get("mAP"), "per_class": acc,
          "mAP_50_95": coco.get("mAP_50_95"), "AP50": coco.get("AP50")})
    check(len(data) == N_TEST_PANELS, f"cli.test read {len(data)} panels, not {N_TEST_PANELS}")
    check(classes | {"mAP"} <= set(acc), f"test_accuracy.json lacks classes: {sorted(acc)}")
    check(coco["AP50"] == acc["mAP"] and len(coco["per_threshold"]) == 10,
          f"test_accuracy_coco.json: AP50 {coco['AP50']} vs mAP {acc['mAP']}, "
          f"{len(coco['per_threshold'])} thresholds")
    check(all(os.path.isfile(p) and read_png(p).ndim == 3 for p in pngs) and os.path.isfile(svg),
          f"cli.test did not write {pngs} and {svg}")
    check(len(seconds) == 2, f"cli.test printed no prediction times: {seconds}")
    check(n_b > 0 and batches.count(3) == n_b, f"cli.test batches {batches}: not all prescaled grey")
    want = {"grey_stem": n_b, "nms_fused": 2 * n_b, "roi_pool": n_b, "roi_pool_backward": 0, **NO_INT8}
    check(launches_test == want, f"cli.test launches {launches_test}, want {want} for {n_b} batches")

    # --compare: against its own file parity holds; 0.01 more mAP fails it.
    ref = dict(acc, mAP=acc["mAP"] + 0.01)
    ref_path = os.path.join(tmp, "ref_accuracy.json")
    with open(ref_path, "w") as f:
        json.dump(ref, f)
    own_path = os.path.join(tmp, "own_accuracy.json")
    shutil.copy(os.path.join(model_dir, "test_accuracy.json"), own_path)
    compare_rc = [run_cli(test.main, test_args + ["--compare", p])[0] for p in (own_path, ref_path)]
    check(compare_rc == [0, 2], f"cli.test --compare exited {compare_rc}, want [0, 2]")

    # The card against the CPU on one panel, float32: the trained model's
    # proposals (40 steps from random init score no detection yet), then the
    # calibrated serving weights' detections and their mAPs.
    panel, gt = get_image(data[0]["filepath"], cfg.img_types), data[0]["bboxes"]
    trained_w = torch.load(os.path.join(model_dir, "model.pt"), weights_only=True)
    props = card_and_cpu(trained_w, cfg, dev, lambda net: net.predict_region_proposals(panel))
    dets = map_card_vs_cpu(serve_weights, cfg, dev, panel, gt)
    cmp = {"trained_proposals": props, "calibrated_detections": dets}

    # cli.test_rpn over the test set: only the fused NMS, once a host tile batch.
    cuda_kernels.reset_launch_counts()
    with counting_calls(RADNet, "_proposals_only") as rpn_batches:
        rc, rpn_out, rpn_s = run_cli(test_rpn.main, [
            "--models-path", models, "--model-name", name, "--annot", test_csv,
            "--data", test_dir, "--device", str(dev)])
    launches_rpn = launch_counts()
    lines = rpn_out.getvalue().splitlines()
    recall = [line for line in lines if line.startswith("RPN recall@0.5")]
    # From the annotations read (the model is loaded) to each panel's
    # proposals printed: a panel's decode, proposals, drawing and PNG write.
    t_read = next(t for t, ln in zip(rpn_out.stamps, lines) if ln.startswith("Read "))
    t_props = [t for t, ln in zip(rpn_out.stamps, lines) if ln.endswith(" proposals")]
    rpn_seconds = {"average": (t_props[-1] - t_read) / len(t_props),
                   "steady_state": (t_props[-1] - t_props[0]) / max(len(t_props) - 1, 1)}
    rpn_pngs = [os.path.join(model_dir, "test_rpn", img["filepath"].split("/")[-1]) for img in data]

    # cli.test_data: samples drawn, then the anchor report.
    viz = os.path.join(tmp, "test_data_viz")
    td = ["--config-json", os.path.join(model_dir, "config.json"), "--train-annot",
          os.path.join(d, "train.csv"), "--train-data", os.path.join(d, "train"), "--device", str(dev)]
    rc_td, _, td_s = run_cli(test_data.main, td + ["--n-samples", "2", "--out-dir", viz])
    rc_an, an_out, an_s = run_cli(test_data.main, td + ["--analyze-anchors", "--usage-samples", "2"])
    an_out = an_out.getvalue()
    report = json.loads(an_out[an_out.index("{"):])

    shown = {k: {f: v for f, v in c.items() if f not in ("card", "cpu")} for k, c in cmp.items()}
    emit({"phase": "evaluate", "nvidia_smi": smi, "test_panels": len(data), "test_sec_per_panel": seconds,
          "test_rpn_panels": len(t_props), "test_rpn_sec_per_panel": rpn_seconds,
          "test_rpn_wall_s": rpn_s, "test_rpn_batches": len(rpn_batches),
          "test_rpn_launches": launches_rpn, "rpn_recall": recall, "compare_rc": compare_rc,
          "card_vs_cpu": shown, "test_data_s": td_s, "analyze_anchors_s": an_s,
          "kmeans_wh_clusters": report.get("kmeans_wh_clusters"),
          "anchor_usage": report.get("anchor_usage"), "phase_wall_s": time.perf_counter() - t_phase})
    for which, c in cmp.items():
        check(c["n_card"] > 0 and c["unmatched"] <= 0.05 * (c["n_card"] + c["n_cpu"]),
              f"{which}: {c['unmatched']} of {c['n_card']} + {c['n_cpu']} unmatched card vs CPU")
    for key in ("map", "map_pseudo_gt"):
        m_g, m_w = dets[key + "_card"], dets[key + "_cpu"]
        check(abs(m_g - m_w) <= 0.005, f"calibrated detections: {key} card {m_g} vs CPU {m_w}")
    check(dets["map_pseudo_gt_cpu"] > 0, f"the pseudo ground truth scored nothing: {shown}")
    check(rc == 0 and len(recall) == 1 and len(t_props) == len(data) and all(map(os.path.isfile, rpn_pngs)),
          f"cli.test_rpn: rc {rc}, recall lines {recall}, {len(t_props)} of {len(data)} panels, "
          f"pngs {sum(map(os.path.isfile, rpn_pngs))}")
    want = {"grey_stem": 0, "nms_fused": len(rpn_batches), "roi_pool": 0, "roi_pool_backward": 0, **NO_INT8}
    check(len(rpn_batches) > 0 and launches_rpn == want,
          f"cli.test_rpn launches {launches_rpn}, want {want} for {len(rpn_batches)} tile batches")
    check(rc_td == 0 and all(os.path.isfile(os.path.join(viz, f"test_data_{i}.png")) for i in range(2)),
          f"cli.test_data: rc {rc_td}, PNGs {os.listdir(viz) if os.path.isdir(viz) else None}")
    check(rc_an == 0 and len(report.get("kmeans_wh_clusters", [])) == 3 and "anchor_usage" in report,
          f"cli.test_data --analyze-anchors: rc {rc_an}, report {report}")
    return {"test": launches_test, "test_rpn": launches_rpn}


def training_batch(tmp: str, cfg, dev, n_samples: int = 64):
    """The host's samples/s from parallel_sample_generator alone (warm tile
    caches), and one batch of ``cfg.batch_size`` on ``dev``."""
    from radnet_torch.data.dataset import get_data
    from radnet_torch.data.pipeline import batch_samples, parallel_sample_generator, upload_batch

    d = os.path.join(tmp, "data")
    data, class_count, _ = get_data(os.path.join(d, "train.csv"), os.path.join(d, "train"),
                                    cfg.img_types)
    gen = parallel_sample_generator(data, cfg, class_count, cfg.class_mapping, num_workers=4, seed=5)
    for _ in range(16):
        next(gen)
    t0 = time.perf_counter()
    for _ in range(n_samples):
        next(gen)
    samples_per_s = n_samples / (time.perf_counter() - t0)
    batch = upload_batch(batch_samples([next(gen) for _ in range(cfg.batch_size)]), dev)
    gen.close()
    return batch, samples_per_s


def captured_kernel_inputs(step, batch, draws):
    """One train step with the kernels' wrappers wrapped: the NMS, RoI-pool
    forward and backward inputs the main path gives them."""
    from radnet_torch.ops import nms, roi_align

    got = {}
    real = (nms.nms_kept, roi_align.roi_pool_cuda, roi_align.roi_pool_backward_cuda)

    def nms_kept(boxes, scores, valid, thresh):
        got["nms"] = (boxes.clone(), scores.clone(), valid.clone(), thresh)
        return real[0](boxes, scores, valid, thresh)

    def fwd(fmap, rois, **kw):
        got["fwd"] = (fmap.clone(), rois.clone(), kw)
        return real[1](fmap, rois, **kw)

    def bwd(g, rois, hw, **kw):
        got["bwd"] = (g.clone(), rois.clone(), hw, kw)
        return real[2](g, rois, hw, **kw)

    nms.nms_kept, roi_align.roi_pool_cuda, roi_align.roi_pool_backward_cuda = nms_kept, fwd, bwd
    try:
        step(batch, draws)
    finally:
        nms.nms_kept, roi_align.roi_pool_cuda, roi_align.roi_pool_backward_cuda = real
    return got


def train_step_phase(batch, samples_per_s, cfg, dev, smi, errs, earlier,
                     schedules=("joint",), phase: str = "train_step") -> dict:
    """Phase train_step: ms per step and the card's busy share over 10
    steps of each schedule, frozen and trainable trunk; peak memory; the
    host's samples/s; each kernel on the inputs one trainable step of the
    last schedule gave it, held against its plain version (NMS kept sets
    and rounds equal, the RoI pool and its backward within their kernel2 /
    kernel2_backward tolerances) and timed beside its bound, its plain
    version and a library call (emitted as ``phase`` with "_step" made
    "_kernels").  Returns kernel-line entries."""
    import torch

    from radnet_torch.engine.steps import draw_step, make_step
    from radnet_torch.engine.train_state import create_train_state

    gen = torch.Generator(device=dev).manual_seed(SEED)
    per_case, captured = {}, None
    for schedule in schedules:
        c = dataclasses.replace(cfg, train_schedule=schedule)
        for trainable in (False, True):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state = create_train_state(c, torch.Generator().manual_seed(SEED), dev,
                                       base_net_trainable=trainable)
            step = make_step(state, c, trunk_trainable=trainable)
            draws = [draw_step(gen, c, c.batch_size, dev) for _ in range(10)]
            count = [0]

            def one():
                count[0] += 1
                return step(batch, draws[count[0] % 10])

            ms = time_cuda(one, iters=10, warmup=2)
            wall_ms, busy_ms = device_busy(lambda: [one() for _ in range(10)])
            per_case[f"{schedule}_{'trainable' if trainable else 'frozen'}"] = {
                "ms_per_step": ms, "steps_per_s": 1e3 / ms, "samples_per_s": c.batch_size * 1e3 / ms,
                "wall_ms_10_steps": wall_ms, "busy_ms_10_steps": busy_ms,
                "busy_share": busy_ms / wall_ms, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            }
            if trainable and schedule == schedules[-1]:
                captured = captured_kernel_inputs(step, batch, draws[0])
            del state, step, draws
    frozen = per_case[f"{schedules[0]}_frozen"]["samples_per_s"]
    emit({"phase": phase, "network": cfg.network, "nvidia_smi": smi, "batch": cfg.batch_size,
          "canvas": cfg.canvas_size, "dtype": cfg.compute_dtype, **per_case,
          "host_samples_per_s": samples_per_s,
          "host_vs_card": ("host" if samples_per_s < frozen else "card")
                          + f" sets the pace ({schedules[0]}, frozen trunk)"})
    nms_train, fwd_train, bwd = captured_kernel_rows(captured, errs, earlier,
                                                     phase.replace("_step", "_kernels"))
    return {"nms_fused": nms_train, "roi_pool": fwd_train, "roi_pool_backward": bwd,
            "train_step": per_case}


def nms_row(boxes, scores, valid, thr, where: str) -> dict:
    """The fused NMS on sets a path gave it: held against its plain version
    (kept sets and round counts equal) and timed beside its bound."""
    import torch

    from radnet_torch.ops import nms

    kept, rounds = nms.nms_kept_cuda(boxes, scores, valid, thr)
    want_kept, want_rounds = nms.nms_kept_plain(boxes, scores, valid, thr)
    kept_mism = int((kept != want_kept).sum())
    bnd, by = bound_ms(*nms_work(boxes, scores, valid, rounds))
    row = {"shape": list(scores.shape), "thresh": thr, "valid": int(valid.sum()),
           "kept": int(kept.sum()), "rounds_max": int(rounds.max()),
           "kept_mismatches": kept_mism, "rounds_equal": bool(torch.equal(rounds, want_rounds)),
           "max_abs_err": float((kept.float() - want_kept.float()).abs().max()),
           "ms": device_ms(lambda: nms.nms_kept_cuda(boxes, scores, valid, thr), "nms_fused_kernel"),
           "plain_ms": time_cuda(lambda: nms.nms_kept_plain(boxes, scores, valid, thr), iters=3),
           "bound_ms": bnd, "bound_by": by}
    check(kept_mism == 0 and row["rounds_equal"],
          f"nms_fused disagrees with its plain version on {where} "
          f"({kept_mism} kept mismatches, rounds equal: {row['rounds_equal']})")
    return row


def roi_forward_row(fmap, rois, kw, where: str) -> tuple[dict, object, object]:
    """The RoI-pool kernel on inputs a path gave it: held against its plain
    version (kernel2's tolerances) and timed beside its bound, its plain
    version and F.grid_sample.  Also returns grid_sample's NCHW map and grid."""
    import torch

    from radnet_torch.ops import roi_align

    ok, err, tol = roi_forward_error(roi_align.roi_pool_cuda(fmap, rois, **kw),
                                     roi_align.roi_pool_plain(fmap.float(), rois, **kw), fmap.dtype)
    b, hw, _, c = fmap.shape
    r, p, elt = rois.shape[1], kw["pool_size"], fmap.element_size()
    grid = grid_sample_centres(rois, p, kw["center_stride"], hw).to(fmap.dtype)
    fmap_nchw = fmap.permute(0, 3, 1, 2)
    bnd, by = bound_ms(b * hw * hw * c * elt + b * r * 16 + b * r * p * p * c * elt,
                       9.0 * b * r * p * p * c)
    row = {"shape": [b, hw, hw, c, r, p], "center_stride": kw["center_stride"],
           "dtype": str(fmap.dtype), "max_abs_err": err, "tolerance": tol,
           "ms": device_ms(lambda: roi_align.roi_pool_cuda(fmap, rois, **kw), "roi_pool_kernel"),
           "plain_ms": time_cuda(lambda: roi_align.roi_pool_plain(fmap, rois, **kw), iters=5),
           "library_ms": call_device_ms(lambda: torch.nn.functional.grid_sample(
               fmap_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)),
           "bound_ms": bnd, "bound_by": by}
    check(ok, f"roi_pool disagrees with its plain version on {where} ({err}, {tol})")
    return row, fmap_nchw, grid


def captured_kernel_rows(captured, errs, earlier, phase: str):
    """Each kernel against its plain version on the inputs one train step
    gave it (captured_kernel_inputs), timed: the NMS, RoI-pool forward and
    backward rows, emitted as ``phase``."""
    where = "the train step's inputs"
    nms_train = nms_row(*captured["nms"], where)
    fwd_train, fmap_nchw, grid = roi_forward_row(*captured["fwd"], where)
    bwd = backward_train_kernel(captured["bwd"], fmap_nchw, grid, errs["roi_pool_backward"],
                                earlier)
    emit({"phase": phase, "nms_fused": nms_train, "roi_pool": fwd_train, "roi_pool_backward": bwd})
    check(bwd["within_tolerance"], f"roi_pool_backward disagrees with its plain version on "
                                   f"{where} ({bwd['max_abs_err_train_step_inputs']}, "
                                   f"{bwd['tolerance']})")
    check(bwd["deterministic"], f"roi_pool_backward gave two results on {where}")
    check(bwd["call_kernels"] == 1, f"one RoIPoolFunction backward launched "
                                    f"{bwd['call_kernels']} device kernels, not 1")
    return nms_train, fwd_train, bwd


def backward_train_kernel(captured_bwd, fmap_nchw, grid, err_main: float, earlier) -> dict:
    """The backward kernel on the inputs one train step gave it: held
    against its plain version, launched twice (bit-equal), timed beside its
    bound, its plain version, the library call and the earlier atomic
    kernel; and the whole RoIPoolFunction backward timed after (this
    kernel alone) and before (the earlier wrapper's zero fill, atomic kernel
    and cast), with the device kernels each call launches."""
    import types

    import torch

    from radnet_torch.ops import roi_align

    g, brois, map_hw, bkw = captured_bwd
    b, r, p, _, c = g.shape
    h, w = map_hw
    got = roi_align.roi_pool_backward_cuda(g, brois, map_hw, **bkw)
    again = roi_align.roi_pool_backward_cuda(g, brois, map_hw, **bkw)
    ref = roi_align.roi_pool_backward_plain(g, brois, map_hw, **bkw)
    sums = earlier_roi_backward(earlier["roi_pool_backward"], g, brois, map_hw, **bkw)
    ok, err, _, tol = roi_backward_error(got, ref)
    _, err_earlier, _, _ = roi_backward_error(sums.to(g.dtype), ref)
    deterministic = bool(torch.equal(got, again))
    del got, again, ref, sums
    # What RoIPoolFunction.forward leaves on its context.
    ctx = types.SimpleNamespace(saved_tensors=(brois,), needs_input_grad=(True, False, False, False),
                                geometry=(h, w, g.dtype, p, bkw["center_stride"]))

    def after():
        return roi_align.RoIPoolFunction.backward(ctx, g)[0]

    def before():  # the earlier RoIPoolFunction.backward, on the same contiguous grad_out
        return earlier_roi_backward(earlier["roi_pool_backward"], g, brois, map_hw,
                                    **bkw).to(g.dtype)

    gb = g.permute(0, 4, 1, 2, 3).reshape(b, c, r * p, p).contiguous()  # grid_sample's layout

    def library():
        return torch.ops.aten.grid_sampler_2d_backward(gb, fmap_nchw, grid, 0, 1, True, [True, False])

    elt = g.element_size()
    bnd, by = bound_ms(g.numel() * elt + b * r * 16 + b * h * w * c * elt, 10.0 * b * r * p * p * c)
    return {
        "name": "roi_pool_backward", "route": "cuda", "source": "radnet_torch/csrc/roi_pool_backward.cu",
        "replaces": "radnet_tpu/ops/roi_align.py:121 (XLA autodiff of roi_pool_matmul; no Pallas kernel)",
        "shape": [b, h, w, c, r, p], "dtype": str(g.dtype),
        "ms": device_ms(lambda: roi_align.roi_pool_backward_cuda(g, brois, map_hw, **bkw),
                        "roi_pool_backward_kernel"),
        "earlier_ms": device_ms(
            lambda: earlier_roi_backward(earlier["roi_pool_backward"], g, brois, map_hw, **bkw),
            "roi_pool_backward_atomic_kernel"),
        "call_ms": time_cuda(after), "call_device_ms": call_device_ms(after),
        "call_kernels": device_work_per_call(after),
        "earlier_call_ms": time_cuda(before), "earlier_call_device_ms": call_device_ms(before),
        "earlier_call_kernels": device_work_per_call(before),
        "call_kernels_counted_by": "nodes of a CUDA graph captured from one call",
        "call": "RoIPoolFunction.backward on grad_out contiguous in the map's type",
        "earlier_call": "zero-filled float32 map, earlier atomic kernel, cast to the map's type",
        "plain_ms": time_cuda(lambda: roi_align.roi_pool_backward_plain(g, brois, map_hw, **bkw), iters=5),
        "library_ms": call_device_ms(library),
        "library": ("torch.ops.aten.grid_sampler_2d_backward (F.grid_sample's backward), same "
                    "shape; device ms of every kernel it launches"),
        "bound_ms": bnd, "bound_by": by,
        "bound_bytes_note": "reads the bf16 cell gradient once, writes the map's gradient once in bf16",
        "max_abs_err": err_main, "max_abs_err_train_step_inputs": err, "tolerance": tol,
        "within_tolerance": ok, "deterministic": deterministic,
        "earlier_max_abs_err_train_step_inputs": err_earlier,
        "earlier_design": ("float32 atomics into a zero-filled map, cast to the map's type "
                           "(radnet_torch/csrc/earlier/roi_pool_backward_atomic.cu)"),
    }


def train_sync_free_phase(batch, cfg, dev, phase: str = "train_sync_free") -> None:
    """Phase train_sync_free: one train step of ``cfg.train_schedule`` (draws,
    augmentation, targets, losses, backward, the Adam updates, the
    alternating detector update gated on the card) queued under
    set_sync_debug_mode("error"), trunk trainable, after one step that
    builds the first-use constants."""
    import torch

    from radnet_torch.engine.steps import draw_step, make_step
    from radnet_torch.engine.train_state import create_train_state

    state = create_train_state(cfg, torch.Generator().manual_seed(SEED), dev, base_net_trainable=True)
    step = make_step(state, cfg, trunk_trainable=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step(batch, draw_step(gen, cfg, cfg.batch_size, dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        metrics = step(batch, draw_step(gen, cfg, cfg.batch_size, dev))
        t1 = time.perf_counter()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    total = float(metrics["total_loss"])
    emit({"phase": phase, "schedule": cfg.train_schedule, "queue_ms": (t1 - t0) * 1e3,
          "card_done_after_ms": (t2 - t0) * 1e3, "total_loss": total})
    check(np.isfinite(total), f"{phase}: the step's loss is not finite")


def learning_phase(batch, cfg, dev, n_steps: int = 60, lr: float = 1e-5,
                   phase: str = "learning") -> dict:
    """Phase learning: ``cfg.train_schedule`` on one fixed batch,
    photometric augmentation off, trunk frozen, ``n_steps`` Adam steps from
    the seeded init with calibrated output layers; the mean total loss of
    the last 10 steps must be below the mean of the first 5."""
    import torch

    from radnet_torch.engine.steps import draw_step, make_step
    from radnet_torch.engine.train_state import create_train_state
    from radnet_torch.inference import RADNet
    from radnet_torch.models.detector import build_model, init_weights

    gen = torch.Generator().manual_seed(SEED)
    model = init_weights(build_model(cfg), gen)
    calibrate_heads(RADNet(cfg, model, device=dev), batch["image"][:2], gen)
    state = create_train_state(cfg, gen, dev, learning_rate=lr, model=model)
    step = make_step(state, cfg)
    dgen = torch.Generator(device=dev).manual_seed(SEED)
    totals = torch.stack([step(batch, draw_step(dgen, cfg, batch["image"].shape[0], dev,
                                                photometric=False))["total_loss"]
                          for _ in range(n_steps)]).cpu().tolist()
    first, last = float(np.mean(totals[:5])), float(np.mean(totals[-10:]))
    emit({"phase": phase, "schedule": cfg.train_schedule, "steps": n_steps, "lr": lr,
          "total_loss": totals, "mean_first_5": first, "mean_last_10": last, "ratio": last / first})
    check(last < first, f"{phase}: no learning on a fixed batch: {first} -> {last}")
    return {"mean_first_5": first, "mean_last_10": last}


def proposal_sets_unmatched(got, want) -> tuple[int, int]:
    """(proposals of either side without an equal box in the other's set of
    the same tile, proposals on both sides): the kept sets' valid boxes,
    which are integer-valued, compared as multisets."""
    import collections

    missing = total = 0
    for b in range(got.boxes.shape[0]):
        g, w = (collections.Counter(map(tuple, p.boxes[b][p.valid[b]].tolist())) for p in (got, want))
        missing += sum(((g - w) + (w - g)).values())
        total += sum(g.values()) + sum(w.values())
    return missing, total


def train_card_vs_cpu_phase(batch, base, dev) -> dict:
    """Phase train_card_vs_cpu: one float32 joint step (TF32 off, batch 2,
    brightness only, trunk trainable) on the card and on the CPU from the
    same weights and the same StepDraws.  The proposals are a discrete
    choice (top-k and NMS over RPN scores), so float32 noise at a near tie
    can swap a proposal and with it a sampled RoI (one run: the detector's
    class loss 2e-3 apart); their sets are held at the serving gate of at
    most 5% unmatched, and the CPU step then takes the card's proposals so
    that the rest of the step is compared on the same RoIs: the four losses
    within 1e-4 relative, and the parameter updates within 1e-4 of the
    largest update.  The step updates with plain SGD here (GatedSGD), so an
    update is lr times the gradient: Adam's first update is lr * sign(g)
    for any gradient above 1e-8, which would turn elements whose gradient
    is float32 noise into full-size differences (Adam itself is held
    against optax on the CPU, tests/test_torch_train_step.py and
    tests/test_torch_alternating.py).  ResNet50's largest update, its
    output layers', is ~30x its trunk's, so the 1e-4 gate holds the trunk
    at ~3e-3 of its own updates (vgg_train_card_vs_cpu holds VGG16's
    alternating step phase by phase)."""
    import torch

    from radnet_torch.engine import steps
    from radnet_torch.engine.steps import draw_step, make_step
    from radnet_torch.engine.train_state import create_train_state
    from radnet_torch.inference import RADNet
    from radnet_torch.models.detector import build_model, init_weights
    from radnet_torch.ops.proposals import Proposals

    cfg = dataclasses.replace(base, compute_dtype="float32", batch_size=2, use_noise=False)
    gen = torch.Generator().manual_seed(SEED + 1)
    model = init_weights(build_model(cfg), gen)
    small = {k: v[:2] for k, v in batch.items()}
    calibrate_heads(RADNet(cfg, model.to(dev), device=dev), small["image"], gen)
    weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    draws = draw_step(torch.Generator().manual_seed(SEED + 2), cfg, 2, "cpu")
    torch.set_num_threads(os.cpu_count() or 1)
    props, out = [], []
    real_decode = steps.decode_proposals

    def decode(*args, **kwargs):
        own = real_decode(*args, **kwargs)
        props.append(Proposals(*(t.cpu() for t in own)))
        return own if len(props) == 1 else props[0]

    steps.decode_proposals = decode
    try:
        for where in (torch.device(dev), torch.device("cpu")):
            m = build_model(cfg)
            m.load_state_dict(weights)
            state = create_train_state(cfg, gen, where, base_net_trainable=True, model=m)
            state.optimizer = GatedSGD(state.optimizer.params, 1e-3)
            step = make_step(state, cfg, trunk_trainable=True)
            t0 = time.perf_counter()
            metrics = step({k: v.to(where) for k, v in small.items()}, draws.to(where))
            after = {k: v.detach().cpu() for k, v in state.model.named_parameters()}
            out.append(({k: float(v) for k, v in metrics.items()}, after, time.perf_counter() - t0))
    finally:
        steps.decode_proposals = real_decode
    check(len(props) == 2, f"{len(props)} proposal calls in two train steps")
    props_unmatched, props_total = proposal_sets_unmatched(*props)
    (m_gpu, p_gpu, s_gpu), (m_cpu, p_cpu, s_cpu) = out
    loss_rel = {k: abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12) for k in LOSS_KEYS}
    upd_gpu = {k: p_gpu[k] - weights[k] for k in p_gpu}
    upd_cpu = {k: p_cpu[k] - weights[k] for k in p_cpu}
    largest = max(float(u.abs().max()) for u in upd_cpu.values())
    diff = {k: float((upd_gpu[k] - upd_cpu[k]).abs().max()) for k in upd_cpu}
    worst = max(diff.values())
    n_beyond = sum(int(((upd_gpu[k] - upd_cpu[k]).abs() > 1e-4 * largest).sum()) for k in upd_cpu)
    n_params = sum(u.numel() for u in upd_cpu.values())
    emit({"phase": "train_card_vs_cpu", "network": cfg.network, "schedule": cfg.train_schedule,
          "trunk": "trainable", "dtype": "float32", "tf32": False,
          "batch": 2, "proposals_unmatched": props_unmatched, "proposals_both_sides": props_total,
          "cpu_step_takes_card_proposals": True,
          "losses_card": m_gpu, "losses_cpu": m_cpu, "loss_rel_err": loss_rel,
          "largest_update": largest, "max_update_diff": worst,
          "max_update_diff_over_largest": worst / largest, "worst_update_param": max(diff, key=diff.get),
          "n_beyond_1e-4_of_largest": n_beyond, "n_params": n_params,
          "card_s": s_gpu, "cpu_s": s_cpu})
    check(props_total > 0 and props_unmatched <= 0.05 * props_total,
          f"train_card_vs_cpu: card vs CPU proposals: {props_unmatched} of {props_total} unmatched")
    check(max(loss_rel.values()) <= 1e-4, f"train_card_vs_cpu: card vs CPU losses differ: {loss_rel}")
    check(worst <= 1e-4 * largest, f"train_card_vs_cpu: card vs CPU updates differ by {worst} (largest {largest})")
    return {"loss_rel_err": loss_rel, "max_update_diff_over_largest": worst / largest,
            "proposals_unmatched": props_unmatched}


LOSS_KEYS = ("loss_rpn_cls", "loss_rpn_regr", "loss_detector_cls", "loss_detector_regr")
# The layers whose gradient passes no ReLU between them and the loss: a
# ReLU that float32 noise flips moves their gradient by ~ the noise only.
OUTPUT_LAYERS = ("rpn_head.rpn_out_class.", "rpn_head.rpn_out_regress.",
                 "head.dense_class.", "head.dense_regress.")
# The limit, as a share of the phase's largest update (the feature map's
# gradient: of its largest element), on everything a ReLU stands before,
# from scripts/card_vs_cpu_probe.py's readings (PERF.md, section 6):
# card vs CPU at most 9.1e-3, CPU vs CPU 2 ulp apart at most 6.3e-2 (one
# flipped fc2 ReLU), the backward's gradient one map row off 0.31 / 1.35.
RELU_NOISE_LIMIT = 0.1
# VGG16's pseudo-ground-truth mAP, card vs CPU, from the same probe's
# readings: at most 0.0139 over 3 weight seeds x 3 panels (the gated panel
# and seed read 0.0139), 0.352-0.363 with the pooled cells one column off.
VGG_PSEUDO_GT_MAP_LIMIT = 0.05


def alternating_card_vs_cpu(batch, base, dev, seed: int = SEED + 1, lr: float = 1e-3) -> dict:
    """One float32 alternating step (TF32 off, batch 2, brightness only,
    trunk trainable, GatedSGD at ``lr`` in both phases) of the seeded,
    calibrated ``base`` model on the card, then on the CPU, phase by phase
    on identical inputs:

      rpn    the CPU step from the same weights (the RPN phase's update);
      det    the CPU step from the card's parameters after its RPN phase,
             with its own RPN phase at lr 0 (the detector phase's update);
      step   the rpn run's detector phase: after the CPU's own RPN update;

    every CPU step takes the card's proposals.  ``witness_rpn`` and
    ``witness_det`` are the rpn and det runs again from weights moved by 2
    ulp each (random sign): float32 noise on the CPU alone.  Returns each
    comparison's readings: loss differences (relative), update differences
    over the phase's largest update for the output layers (OUTPUT_LAYERS)
    and for the rest, the feature map's gradient difference over its
    largest, and the ReLUs whose sign differs before rpn_conv1, fc1 and
    fc2."""
    import torch

    from radnet_torch.engine import steps
    from radnet_torch.engine.steps import draw_step, make_alternating_train_step
    from radnet_torch.engine.train_state import PhaseAdams, create_train_state
    from radnet_torch.inference import RADNet
    from radnet_torch.models.detector import build_model, init_weights
    from radnet_torch.ops.proposals import Proposals

    cfg = dataclasses.replace(base, compute_dtype="float32", batch_size=2, use_noise=False,
                              train_schedule="alternating")
    gen = torch.Generator().manual_seed(seed)
    model = init_weights(build_model(cfg), gen)
    small = {k: v[:2] for k, v in batch.items()}
    calibrate_heads(RADNet(cfg, model.to(dev), device=dev), small["image"], gen)
    w0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del model
    draws = draw_step(torch.Generator().manual_seed(seed + 1), cfg, 2, "cpu")
    torch.set_num_threads(os.cpu_count() or 1)
    props = []
    real_decode = steps.decode_proposals

    def decode(*args, **kwargs):
        own = real_decode(*args, **kwargs)
        props.append(Proposals(*(t.cpu() for t in own)))
        return own if len(props) == 1 else props[0]

    def moved(weights, k):
        """``weights`` with every parameter moved by 2 ulp, signs seeded by ``k``."""
        g = torch.Generator().manual_seed(seed + k)
        return {n: (v.double() * (1 + 2.0 ** -22 * (2 * torch.randint(0, 2, v.shape, generator=g) - 1))).float()
                for n, v in weights.items()}

    def run(where, start, lr_rpn, lr_det):
        m = build_model(cfg)
        m.load_state_dict(start)
        state = create_train_state(cfg, gen, where, base_net_trainable=True, model=m)
        rec = {"start": start, "fmap_grad": [], "signs": {}}

        def snap():
            return {k: v.detach().cpu().clone() for k, v in m.named_parameters()}

        class RPNPhase(GatedSGD):
            def step(self, gate=None):
                super().step(gate)
                rec["after_rpn"] = snap()

        state.optimizer = PhaseAdams(RPNPhase(state.optimizer.rpn.params, lr_rpn),
                                     GatedSGD(state.optimizer.det.params, lr_det))
        real_features = m.features

        def features(images):
            f = real_features(images)
            f.register_hook(lambda g: rec["fmap_grad"].append(g.detach().cpu()))
            return f

        def sign(name):
            def hook(mod, inp, out):
                if torch.is_grad_enabled():  # not step 2's proposal forward
                    rec["signs"][name] = (out > 0).cpu()
            return hook

        m.features = features
        for name, mod in (("rpn_conv1", m.rpn_head.rpn_conv1), ("fc1", m.head.fc1), ("fc2", m.head.fc2)):
            mod.register_forward_hook(sign(name))
        t0 = time.perf_counter()
        metrics = make_alternating_train_step(state, cfg, trunk_trainable=True)(
            {k: v.to(where) for k, v in small.items()}, draws.to(where))
        rec["metrics"] = {k: float(v) for k, v in metrics.items()}
        rec["after"] = snap()
        rec["s"] = time.perf_counter() - t0
        return rec

    steps.decode_proposals = decode
    try:
        card = run(torch.device(dev), w0, lr, lr)
        cpu = run("cpu", w0, lr, lr)
        post = dict(w0, **card["after_rpn"])
        det = run("cpu", post, 0.0, lr)
        witness_rpn = run("cpu", moved(w0, 7), lr, 0.0)
        witness_det = run("cpu", moved(post, 8), 0.0, lr)
    finally:
        steps.decode_proposals = real_decode

    def updates(r, phase):
        start, end = (r["after_rpn"], r["after"]) if phase == "det" else (r["start"], r["after_rpn"])
        return {k: end[k] - start[k] for k in end}

    def compare(a, b, phase, losses, signs, fmap_index):
        """a's and b's ``phase`` update, losses and feature-map gradient."""
        ua, ub = updates(a, phase), updates(b, phase)
        largest = max(float(u.abs().max()) for u in ub.values())
        diff = {k: float((ua[k] - ub[k]).abs().max()) / largest for k in ub}
        out_layers = {k: v for k, v in diff.items() if k.startswith(OUTPUT_LAYERS)}
        rest = {k: v for k, v in diff.items() if not k.startswith(OUTPUT_LAYERS)}
        ga, gb = a["fmap_grad"][fmap_index], b["fmap_grad"][fmap_index]
        return {"loss_rel_err": {k: abs(a["metrics"][k] - b["metrics"][k]) / max(abs(b["metrics"][k]), 1e-12)
                                 for k in losses},
                "largest_update": largest,
                "output_layers_diff": max(out_layers.values()),
                "rest_diff": max(rest.values()), "worst_rest_param": max(rest, key=rest.get),
                "fmap_grad_diff": float((ga - gb).abs().max()) / float(gb.abs().max()),
                "relu_flips": {n: int((a["signs"][n] != b["signs"][n]).sum()) for n in signs}}

    rpn_losses, det_losses = LOSS_KEYS[:2], LOSS_KEYS[2:]
    (p_card, p_cpu, p_det) = props[:3]
    return {
        "seed": seed, "lr": lr, "card_s": card["s"], "cpu_s": cpu["s"],
        "proposals_same_params": proposal_sets_unmatched(p_card, p_det),
        "proposals_after_own_rpn_update": proposal_sets_unmatched(p_card, p_cpu),
        "rpn": compare(card, cpu, "rpn", rpn_losses, ("rpn_conv1",), 0),
        "det": compare(card, det, "det", det_losses, ("fc1", "fc2"), 1),
        "step": compare(card, cpu, "det", det_losses, ("fc1", "fc2"), 1),
        "witness_rpn": compare(witness_rpn, cpu, "rpn", rpn_losses, ("rpn_conv1",), 0),
        "witness_det": compare(witness_det, det, "det", det_losses, ("fc1", "fc2"), 1),
    }


def alternating_card_vs_cpu_phase(batch, base, dev, phase: str = "vgg_train_card_vs_cpu") -> dict:
    """Phase vgg_train_card_vs_cpu: alternating_card_vs_cpu's readings,
    gated on identical inputs (the rpn and det comparisons): the proposals
    from the same parameters at most 5% unmatched, losses within 1e-4
    relative, the output layers' updates within 1e-4 of the phase's
    largest, the other updates and the feature map's gradient (the det
    phase's is kernel 2b's) within RELU_NOISE_LIMIT.  Float32 noise flips
    a ReLU whose input is near 0, and a flip changes its gradient by all
    of it: a conv's weight gradient, a sum over the map of random-sign
    terms, moves by ~1/sqrt(terms) of itself, an fc row's (40 RoIs) by
    ~1/6.  The output layers have no ReLU between them and the loss.  The
    step comparison (the CPU after its own RPN update: its fc1 and fc2
    inputs ~1e-4 apart, so tens of flips) and the witnesses are
    reported."""
    r = alternating_card_vs_cpu(batch, base, dev)
    emit({"phase": phase, "network": base.network, "schedule": "alternating", "trunk": "trainable",
          "dtype": "float32", "tf32": False, "batch": 2, "relu_noise_limit": RELU_NOISE_LIMIT, **r})
    missing, total = r["proposals_same_params"]
    check(total > 0 and missing <= 0.05 * total,
          f"{phase}: proposals from the same parameters: {missing} of {total} unmatched")
    for which in ("rpn", "det"):
        c = r[which]
        check(max(c["loss_rel_err"].values()) <= 1e-4, f"{phase}: {which} losses differ: {c['loss_rel_err']}")
        check(c["output_layers_diff"] <= 1e-4, f"{phase}: {which} output layers' updates differ by "
              f"{c['output_layers_diff']} of the largest")
        check(max(c["rest_diff"], c["fmap_grad_diff"]) <= RELU_NOISE_LIMIT,
              f"{phase}: {which}: updates differ by {c['rest_diff']} of the largest "
              f"({c['worst_rest_param']}), the feature map's gradient by {c['fmap_grad_diff']}")
    return r


class GatedSGD:
    """Plain SGD with GatedAdam's interface, for the card-vs-CPU update:
    the update is lr times the gradient where the gate is open."""

    def __init__(self, params, lr: float):
        self.params, self.lr = list(params), lr

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self, gate=None) -> None:
        import torch

        with torch.no_grad():
            for p in self.params:
                if p.grad is not None:
                    scale = -self.lr if gate is None else gate.float() * -self.lr
                    p.add_(p.grad * scale)


# --------------------------------------------------------------------------- #
# VGG16: its kernel shapes, serving, training (alternating), evaluation.
# --------------------------------------------------------------------------- #
VGG_C = 512  # block5_conv3's channels, the map the RoI pool reads


def vgg_config():
    """The default Config with the VGG16 backbone: vgg_fc_dim 4096, canvas
    608, bf16, 12 tiles a batch, 2048 -> 300 proposals, 20 RoIs, batch 8."""
    from radnet_torch.config import Config

    return dataclasses.replace(Config(), network="vgg16", model_path="faster_rcnn_vgg16")


def vgg_kernel_checks(dev) -> dict:
    """Phase vgg_kernels: kernel 2 at (12, 38, 38, 512) x (12, 300) and kernel
    2b at (8, 20) and (12, 300) RoIs with C = 512, P = 7, stride 1, random and
    edge RoIs, bf16 and f32, against their plain versions at kernel2 /
    kernel2_backward's tolerances; the backward bit-equal across two
    launches.  Returns the bf16 random errors."""
    import torch

    from radnet_torch.ops import roi_align

    errs, kw = {}, {"pool_size": 7, "center_stride": 1}
    for dtype in (torch.bfloat16, torch.float32):
        for case, make_inputs in (("random", roi_inputs), ("edges", roi_edge_inputs)):
            fmap, rois = make_inputs(dtype, SEED + 8, dev, c=VGG_C)
            got = roi_align.roi_pool_cuda(fmap, rois, **kw)
            ref = roi_align.roi_pool_plain(fmap.float(), rois, **kw)
            torch.cuda.synchronize()
            ok, max_err, tol = roi_forward_error(got, ref, dtype)
            if dtype == torch.bfloat16 and case == "random":
                errs["roi_pool"] = max_err
            emit({"phase": "vgg_kernels", "kernel": "roi_pool", "rois": case, "shape": list(got.shape),
                  "dtype": str(dtype), "center_stride": 1, "max_abs_err": max_err, "tolerance": tol})
            check(ok, f"roi_pool disagrees with its plain version at VGG16's shape ({case}, {dtype})")
            del fmap, got, ref
    for b, r in BACKWARD_CASES:
        for kind, seed in (("random", 2), ("edges", 3)):
            for dtype in (torch.bfloat16, torch.float32):
                g, rois = roi_backward_inputs(dtype, SEED + 8 + seed, dev, b, r, kind, c=VGG_C)
                got = roi_align.roi_pool_backward_cuda(g, rois, (38, 38), **kw)
                again = roi_align.roi_pool_backward_cuda(g, rois, (38, 38), **kw)
                ref = roi_align.roi_pool_backward_plain(g.float(), rois, (38, 38), **kw)
                torch.cuda.synchronize()
                deterministic = bool(torch.equal(got, again))
                ok, err, top, tol = roi_backward_error(got, ref)
                if (b, r, kind, dtype) == (8, 20, "random", torch.bfloat16):
                    errs["roi_pool_backward"] = err
                emit({"phase": "vgg_kernels", "kernel": "roi_pool_backward",
                      "shape": [b, 38, 38, VGG_C, r, 7], "rois": kind, "dtype": str(dtype),
                      "center_stride": 1, "max_abs_err": err, "largest": top, "tolerance": tol,
                      "deterministic": deterministic})
                check(ok, f"roi_pool_backward disagrees with its plain version at VGG16's width "
                          f"({b}, {r}, {kind}, {dtype})")
                check(deterministic, f"roi_pool_backward gave two results at VGG16's width "
                                     f"({b}, {r}, {kind}, {dtype})")
                del g, got, again, ref
    return errs


def batch_kernel_inputs(net, images, valid_wh) -> dict:
    """One batch of the cascade with the NMS and RoI-pool wrappers wrapped:
    the inputs the serving path gives them."""
    from radnet_torch.ops import nms, roi_align

    got = {"nms": []}
    real = (nms.nms_kept, roi_align.roi_pool_cuda)

    def nms_kept(boxes, scores, valid, thresh):
        got["nms"].append((boxes.clone(), scores.clone(), valid.clone(), thresh))
        return real[0](boxes, scores, valid, thresh)

    def fwd(fmap, rois, **kw):
        got["fwd"] = (fmap.clone(), rois.clone(), kw)
        return real[1](fmap, rois, **kw)

    nms.nms_kept, roi_align.roi_pool_cuda = nms_kept, fwd
    try:
        net._predict_tiles_impl(images, valid_wh)
    finally:
        nms.nms_kept, roi_align.roi_pool_cuda = real
    check(len(got["nms"]) == 2 and "fwd" in got, f"one batch made {len(got['nms'])} NMS calls")
    return got


def vgg_serve_phase(tmp, cfg, dev, kind, smi):
    """Phase vgg_serve: seeded full-width VGG16 weights (output layers
    calibrated) saved to a model dir and served through
    radnet_torch.cli.serve on three 4400 x 3000 grey panels, every batch
    counted: exactly 2 NMS and 1 RoI pool a batch, no grey stem.  Returns
    the RADNet reloaded from the dir, the prescaled first panel, its window
    origins, the run's launches and the calibrated weights."""
    import torch

    from radnet_torch.cli import serve
    from radnet_torch.data.png import write_png
    from radnet_torch.data.tiling import plan_tiles
    from radnet_torch.inference import RADNet, load_radnet, save_radnet
    from radnet_torch.models.detector import build_model, init_weights
    from radnet_torch.ops import cuda_kernels

    gen = torch.Generator().manual_seed(SEED + 8)
    radnet = RADNet(cfg, init_weights(build_model(cfg), gen), device=dev)
    panels = [synthetic_grey_panel(SEED + k) for k in range(N_PANELS)]
    panel3 = bgr(panels[0])
    small, scale, _, _ = radnet._prescale_panel(panel3)
    tiles = plan_tiles(PANEL_HW[1], PANEL_HW[0], cfg.tile_size, cfg.tile_overlap)
    origins = np.round(tiles[:, :2] * scale).astype(np.int64)
    calibrate_heads(radnet, radnet._window_canvases(small, origins[:2]), gen)
    weights = {k: v.detach().cpu() for k, v in radnet.model.state_dict().items()}
    save_radnet(os.path.join(tmp, "models", "vgg"), cfg, radnet.model)
    paths = []
    for k, img in enumerate(panels):
        paths.append(os.path.join(tmp, f"vgg_panel{k}.png"))
        write_png(paths[-1], img)

    cuda_kernels.reset_launch_counts()
    out, err = Stamped(), Stamped(echo=sys.stderr)
    t0 = time.perf_counter()
    real_stderr, sys.stderr = sys.stderr, err
    try:
        with counting_calls(RADNet, "_predict_tiles_impl") as batches:
            rc = serve.main(["--models-path", os.path.join(tmp, "models"), "--model-name", "vgg",
                             "--warmup-size", str(cfg.tile_size), "--device", str(dev)],
                            stdin=io.StringIO("\n".join(paths) + "\n"), stdout=out)
    finally:
        sys.stderr = real_stderr
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = launch_counts()
    check(rc == 0, f"serve exited {rc} on the VGG16 model")
    recs = [json.loads(line) for line in out.getvalue().splitlines()]
    t_ready = next(t for t, line in zip(err.stamps, err.getvalue().splitlines()) if line == "READY")
    results_s = [t - t_ready for t in out.stamps]
    n_b = len(batches)
    emit({"phase": "vgg_serve", "kind": kind, "nvidia_smi": smi, "panels": len(recs),
          "tiles_per_panel": len(tiles), "batches": n_b,
          "detections": [len(r.get("detections", [])) for r in recs],
          "panels_per_s": len(recs) / results_s[-1], "result_s_after_ready": results_s,
          "serve_wall_s": serve_s, "launches": launches})
    check([r.get("path") for r in recs] == paths, f"serve output out of order: {recs}")
    check(all(len(r.get("detections", [])) > 0 for r in recs), "a VGG16 panel has no detections")
    want = {"grey_stem": 0, "nms_fused": 2 * n_b, "roi_pool": n_b, "roi_pool_backward": 0, **NO_INT8}
    check(n_b > 0 and launches == want, f"VGG16 serve launches {launches}, want {want} for {n_b} batches")
    return load_radnet(os.path.join(tmp, "models", "vgg"), device=dev), panel3, small, origins, launches, weights


def vgg_stages_phase(net, panel3, small, origins, kind, smi, errs) -> tuple:
    """Phase vgg_stages: per-stage times of one 12-tile grey batch (trunk,
    RPN + proposals, RoI pool, head, per-class NMS), its launches (exactly 2
    NMS, 1 RoI pool, no grey stem) and FLOPs, a panel's busy and host times;
    then one batch and one panel's dispatch under
    set_sync_debug_mode("error"); and the NMS and RoI-pool kernels on the
    inputs this batch gave them, held against their plain versions and
    timed.  Returns the batch's canvases and the two kernel rows."""
    import torch

    from radnet_torch.geometry import xyxy_to_xywh
    from radnet_torch.ops import cuda_kernels
    from radnet_torch.ops.roi_align import batched_roi_pool

    cfg, dev, model = net.C, net.device, net.model
    images = net._window_canvases(small, origins[: cfg.infer_tile_batch])
    check(images.dim() == 3, f"grey panel canvases are {tuple(images.shape)}, not (T, S, S)")
    valid_wh = torch.full((len(images), 2), float(cfg.img_size), device=dev)
    names = ["trunk", "rpn_proposals", "roi_pool", "head", "class_nms"]

    def stages():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        with torch.inference_mode():
            ev[0].record()
            fmap = net._features(images)
            ev[1].record()
            props = net._proposals(fmap, valid_wh)
            ev[2].record()
            rois = xyxy_to_xywh(props.boxes)
            pooled = batched_roi_pool(fmap.permute(0, 2, 3, 1).contiguous(), rois.contiguous(),
                                      pool_size=model.pool_size, center_stride=model.pool_center_stride)
            ev[3].record()
            b, r = rois.shape[:2]
            cls, regr = model.head(pooled.reshape((b * r,) + pooled.shape[2:]))
            ev[4].record()
            net._detections(cls.reshape(b, r, -1), regr.reshape(b, r, -1), rois, props.valid)
            ev[5].record()
        ev[-1].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))]

    stages()
    runs = [stages() for _ in range(5)]
    stage_ms = {k: statistics.median(r[i] for r in runs) for i, k in enumerate(names)}
    batch_ms = time_cuda(lambda: net._predict_tiles_impl(images, valid_wh), iters=5, warmup=1)
    saved = launch_counts()
    cuda_kernels.reset_launch_counts()
    with count_flops(model) as flops:
        net._predict_tiles_impl(images, valid_wh)
    per_batch = launch_counts()
    for k in cuda_kernels.KERNELS:  # the served run's counts stay the reported ones
        k.launches = saved[k.name]
    panel_wall_ms, panel_busy_ms = device_busy(lambda: net.predict([panel3]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = net.predict_dispatch([panel3])
    t1 = time.perf_counter()
    net.predict_collect(pending)
    t2 = time.perf_counter()
    emit({"phase": "vgg_stages", "kind": kind, "nvidia_smi": smi, "batch_tiles": len(images),
          "stage_ms": stage_ms, "batch_ms": batch_ms, "launches_per_batch": per_batch,
          "tflop_per_batch": {k: v / 1e12 for k, v in flops.items()},
          "tflop_per_s": {"trunk": flops["trunk"] / stage_ms["trunk"] / 1e9,
                          "head": flops["head"] / stage_ms["head"] / 1e9},
          "panel_predict_ms": panel_wall_ms, "panel_device_busy_ms": panel_busy_ms,
          "panel_device_idle_share": 1.0 - panel_busy_ms / panel_wall_ms,
          "panel_host_ms": {"dispatch": (t1 - t0) * 1e3, "collect": (t2 - t1) * 1e3}})
    want = {"grey_stem": 0, "nms_fused": 2, "roi_pool": 1, "roi_pool_backward": 0, **NO_INT8}
    check(per_batch == want, f"a VGG16 batch launched {per_batch}, want {want}")

    sync_free_phase(net, images, panel3, phase="vgg_sync_free")

    got = batch_kernel_inputs(net, images, valid_wh)
    where = "the VGG16 serving batch's inputs"
    nms_rows = {site: nms_row(*sets, where) for site, sets in zip(("proposal", "per_class"), got["nms"])}
    fwd, _, _ = roi_forward_row(*got["fwd"], where)
    f = cfg.feat_size
    check(fwd["shape"] == [len(images), f, f, VGG_C, cfg.post_nms_top_n, 7] and fwd["center_stride"] == 1,
          f"the VGG16 batch pooled {fwd['shape']} at stride {fwd['center_stride']}")
    fwd["max_abs_err_random_inputs"] = errs["roi_pool"]
    emit({"phase": "vgg_kernels_main_path", "nms_fused": nms_rows, "roi_pool": fwd})
    return images, {"nms_fused": nms_rows, "roi_pool": fwd}, per_batch


def vgg_predict_phase(tmp, net, kind, smi) -> dict:
    """Phase vgg_predict: radnet_torch.cli.predict on a scan directory of
    grey panels with the VGG16 model: 2 NMS for each RoI pool, no stem."""
    import torch

    from radnet_torch.cli import predict
    from radnet_torch.data.png import write_png
    from radnet_torch.ops import cuda_kernels

    scan = os.path.join(tmp, "scan_vgg")
    for k, img_type in enumerate(net.C.img_types + ["blended_map_grey"]):
        path = predict.resolve_type_path(scan, img_type)
        path.parent.mkdir(parents=True, exist_ok=True)
        write_png(str(path), synthetic_grey_panel(SEED + 30 + k))
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = predict.main(["--models-path", os.path.join(tmp, "models"), "--model-name", "vgg",
                           "--scan-data-path", scan, "--device", str(net.device)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    with open(os.path.join(scan, "arrays", "predictions.json")) as f:
        preds = json.load(f)
    emit({"phase": "vgg_predict_cli", "kind": kind, "nvidia_smi": smi, "detections": len(preds),
          "wall_s": wall_s, "launches": launches})
    check(rc == 0 and len(preds) > 0, f"predict on the VGG16 model: rc {rc}, {len(preds)} detections")
    check(launches["roi_pool"] > 0 and launches["nms_fused"] == 2 * launches["roi_pool"]
          and launches["grey_stem"] == 0, f"VGG16 predict launches {launches}")
    return launches


def vgg_evaluate_phase(tmp: str, dev, smi, serve_weights: dict, n_panels: int = 6) -> dict:
    """Phase vgg_evaluate: radnet_torch.cli.test --coco-map on the VGG16
    directory cli.train wrote, over the first ``n_panels`` of the evaluate
    phase's test set (exactly 2 NMS and 1 RoI pool a batch, no stem), and
    the calibrated VGG16 serving weights on one panel, float32 card vs CPU:
    at most 5% unmatched; the mAP against the panel's boxes above 0 and
    within 0.005; the mAP against every second CPU detection within
    VGG_PSEUDO_GT_MAP_LIMIT."""
    from radnet_torch.cli import test
    from radnet_torch.config import Config
    from radnet_torch.data.dataset import get_data, get_image
    from radnet_torch.inference import RADNet
    from radnet_torch.ops import cuda_kernels

    models = os.path.join(tmp, "train_models")
    name = "faster_rcnn_vgg16_alt"
    d = os.path.join(tmp, "data")
    test_csv, test_dir = os.path.join(d, "test.csv"), os.path.join(d, "test")
    cuda_kernels.reset_launch_counts()
    with counting_calls(RADNet, "_predict_tiles_impl") as batches:
        rc, stdout, test_s = run_cli(test.main, [
            "--models-path", models, "--model-name", name, "--test-annot", test_csv,
            "--test-data", test_dir, "--device", str(dev), "--coco-map", "--limit", str(n_panels)])
    launches = launch_counts()
    with open(os.path.join(models, name, "test_accuracy.json")) as f:
        acc = json.load(f)
    seconds = {k: float(line.split(": ")[1].rstrip("s")) for line in stdout.getvalue().splitlines()
               for k in ("Average prediction time", "Steady-state prediction time (excl. first panel)")
               if line.startswith(k + ": ")}

    cfg = Config.load(os.path.join(models, name, "config.json"))
    data, _, _ = get_data(test_csv, test_dir, cfg.img_types)
    dets = map_card_vs_cpu(serve_weights, cfg, dev, get_image(data[0]["filepath"], cfg.img_types),
                           data[0]["bboxes"])
    shown = {f: v for f, v in dets.items() if f not in ("card", "cpu")}
    n_b = len(batches)
    emit({"phase": "vgg_evaluate", "nvidia_smi": smi, "panels": n_panels, "wall_s": test_s,
          "sec_per_panel": seconds, "batches": n_b, "launches": launches, "mAP": acc.get("mAP"),
          "card_vs_cpu": shown})
    check(rc == 0 and "mAP" in acc, f"cli.test on the VGG16 model: rc {rc}, {sorted(acc)}")
    want = {"grey_stem": 0, "nms_fused": 2 * n_b, "roi_pool": n_b, "roi_pool_backward": 0, **NO_INT8}
    check(n_b > 0 and launches == want, f"VGG16 cli.test launches {launches}, want {want}")
    check(dets["n_card"] > 0 and dets["unmatched"] <= 0.05 * (dets["n_card"] + dets["n_cpu"]),
          f"VGG16 detections: {dets['unmatched']} unmatched card vs CPU")
    # Against the panel's boxes the random weights score little but not 0;
    # against the pseudo ground truth two detections that float32 noise
    # moves shift the mAP by 0.0139 (VGG_PSEUDO_GT_MAP_LIMIT).
    check(dets["map_cpu"] > 0, f"the VGG16 detections scored nothing against the panel's boxes: {shown}")
    check(abs(dets["map_card"] - dets["map_cpu"]) <= 0.005,
          f"VGG16 calibrated detections: mAP card {dets['map_card']} vs CPU {dets['map_cpu']}")
    check(dets["map_pseudo_gt_cpu"] > 0, f"the VGG16 pseudo ground truth scored nothing: {shown}")
    gap = abs(dets["map_pseudo_gt_card"] - dets["map_pseudo_gt_cpu"])
    check(gap <= VGG_PSEUDO_GT_MAP_LIMIT,
          f"VGG16 calibrated detections: pseudo-ground-truth mAP card vs CPU {gap} apart")
    return launches


# --------------------------------------------------------------------------- #
# The int8 RoI head (infer_quantize="int8"): its two kernels, then serve,
# predict and test through it, on both backbones.
# --------------------------------------------------------------------------- #
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor cores
# (layer, backbone, activation shape, its type, weight shape, the epilogue the
# head runs): the products a 12-tile serving batch (3600 RoIs) runs;
# ResNet50's weights (O, C, kh, kw), VGG16's (O, D).
INT8_CASES = [
    ("s5a.conv2a", "resnet50", (3600, 7, 7, 1024), "bfloat16", (512, 1024, 1, 1), "bn_relu"),
    ("s5a.conv_sc", "resnet50", (3600, 7, 7, 1024), "bfloat16", (2048, 1024, 1, 1), "bn"),
    ("conv2b", "resnet50", (3600, 7, 7, 512), "bfloat16", (512, 512, 3, 3), "bn_relu"),
    ("conv2c", "resnet50", (3600, 7, 7, 512), "bfloat16", (2048, 512, 1, 1), "bn_res_relu"),
    ("s5b.conv2a", "resnet50", (3600, 7, 7, 2048), "bfloat16", (512, 2048, 1, 1), "bn_relu"),
    ("fc1", "vgg16", (3600, 25088), "bfloat16", (4096, 25088), "relu"),
    ("fc2", "vgg16", (3600, 4096), "float32", (4096, 4096), "relu"),
]
# The epilogues every case is held to, (kind, the batch norm's type): float32
# out, its ReLU, and the batch norm in bf16 and in float32 (the float32 model
# int8_card_vs_cpu runs), alone, with ReLU, and with the residual sum and ReLU.
INT8_EPILOGUES = [("float", None), ("relu", None)] + [
    (kind, dt) for dt in ("bfloat16", "float32") for kind in ("bn", "bn_relu", "bn_res_relu")]
# How often a serving batch runs each case's product (conv2b, conv2c and
# s5b's conv2a stand for their twins in s5b and s5c) and quantizes its
# activations (s5a.conv_sc reads s5a.conv2a's quantized input).
INT8_BATCH_USES = {"s5a.conv2a": (1, 1), "s5a.conv_sc": (1, 0), "conv2b": (3, 3), "conv2c": (3, 3),
                   "s5b.conv2a": (2, 2), "fc1": (1, 1), "fc2": (1, 1)}
# Launches of one serving batch through the int8 head (a grey batch: one
# grey stem on ResNet50): 10 products and 9 + 10 quantizations on
# ResNet50's stage 5, 2 and 2 + 2 on VGG16's fc1 / fc2.
INT8_PER_BATCH = {
    "resnet50": {"nms_fused": 2, "roi_pool": 1, "grey_stem": 1, "roi_pool_backward": 0,
                 "quantize_rows": 19, "int8_gemm": 10},
    "vgg16": {"nms_fused": 2, "roi_pool": 1, "grey_stem": 0, "roi_pool_backward": 0,
              "quantize_rows": 4, "int8_gemm": 2},
}
# Card against CPU through the int8 head, float32 (limits from readings of
# scripts/int8_card_vs_cpu_probe.py, PERF.md section 6): the head's
# outputs on identical pooled inputs, as a share of their largest magnitude,
# and the detections of a 2-tile batch without a partner.
# Readings (the probe on an NVIDIA H100 80GB HBM3 at 700.00 W, three weight
# seeds a backbone): the head 1.1e-5 - 1.5e-5 apart (ResNet50), 3.3e-6 -
# 4.0e-6 (VGG16); 1.1-2.8% of the detections unmatched at INT8_PROB_TOL.
# With the product fed a map one column off (ResNet50) or rows one RoI off
# (VGG16): the head 0.34-2.0 apart, 73% and 100% unmatched.
INT8_HEAD_LIMIT = 1e-4
INT8_UNMATCHED_SHARE = 0.10
# The PyTorch ops that would be separate passes over the head's activations.
HEAD_ELEMENTWISE_OPS = {"aten::_to_copy", "aten::copy_", "aten::mul", "aten::mul_", "aten::add",
                        "aten::add_", "aten::relu", "aten::relu_", "aten::clamp_min",
                        "aten::clamp_min_", "aten::threshold", "aten::where"}
# Device work (kernels, copies, fills) of one int8 RoI pool + head call
# (device_work_per_call), pinned at the count read on an NVIDIA H100 80GB
# HBM3: the RoI pool, the 10 / 2 products and the 19 / 4 quantizations, and
# the small work beside them (each of ResNet50's ten batch norms' k and b
# on (C,) vectors, the 3x3 weights' K-major copies, the boxes' conversion,
# the average pool and the output layers).  A pass over the activations
# put back between two products raises it.
INT8_HEAD_KERNELS = {"resnet50": 114, "vgg16": 19}
INT8_PROB_TOL = 0.05  # a detection's partner: the same class and box, confidences this close
INT8_HEAD_ROIS = 64  # RoIs a tile in the head comparison, to keep the CPU side short


def kernel_ms(fn, symbol: str) -> float:
    """device_ms, or the CUDA-event median where the profiler saw no such
    kernel."""
    ms = device_ms(fn, symbol)
    return ms if ms is not None else time_cuda(fn)


def int8_case_inputs(case, dev, seed: int):
    """Seeded activations (|N(0, 1)|, non-negative as ReLU outputs but with
    no zero; per-sample magnitudes over four decades; sample 1 all zero, so
    its scale sits at the floor), weights
    (lecun-normal, output channel 7 a hundred times larger) and a bias, all
    made on the card."""
    import math

    import torch

    _, _, a_shape, a_dtype, w_shape, _ = case
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(a_shape, generator=g, device=dev).abs_()
    x *= torch.logspace(-2, 2, a_shape[0], device=dev).view(-1, *[1] * (len(a_shape) - 1))
    x[1] = 0.0
    w = torch.randn(w_shape, generator=g, device=dev) / math.sqrt(math.prod(w_shape[1:]))
    w[7] *= 100.0
    bias = torch.randn(w_shape[0], generator=g, device=dev) * 0.1
    return x.to(getattr(torch, a_dtype)), w, bias


def int8_epilogue_inputs(m: int, n: int, dev, seed: int) -> dict:
    """A batch norm's (k, b) (k in [0.5, 1.5), b around 0: a share of the
    outputs goes negative, so the ReLU acts) and an (m, n) residual, in
    bf16 and float32, made on the card: {dtype name: (bn, residual)}."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.rand(n, generator=g, device=dev) + 0.5
    b = torch.randn(n, generator=g, device=dev) * 0.5
    res = torch.randn((m, n), generator=g, device=dev)
    return {name: ((k.to(dt), b.to(dt)), res.to(dt))
            for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32))}


def int8_epilogue_kwargs(kind: str, epi: dict, dtype: str) -> dict:
    """The epilogue keyword arguments of int8_gemm for ``kind`` ("float",
    "relu", or "bn", "bn_relu", "bn_res_relu" with the batch norm and
    residual of int8_epilogue_inputs in ``dtype``)."""
    if kind in ("float", "relu"):
        return {"relu": kind == "relu"}
    bn, res = epi[dtype]
    return {"bn": bn, "residual": res if kind == "bn_res_relu" else None, "relu": kind != "bn"}


def earlier_int8_gemm(kernel, a, b, bias, rows_per_sample: int):
    """The earlier int8 product (csrc/earlier/int8_gemm_mma_sync.cu) as its
    wrapper ran it: float32 out, the dequantize and the bias."""
    import torch

    from radnet_torch.ops.cuda_kernels import ptr

    aq, bq = a.q, b.q
    n, k = bq.shape
    if aq.dim() == 4:
        r, h, w, c = aq.shape
        m, rows_per_sample, conv = r * h * w, h * w, (h, w, c)
    else:
        m, conv = aq.shape[0], (0, 0, 0)
    out = torch.empty((m, n), dtype=torch.float32, device=aq.device)
    kernel.launch(ptr(aq), ptr(a.scale), ptr(bq), ptr(b.scale), None if bias is None else ptr(bias),
                  ptr(out), m, n, k, rows_per_sample, *conv, 0)
    return out


def int8_operands(x, w):
    """(A as the kernel reads it, rows a sample, the weight's rows) of a
    case: a 1x1 conv's map as (M, C) rows, a 3x3's as the map itself."""
    from radnet_torch.ops import quant

    wrows = quant.conv_weight_rows(w) if w.dim() == 4 else w.contiguous()
    xq = quant.quantize_rows_cuda(x)
    if x.dim() == 2:
        return xq, 1, wrows
    if w.shape[-1] == 3:
        return xq, 49, wrows
    return quant.Quantized(xq.q.reshape(-1, x.shape[-1]), xq.scale), 49, wrows


def int8_kernel_checks(dev, earlier: dict) -> dict:
    """Phase int8_kernels: the quantizer and the int8 product at every shape
    a serving batch gives them, against their plain versions: q and the
    scales bit-equal (activations and weights); the int32 sums bit-equal on
    every row at a small M (8 samples) and on every 37th sample at the full
    M; the outputs bit-equal on every row under each of INT8_EPILOGUES (the
    3x3 conv's edge rows counted); the earlier kernel's float32 output
    bit-equal to the new kernel's; the quantizer also on the activations
    with a seeded half of their values zeroed, as the head's ReLU outputs
    are; then each timed with the epilogue the head runs there (device ms, its bound, plain ms, the library path:
    torch._int_mm, the dequantize and the eager epilogue passes), beside
    the earlier kernel and the new one's float32 epilogue, the quantizer on
    the half-zero activations (and on the unzeroed ones beside).  Returns
    the kernels line's two rows."""
    import torch

    from radnet_torch.ops import quant

    rows = []
    for i, case in enumerate(INT8_CASES):
        name, backbone, a_shape, a_dtype, w_shape, head_epi = case
        x, w, bias = int8_case_inputs(case, dev, SEED + 40 + i)
        # The head quantizes ReLU outputs (int8_batch's quantizer_in_head: 15-52%
        # zeros), and zeros slow the kernel: it is timed on x with a seeded half
        # of its values zeroed, as a ReLU leaves them, and on x itself beside.
        gz = torch.Generator(device=dev).manual_seed(SEED + 80 + i)
        xr = x.masked_fill(torch.rand(x.shape, generator=gz, device=dev) < 0.5, 0)
        a, rps, wrows = int8_operands(x, w)
        xq = quant.quantize_rows_cuda(x)
        wq = quant.quantize_rows_cuda(wrows)
        for what, v, got in (("activations", x, xq), ("ReLU-output activations", xr, quant.quantize_rows_cuda(xr)),
                             ("weights", wrows, wq)):
            ref = quant.quantize_rows_plain(v)
            torch.cuda.synchronize()
            check(torch.equal(got.q, ref.q) and torch.equal(got.scale, ref.scale),
                  f"quantize_rows disagrees with its plain version on {name}'s {what}")
            del got, ref

        conv3 = a.q.dim() == 4
        m, n, k = (a.q.shape[0] * (49 if conv3 else 1), wq.q.shape[0], wq.q.shape[1])
        border = None
        if conv3:  # the rows of the 7 x 7 map's border, where taps fall off it
            y = torch.arange(49, device=dev) // 7
            xx = torch.arange(49, device=dev) % 7
            border = ((y == 0) | (y == 6) | (xx == 0) | (xx == 6)).repeat(a_shape[0])
        v_ref = quant.int8_gemm_plain(a, wq, bias, rps)  # float32: the plain epilogues start here
        epi = int8_epilogue_inputs(m, n, dev, SEED + 60 + i)
        max_err, equal = 0.0, {}
        for kind, dt in INT8_EPILOGUES:
            kw = int8_epilogue_kwargs(kind, epi, dt)
            kind = kind if dt is None else f"{kind}_{dt}"
            out = quant.int8_gemm_cuda(a, wq, bias, rps, **kw)
            ref = quant.epilogue_plain(v_ref, **kw)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            max_err = max(max_err, float(diff.max()))
            if border is not None:
                check(float(diff[border].max()) == 0.0, f"int8_gemm: {name}'s edge rows differ ({kind})")
            equal[kind] = bool(torch.equal(out, ref))
            check(equal[kind], f"int8_gemm disagrees with its plain version on {name} under the "
                               f"{kind} epilogue: max |diff| {float(diff.max())}")
            if kind == "relu":
                check(bool((out == 0).any()) and bool((out > 0).any()), f"{name}: the ReLU did nothing")
            del out, ref, diff
        out = quant.int8_gemm_cuda(a, wq, bias, rps)
        old = earlier_int8_gemm(earlier["int8_gemm"], a, wq, bias, rps)
        torch.cuda.synchronize()
        check(torch.equal(old, out), f"the earlier int8 product disagrees with the new one on {name}")
        del old

        samples = torch.arange(0, a_shape[0], 37, device=dev)
        small = slice(0, 8)
        acc = quant.int8_gemm_acc_cuda(a.q, wq.q)
        if conv3:
            acc_rows = acc.reshape(a_shape[0], 49, -1)[samples].reshape(-1, acc.shape[-1])
            ref_rows = quant.int8_gemm_acc_plain(a.q[samples], wq.q)
            acc_small = quant.int8_gemm_acc_cuda(a.q[small].contiguous(), wq.q)
            ref_small = quant.int8_gemm_acc_plain(a.q[small], wq.q)
        else:
            sel = (samples[:, None] * rps + torch.arange(rps, device=dev)).reshape(-1)
            acc_rows, ref_rows = acc[sel], quant.int8_gemm_acc_plain(a.q[sel], wq.q)
            acc_small = quant.int8_gemm_acc_cuda(a.q[: 8 * rps].contiguous(), wq.q)
            ref_small = quant.int8_gemm_acc_plain(a.q[: 8 * rps], wq.q)
        torch.cuda.synchronize()
        check(torch.equal(acc_rows, ref_rows) and torch.equal(acc_small, ref_small),
              f"int8_gemm's int32 sums disagree with the plain version's on {name}")
        del acc, acc_rows, ref_rows, v_ref

        head_kw = int8_epilogue_kwargs(head_epi, epi, a_dtype)
        a2d = (lambda: quant.im2col_3x3(a.q)) if conv3 else (lambda: a.q)

        def library(a2d=a2d, wq=wq, a=a, rps=rps, bias=bias, kw=head_kw):
            v = quant.dequantize(torch._int_mm(a2d(), wq.q.t()), a.scale, wq.scale, bias, rps)
            return quant.epilogue_plain(v, **kw)

        fused = quant.int8_gemm_cuda(a, wq, bias, rps, **head_kw)
        lib_err = float((library().float() - fused.float()).abs().max())
        out_bytes = m * n * fused.element_size()
        res = head_kw.get("residual")
        g_bound, g_by = bound_ms(a.q.numel() + wq.q.numel() + 4 * (a.scale.numel() + 3 * n) + out_bytes
                                 + (0 if res is None else res.numel() * res.element_size()),
                                 2.0 * m * n * k, INT8_OPS_PER_S)
        x_bound, x_by = bound_ms(x.numel() * (x.element_size() + 1) + 4 * a_shape[0], 4.0 * x.numel())
        w_bound, w_by = bound_ms(wrows.numel() * 5 + 4 * wrows.shape[0], 4.0 * wrows.numel())
        del fused
        row = {
            "layer": name, "backbone": backbone, "m": m, "n": n, "k": k, "a_type": a_dtype,
            "implicit_3x3": conv3, "edge_rows_compared": int(border.sum()) if conv3 else 0,
            "epilogues_equal": equal, "head_epilogue": head_epi,
            "gemm_ms": kernel_ms(lambda: quant.int8_gemm_cuda(a, wq, bias, rps, **head_kw),
                                 "int8_gemm_wgmma"),
            "gemm_float_ms": kernel_ms(lambda: quant.int8_gemm_cuda(a, wq, bias, rps), "int8_gemm_wgmma"),
            "gemm_earlier_ms": kernel_ms(lambda: earlier_int8_gemm(earlier["int8_gemm"], a, wq, bias, rps),
                                         "int8_gemm_kernel"),
            "gemm_plain_ms": time_cuda(lambda: quant.int8_gemm_plain(a, wq, bias, rps, **head_kw),
                                       iters=3, warmup=1),
            "gemm_library_ms": time_cuda(library, iters=5, warmup=1),
            "gemm_library_max_abs_diff": lib_err,
            "gemm_bound_ms": g_bound, "gemm_bound_by": g_by, "gemm_max_abs_err": max_err,
            "quantize_x_ms": kernel_ms(lambda: quant.quantize_rows_cuda(xr), "quantize_rows_kernel"),
            "quantize_x_zero_share": float((xr == 0).float().mean()),
            "quantize_x_no_zeros_ms": kernel_ms(lambda: quant.quantize_rows_cuda(x), "quantize_rows_kernel"),
            "quantize_x_plain_ms": time_cuda(lambda: quant.quantize_rows_plain(xr), iters=3, warmup=1),
            "quantize_x_bound_ms": x_bound, "quantize_x_bound_by": x_by,
            "quantize_w_ms": kernel_ms(lambda: quant.quantize_rows_cuda(wrows), "quantize_rows_kernel"),
            "quantize_w_plain_ms": time_cuda(lambda: quant.quantize_rows_plain(wrows), iters=3, warmup=1),
            "quantize_w_bound_ms": w_bound, "quantize_w_bound_by": w_by,
        }
        row["gemm_tops"] = 2.0 * m * n * k / row["gemm_ms"] / 1e9
        row["gemm_bound_share"] = g_bound / row["gemm_ms"]
        emit({"phase": "int8_kernels", **row})
        rows.append(row)
        del x, xr, w, a, xq, wq, out, epi
        torch.cuda.empty_cache()
    return int8_kernel_rows(rows)


def int8_kernel_rows(rows: list) -> dict:
    """The kernels line's rows of the two int8 kernels: the numbers of one
    serving batch of the ResNet50 head (each case as often as the batch
    runs it), the VGG16 head's beside them, every case under "shapes"."""
    def batch(backbone, keys, use):
        out = {}
        for key in keys:
            out[key] = sum(r[key] * INT8_BATCH_USES[r["layer"]][use] for r in rows
                           if r["backbone"] == backbone)
        return out

    gemm_keys = ("gemm_ms", "gemm_plain_ms", "gemm_library_ms", "gemm_bound_ms", "gemm_earlier_ms",
                 "gemm_float_ms")
    line = {}
    for kernel, source, replaces, keys in (
        ("int8_gemm", "radnet_torch/csrc/int8_gemm.cu", "radnet_tpu/models/quant.py:59", gemm_keys),
        ("quantize_rows", "radnet_torch/csrc/quantize_rows.cu", "radnet_tpu/models/quant.py:45", None),
    ):
        per = {}
        for backbone in ("resnet50", "vgg16"):
            if keys:
                b = batch(backbone, keys, 0)
                per[backbone] = {"ms": b["gemm_ms"], "plain_ms": b["gemm_plain_ms"],
                                 "library_ms": b["gemm_library_ms"], "bound_ms": b["gemm_bound_ms"],
                                 "earlier_ms": b["gemm_earlier_ms"], "float_epilogue_ms": b["gemm_float_ms"]}
            else:  # activations as often as they are quantized, weights once a product
                xs = batch(backbone, ("quantize_x_ms", "quantize_x_no_zeros_ms", "quantize_x_plain_ms",
                                      "quantize_x_bound_ms"), 1)
                ws = batch(backbone, ("quantize_w_ms", "quantize_w_plain_ms", "quantize_w_bound_ms"), 0)
                per[backbone] = {"ms": xs["quantize_x_ms"] + ws["quantize_w_ms"],
                                 "no_zeros_ms": xs["quantize_x_no_zeros_ms"] + ws["quantize_w_ms"],
                                 "plain_ms": xs["quantize_x_plain_ms"] + ws["quantize_w_plain_ms"],
                                 "library_ms": None,
                                 "bound_ms": xs["quantize_x_bound_ms"] + ws["quantize_w_bound_ms"]}
        # The batch's bound is a sum of its launches' bounds: it is bound by
        # whichever of bytes and operations bounds the larger part of it.
        by_key, bound_key = (("gemm_bound_by", "gemm_bound_ms") if keys
                             else ("quantize_x_bound_by", "quantize_x_bound_ms"))
        share = {"bytes": 0.0, "operations": 0.0}
        for r in rows:
            if r["backbone"] == "resnet50":
                share[r[by_key]] += r[bound_key] * INT8_BATCH_USES[r["layer"]][0 if keys else 1]
        line[kernel] = {
            "name": kernel, "route": "cuda", "source": source, "replaces": replaces,
            **({"replaces_also": "radnet_tpu/models/quant.py:78 int8_dense, and the stage-5 "
                                 "FrozenBatchNorm, residual sum and ReLUs XLA fuses after them "
                                 "(radnet_tpu/models/resnet.py:99-117; no Pallas kernel)",
                "earlier_source": "radnet_torch/csrc/earlier/int8_gemm_mma_sync.cu"} if keys else
               {"replaces_also": "no Pallas kernel: XLA's reduction and rounding",
                "inputs": "activations with a seeded half of their values zero, as ReLU outputs; "
                          "no_zeros_ms: the same values with none zeroed"}),
            "shape": "one 12-tile serving batch of the ResNet50 int8 head (3600 RoIs)",
            **per["resnet50"], "bound_by": max(share, key=share.get), "bound_by_share": share,
            "vgg16_batch": per["vgg16"],
            "max_abs_err": max(r["gemm_max_abs_err"] for r in rows) if keys else 0.0,
            "shapes": [{k: v for k, v in r.items()
                        if (k.startswith("gemm") if keys else k.startswith("quantize"))
                        or k in ("layer", "backbone", "m", "n", "k", "a_type", "implicit_3x3",
                                 "edge_rows_compared", "epilogues_equal", "head_epilogue")}
                       for r in rows],
        }
    line["int8_gemm"]["library"] = ("torch._int_mm on (M, K) rows (a 3x3 conv's explicit im2col "
                                     "first: pad and 9 slices), the dequantize, then the head's "
                                     "eager cast, batch norm, residual sum and ReLU passes")
    return line


def tile_detections(out, n_fg: int) -> list:
    """A tile cascade's (boxes, scores, valid) as detection dicts, the tile
    folded into the class, for ``unmatched``."""
    boxes, scores, valid = (t.cpu().numpy() for t in out)
    dets = []
    for t in range(boxes.shape[0]):
        for k in range(n_fg):
            for b, s in zip(boxes[t, k][valid[t, k]], scores[t, k][valid[t, k]]):
                dets.append({"class": (t, k), "x1": b[0], "y1": b[1], "x2": b[2], "y2": b[3],
                             "prob": float(s)})
    return dets


def int8_serve_phase(tmp, model_name, paths, network, dev, kind, smi, phase) -> dict:
    """Phase int8_serve (and vgg_int8_serve): radnet_torch.cli.serve
    --quantize int8 on a saved model dir over the serving panels, every
    batch counted: the launches of INT8_PER_BATCH exactly, a grey stem
    for each grey ResNet50 batch.  Returns the run's launches, batches and
    panels/s."""
    import torch

    from radnet_torch.cli import serve
    from radnet_torch.inference import RADNet
    from radnet_torch.ops import cuda_kernels

    cfg_tile = json.load(open(os.path.join(tmp, "models", model_name, "config.json")))["tile_size"]
    cuda_kernels.reset_launch_counts()
    out, err = Stamped(), Stamped(echo=sys.stderr)
    real_stderr, sys.stderr = sys.stderr, err
    t0 = time.perf_counter()
    try:
        with counting_calls(RADNet, "_predict_tiles_impl", lambda images, *_: images.dim()) as batches:
            rc = serve.main(["--models-path", os.path.join(tmp, "models"), "--model-name", model_name,
                             "--warmup-size", str(cfg_tile), "--device", str(dev), "--quantize", "int8"],
                            stdin=io.StringIO("\n".join(paths) + "\n"), stdout=out)
    finally:
        sys.stderr = real_stderr
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = launch_counts()
    check(rc == 0, f"{phase}: serve --quantize int8 exited {rc}")
    recs = [json.loads(line) for line in out.getvalue().splitlines()]
    t_ready = next(t for t, line in zip(err.stamps, err.getvalue().splitlines()) if line == "READY")
    results_s = [t - t_ready for t in out.stamps]
    n_b = len(batches)
    want = {k: v * n_b for k, v in INT8_PER_BATCH[network].items()}
    if network == "resnet50":
        want["grey_stem"] = batches.count(3)
    emit({"phase": phase, "kind": kind, "nvidia_smi": smi, "network": network, "panels": len(recs),
          "batches": n_b, "grey_batches": batches.count(3),
          "detections": [len(r.get("detections", [])) for r in recs],
          "panels_per_s": len(recs) / results_s[-1], "result_s_after_ready": results_s,
          "serve_wall_s": serve_s, "launches": launches})
    check([r.get("path") for r in recs] == paths, f"{phase}: serve output out of order: {recs}")
    check(all(len(r.get("detections", [])) > 0 for r in recs), f"{phase}: a panel has no detections")
    check(n_b > 0 and launches == want, f"{phase}: launches {launches}, want {want} for {n_b} batches")
    return {"launches": launches, "batches": n_b, "panels_per_s": len(recs) / results_s[-1]}


def int8_batch_phase(net8, netf, images, panel3, kind, smi, phase) -> dict:
    """Phase int8_batch (and vgg_int8_batch): one 12-tile grey batch through
    the int8 head: its launches exactly (INT8_PER_BATCH); the RoI pool +
    head and the whole batch timed in turns with the float head (float,
    int8, int8, float), the int8 head's device time by kernel; the batch and
    a panel's dispatch under the sync check; and the int8 detections against
    the float ones on the card.  Returns the per-batch launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from radnet_torch.ops import cuda_kernels, quant

    cfg, dev = net8.C, net8.device
    valid_wh = torch.full((len(images), 2), float(cfg.img_size), device=dev)
    with torch.inference_mode():
        fmap = net8._features(images)
        props = net8._proposals(fmap, valid_wh)
    saved = launch_counts()
    cuda_kernels.reset_launch_counts()
    out8 = net8._predict_tiles_impl(images, valid_wh)
    torch.cuda.synchronize()
    per_batch = launch_counts()
    for k in cuda_kernels.KERNELS:  # the served run's counts stay the reported ones
        k.launches = saved[k.name]
    check(per_batch == INT8_PER_BATCH[cfg.network],
          f"{phase}: a batch launched {per_batch}, want {INT8_PER_BATCH[cfg.network]}")

    times = {"int8": {"head": [], "batch": []}, "float": {"head": [], "batch": []}}
    for which in ("float", "int8", "int8", "float"):
        net = net8 if which == "int8" else netf
        with torch.inference_mode():
            times[which]["head"].append(time_cuda(lambda: net._head(fmap, props), iters=5, warmup=1))
        times[which]["batch"].append(
            time_cuda(lambda: net._predict_tiles_impl(images, valid_wh), iters=5, warmup=1))
    quantized = []  # (shape, dtype) of each quantizer launch, in launch order
    real_q = quant.quantize_rows_cuda

    def recording(x):
        quantized.append((list(x.shape), str(x.dtype).removeprefix("torch.")))
        return real_q(x)

    quant.quantize_rows_cuda = recording
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
            with torch.inference_mode():
                for _ in range(3):
                    net8._head(fmap, props)
            torch.cuda.synchronize()
    finally:
        quant.quantize_rows_cuda = real_q
    by_kernel = {"int8_gemm_wgmma": 0.0, "quantize_rows_kernel": 0.0, "roi_pool_kernel": 0.0,
                 "other": 0.0}
    q_events = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = next((k for k in by_kernel if k in e.name), "other")
            by_kernel[key] += (e.time_range.end - e.time_range.start) / 3e3
            if key == "quantize_rows_kernel":
                q_events.append((e.time_range.start, (e.time_range.end - e.time_range.start) / 1e3))
    quantizer = quantizer_in_head(net8, fmap, props, quantized, sorted(q_events))
    # The head's activations leave each product in their final form: no
    # elementwise PyTorch op (cast, batch norm, sum, ReLU) may read a tensor
    # of 4096 values a RoI or more (VGG16's fc activations; ResNet50's stage
    # 5 holds 25 088 or more; the pooled 2048 that the output layers read
    # are below).
    n_rois = int(props.boxes.shape[0] * props.boxes.shape[1])
    passes = sorted({(e.name, str(e.input_shapes)) for e in prof.events()
                     if e.device_type == DeviceType.CPU and e.name in HEAD_ELEMENTWISE_OPS
                     and any(math.prod(sh) >= 4096 * n_rois for sh in e.input_shapes if sh)})
    with torch.inference_mode():
        head_kernels = device_work_per_call(lambda: net8._head(fmap, props))
    outf = netf._predict_tiles_impl(images, valid_wh)
    n_fg = cfg.n_classes - 1
    d8, df = tile_detections(out8, n_fg), tile_detections(outf, n_fg)
    emit({"phase": phase, "kind": kind, "nvidia_smi": smi, "network": cfg.network,
          "batch_tiles": len(images), "rois": int(props.boxes.shape[0] * props.boxes.shape[1]),
          "launches_per_batch": per_batch,
          "roi_pool_head_ms": {k: statistics.median(v["head"]) for k, v in times.items()},
          "batch_ms": {k: statistics.median(v["batch"]) for k, v in times.items()},
          "turns_ms": times, "int8_head_device_ms_by_kernel": by_kernel,
          "quantizer_in_head": quantizer,
          "int8_head_device_kernels": head_kernels, "int8_head_elementwise_passes": passes,
          "detections_int8": len(d8), "detections_float": len(df),
          "int8_vs_float_unmatched": unmatched(d8, df, INT8_PROB_TOL),
          "int8_vs_float_unmatched_at_1e-3": unmatched(d8, df)})
    check(len(d8) > 0, f"{phase}: the int8 batch found nothing")
    check(not passes, f"{phase}: elementwise passes over the int8 head's activations: {passes}")
    check(head_kernels == INT8_HEAD_KERNELS[cfg.network],
          f"{phase}: one int8 head call put {head_kernels} kernels, copies and fills on the card, "
          f"want {INT8_HEAD_KERNELS[cfg.network]}")
    sync_free_phase(net8, images, panel3, phase=f"{phase}_sync_free")
    return per_batch


def quantizer_in_head(net8, fmap, props, quantized: list, events: list) -> dict:
    """The quantizer's device ms a launch inside the profiled head calls
    (``events``: (start, ms) of every quantize_rows_kernel, ``quantized``:
    each launch's input shape and type, both in launch order), averaged over
    the calls by position in a call, beside the same kernel timed alone
    (device_ms) on the very input that position quantized in one more head
    call; for each activation, its share of zeros and the kernel alone on
    seeded values of its shape with no zero and with half of them zero."""
    import torch

    from radnet_torch.ops import quant

    inputs = []
    real_q = quant.quantize_rows_cuda

    def keeping(x):
        inputs.append(x)
        return real_q(x)

    quant.quantize_rows_cuda = keeping
    try:
        with torch.inference_mode():
            net8._head(fmap, props)
    finally:
        quant.quantize_rows_cuda = real_q
    n = len(inputs)
    out = {"launches_profiled": len(quantized), "kernel_events": len(events), "launches_a_call": n}
    if not n or len(events) != len(quantized) or len(quantized) % n:
        out["event_ms"] = [ms for _, ms in events]  # not attributable launch by launch
        return out
    calls = len(quantized) // n
    rows = []
    for j, x in enumerate(inputs):
        row = {"input": j, "shape": quantized[j][0], "dtype": quantized[j][1],
               "head_ms": statistics.mean(events[c * n + j][1] for c in range(calls)),
               "alone_ms": kernel_ms(lambda x=x: real_q(x), "quantize_rows_kernel")}
        if x.dim() > 2:  # an activation: its zeros, and seeded values of its shape with and without
            row["zero_share"] = float((x == 0).float().mean())
            for key, y in (("alone_no_zeros_ms", torch.randn_like(x).abs_().add_(1e-3)),
                           ("alone_half_zeros_ms", torch.randn_like(x).relu_())):
                row[key] = kernel_ms(lambda y=y: real_q(y), "quantize_rows_kernel")
                del y
        rows.append(row)
    del inputs
    out.update(by_input=rows, head_ms=sum(r["head_ms"] for r in rows),
               alone_ms=sum(r["alone_ms"] for r in rows))
    return out


def int8_card_vs_cpu(weights: dict, cfg, dev, images, head_rois: int = INT8_HEAD_ROIS) -> dict:
    """The int8 head card against CPU, float32 (TF32 off): a 2-tile grey
    batch's detections (how many of either side have no partner), and the
    head alone on identical pooled inputs (the CPU's pool of the CPU's
    proposals, ``head_rois`` a tile): the largest difference of the class
    probabilities and of the box deltas, each as a share of its largest
    magnitude."""
    import torch

    from radnet_torch.geometry import xyxy_to_xywh
    from radnet_torch.inference import RADNet
    from radnet_torch.models.detector import build_model
    from radnet_torch.ops.roi_align import batched_roi_pool

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32", infer_quantize="int8")
    nets = []
    for where in (dev, "cpu"):
        m = build_model(cfg32)
        m.load_state_dict(weights)
        nets.append(RADNet(cfg32, m, device=where))
    gpu, cpu = nets
    torch.set_num_threads(os.cpu_count() or 1)
    canv = images[2:4].cpu().contiguous()
    wh = torch.full((2, 2), float(cfg32.img_size))
    t0 = time.perf_counter()
    got = tile_detections(gpu._predict_tiles_impl(canv.to(dev), wh.to(dev)), cfg32.n_classes - 1)
    want = tile_detections(cpu._predict_tiles_impl(canv, wh), cfg32.n_classes - 1)
    with torch.inference_mode():
        fmap = cpu._features(canv)
        rois = xyxy_to_xywh(cpu._proposals(fmap, wh).boxes[:, :head_rois]).contiguous()
        pooled = batched_roi_pool(fmap.permute(0, 2, 3, 1).contiguous(), rois,
                                  pool_size=cpu.model.pool_size,
                                  center_stride=cpu.model.pool_center_stride)
        pooled = pooled.reshape((-1,) + pooled.shape[2:])
        want_h = cpu.model.head(pooled, quantize=True)
        got_h = [t.cpu() for t in gpu.model.head(pooled.to(dev), quantize=True)]
    rel = [float((g - w).abs().max() / w.abs().max().clamp_min(1e-30)) for g, w in zip(got_h, want_h)]
    return {"detections_card": len(got), "detections_cpu": len(want),
            "unmatched": unmatched(got, want, INT8_PROB_TOL),
            "unmatched_by_prob_tol": {str(t): unmatched(got, want, t) for t in (1e-3, 1e-2, 5e-2, 2.0)},
            "head_rois": int(pooled.shape[0]), "head_cls_rel": rel[0], "head_regr_rel": rel[1],
            "seconds": time.perf_counter() - t0}


def int8_card_vs_cpu_phase(weights: dict, cfg, dev, images, phase: str) -> dict:
    """Phase int8_card_vs_cpu (and vgg_int8_card_vs_cpu): int8_card_vs_cpu,
    gated at INT8_HEAD_LIMIT and INT8_UNMATCHED_SHARE.  float32 noise moves
    some quantized values by a step where the two sides' trunks differ in
    the last bit, so the detections match at INT8_PROB_TOL, not at the
    float head's 1e-3."""
    r = int8_card_vs_cpu(weights, cfg, dev, images)
    emit({"phase": phase, "network": cfg.network, "dtype": "float32", "tf32": False, **r,
          "head_limit": INT8_HEAD_LIMIT, "unmatched_share_limit": INT8_UNMATCHED_SHARE})
    pooled = r["detections_card"] + r["detections_cpu"]
    check(pooled > 0, f"{phase}: no detections")
    check(r["unmatched"] <= INT8_UNMATCHED_SHARE * pooled,
          f"{phase}: {r['unmatched']} of {pooled} int8 detections unmatched card vs CPU")
    check(max(r["head_cls_rel"], r["head_regr_rel"]) <= INT8_HEAD_LIMIT,
          f"{phase}: the int8 head card vs CPU {r['head_cls_rel']}, {r['head_regr_rel']} "
          f"apart on identical inputs (limit {INT8_HEAD_LIMIT})")
    return r


def int8_predict_phase(tmp, model_name, scan, network, dev, kind, smi, phase) -> dict:
    """Phase int8_predict (and vgg_int8_predict): radnet_torch.cli.predict
    --quantize int8 on a scan directory: INT8_PER_BATCH's launches for each
    RoI pool, and detections written."""
    import torch

    from radnet_torch.cli import predict
    from radnet_torch.ops import cuda_kernels

    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = predict.main(["--models-path", os.path.join(tmp, "models"), "--model-name", model_name,
                           "--scan-data-path", scan, "--device", str(dev), "--quantize", "int8"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    with open(os.path.join(scan, "arrays", "predictions.json")) as f:
        preds = json.load(f)
    emit({"phase": phase, "kind": kind, "nvidia_smi": smi, "network": network,
          "detections": len(preds), "wall_s": wall_s, "launches": launches})
    n_b = launches["roi_pool"]
    per = INT8_PER_BATCH[network]
    check(rc == 0 and len(preds) > 0, f"{phase}: rc {rc}, {len(preds)} detections")
    check(n_b > 0 and all(launches[k] == per[k] * n_b for k in ("nms_fused", "quantize_rows", "int8_gemm")),
          f"{phase}: launches {launches} for {n_b} batches")
    return launches


def int8_test_phase(tmp, network, dev, smi, phase, n_panels: int) -> dict:
    """Phase int8_test (and vgg_int8_test): radnet_torch.cli.test
    --quantize int8 on the model cli.train wrote, over the first
    ``n_panels`` of the evaluate phase's test set (INT8_PER_BATCH's
    launches a batch); then, on a copy whose config.json saves
    infer_quantize "int8", cli.test over 2 panels runs the int8 head with no
    flag and not with --quantize none."""
    import shutil

    from radnet_torch.cli import test
    from radnet_torch.inference import RADNet
    from radnet_torch.ops import cuda_kernels

    models = os.path.join(tmp, "train_models")
    name = TRAIN_RUNS[network][1]
    d = os.path.join(tmp, "data")
    base = ["--test-annot", os.path.join(d, "test.csv"), "--test-data", os.path.join(d, "test"),
            "--device", str(dev), "--models-path", models]
    cuda_kernels.reset_launch_counts()
    with counting_calls(RADNet, "_predict_tiles_impl", lambda images, *_: images.dim()) as batches:
        rc, stdout, test_s = run_cli(test.main, base + ["--model-name", name, "--quantize", "int8",
                                                        "--limit", str(n_panels)])
    launches = launch_counts()
    with open(os.path.join(models, name, "test_accuracy.json")) as f:
        acc = json.load(f)
    n_b = len(batches)
    want = {k: v * n_b for k, v in INT8_PER_BATCH[network].items()}
    if network == "resnet50":
        want["grey_stem"] = batches.count(3)
    saved = name + "_int8"
    shutil.copytree(os.path.join(models, name), os.path.join(models, saved))
    cfg_path = os.path.join(models, saved, "config.json")
    raw = json.load(open(cfg_path))
    raw["infer_quantize"] = "int8"
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    by_flag = {}
    for flags in ([], ["--quantize", "none"]):
        cuda_kernels.reset_launch_counts()
        rc2, _, _ = run_cli(test.main, base + ["--model-name", saved, "--limit", "2"] + flags)
        check(rc2 == 0, f"{phase}: cli.test {flags} on a saved int8 config exited {rc2}")
        by_flag[" ".join(flags) or "(saved)"] = launch_counts()
    emit({"phase": phase, "nvidia_smi": smi, "network": network, "panels": n_panels, "wall_s": test_s,
          "batches": n_b, "launches": launches, "mAP": acc.get("mAP"),
          "saved_int8_config_launches": by_flag})
    check(rc == 0 and "mAP" in acc, f"{phase}: cli.test --quantize int8: rc {rc}, {sorted(acc)}")
    check(n_b > 0 and launches == want, f"{phase}: launches {launches}, want {want} for {n_b} batches")
    check(by_flag["(saved)"]["int8_gemm"] > 0 and by_flag["--quantize none"]["int8_gemm"] == 0
          and by_flag["--quantize none"]["quantize_rows"] == 0,
          f"{phase}: a saved infer_quantize and --quantize none: {by_flag}")
    return launches


def int8_phases(tmp, model_name, paths, scan, net, images, panel3, weights, dev, kind, smi,
                prefix: str = "") -> dict:
    """The int8 serving path of one backbone, on the model dir the float
    serve phase saved: serve, one batch (turns with the float head, the sync
    check), predict, card vs CPU.  Returns the launches of each run."""
    from radnet_torch.inference import load_radnet

    network = net.C.network
    served = int8_serve_phase(tmp, model_name, paths, network, dev, kind, smi, f"{prefix}int8_serve")
    net8 = load_radnet(os.path.join(tmp, "models", model_name), device=dev, quantize="int8")
    per_batch = int8_batch_phase(net8, net, images, panel3, kind, smi, f"{prefix}int8_batch")
    predicted = int8_predict_phase(tmp, model_name, scan, network, dev, kind, smi, f"{prefix}int8_predict")
    int8_card_vs_cpu_phase(weights, net.C, dev, images, f"{prefix}int8_card_vs_cpu")
    return {"serve": served["launches"], "batch": per_batch, "predict": predicted}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    from radnet_torch.config import Config
    from radnet_torch.ops import cuda_kernels

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 2. build
    earlier = earlier_kernels()
    build_s = cuda_kernels.build(cuda_kernels.KERNELS + list(earlier.values()))
    emit({"phase": "build", "seconds": build_s,
          "libraries": [k.lib_path().name for k in cuda_kernels.KERNELS + list(earlier.values())]})

    # 3-6. kernels against their plain versions, then timed; then kernels 2
    # and 2b at VGG16's width (C = 512, stride 1).
    errs = kernel_checks(dev)
    errs["roi_pool_backward"] = roi_backward_checks(dev, earlier)
    vgg_errs = vgg_kernel_checks(dev)
    kernels_line = timings(dev, errs, earlier)
    kernels_line.update(int8_kernel_checks(dev, earlier))

    # 7-8. the main path through serve, per-stage times, then predict.
    cfg, vcfg = Config(), vgg_config()
    with tempfile.TemporaryDirectory() as tmp:
        net, panel3, small, origins, launches = serve_phase(tmp, cfg, dev, kind, smi)
        images, per_batch = stages_phase(net, panel3, small, origins, kind, smi)
        kernels_line["nms_fused"]["main_path_inputs"] = nms_main_path(net, images, earlier)
        sync_free_phase(net, images, panel3)
        predict_phase(tmp, net, kind, smi)

        # 9. card vs CPU, float32, TF32 off.
        card_vs_cpu_phase(net, images, dev)
        serve_weights = {k: v.detach().cpu() for k, v in net.model.state_dict().items()}

        # The int8 head on the same model dir: served, one batch, predict,
        # card vs CPU.
        paths = [os.path.join(tmp, f"panel{k}.png") for k in range(N_PANELS)]
        int8_launches = {"resnet50": int8_phases(tmp, "smoke", paths, os.path.join(tmp, "scan"), net,
                                                 images, panel3, serve_weights, dev, kind, smi)}
        del net, images

        # VGG16: served, staged, sync-free, predicted, card vs CPU.
        vnet, panel3, small, origins, vgg_launches, vgg_weights = vgg_serve_phase(
            tmp, vcfg, dev, kind, smi)
        vimages, vgg_main, vgg_per_batch = vgg_stages_phase(vnet, panel3, small, origins, kind, smi,
                                                            vgg_errs)
        vgg_predict = vgg_predict_phase(tmp, vnet, kind, smi)
        card_vs_cpu_phase(vnet, vimages, dev, kinds=("grey",), phase="vgg_card_vs_cpu")
        paths = [os.path.join(tmp, f"vgg_panel{k}.png") for k in range(N_PANELS)]
        int8_launches["vgg16"] = int8_phases(tmp, "vgg", paths, os.path.join(tmp, "scan_vgg"), vnet,
                                             vimages, panel3, vgg_weights, dev, kind, smi, prefix="vgg_")
        del vnet, vimages

    # 10-16. training and evaluation: the CLIs, per-step numbers, sync-free,
    # learning, card vs CPU; each for ResNet50 (joint) and VGG16 (alternating).
    with tempfile.TemporaryDirectory() as tmp:
        trained = train_phase(tmp, dev, smi)
        evaluated = evaluate_phase(tmp, dev, smi, serve_weights)
        int8_launches["resnet50"]["test"] = int8_test_phase(tmp, "resnet50", dev, smi, "int8_test",
                                                            N_TEST_PANELS)
        vgg_trained = train_phase(tmp, dev, smi, "vgg16", phase="vgg_train")
        vgg_test = vgg_evaluate_phase(tmp, dev, smi, vgg_weights)
        int8_launches["vgg16"]["test"] = int8_test_phase(tmp, "vgg16", dev, smi, "vgg_int8_test", 6)
        pretrained = pretrained_train_phase(tmp, dev, smi)
        batch, samples_per_s = training_batch(tmp, cfg, dev)
    train_k = train_step_phase(batch, samples_per_s, cfg, dev, smi, errs, earlier)
    train_sync_free_phase(batch, cfg, dev)
    learning_phase(batch, cfg, dev)
    train_card_vs_cpu_phase(batch, cfg, dev)
    valt = dataclasses.replace(vcfg, train_schedule="alternating")
    vgg_k = train_step_phase(batch, samples_per_s, vcfg, dev, smi, vgg_errs, earlier,
                             schedules=("joint", "alternating"), phase="vgg_train_step")
    check(vgg_k["roi_pool"]["shape"][3] == VGG_C and vgg_k["roi_pool"]["center_stride"] == 1,
          f"the VGG16 step pooled {vgg_k['roi_pool']['shape']} at stride "
          f"{vgg_k['roi_pool']['center_stride']}")
    train_sync_free_phase(batch, valt, dev, phase="vgg_train_sync_free")
    learning_phase(batch, valt, dev, n_steps=40, phase="vgg_learning")
    alternating_card_vs_cpu_phase(batch, vcfg, dev)

    kernels_line["roi_pool_backward"] = train_k["roi_pool_backward"]
    kernels_line["nms_fused"]["train_step_shape"] = train_k["nms_fused"]
    kernels_line["roi_pool"]["train_step_shape"] = train_k["roi_pool"]
    kernels_line["nms_fused"]["vgg16"] = {"main_path_inputs": vgg_main["nms_fused"],
                                          "train_step_shape": vgg_k["nms_fused"]}
    kernels_line["roi_pool"]["vgg16"] = {"main_path_inputs": vgg_main["roi_pool"],
                                         "train_step_shape": vgg_k["roi_pool"]}
    kernels_line["roi_pool_backward"]["vgg16"] = {"train_step_shape": vgg_k["roi_pool_backward"],
                                                  "max_abs_err_random_inputs": vgg_errs["roi_pool_backward"]}
    for k in kernels_line.values():
        name = k["name"]
        k["launches_train"] = trained["train"]["launches"][name]
        k["launches_cont_train"] = trained["cont_train"]["launches"][name]
        k["launches_test"] = evaluated["test"][name]
        k["launches_test_rpn"] = evaluated["test_rpn"][name]
        k["launches_vgg16"] = {"serve": vgg_launches[name], "batch": vgg_per_batch[name],
                               "predict": vgg_predict[name],
                               "train": vgg_trained["train"]["launches"][name],
                               "cont_train": vgg_trained["cont_train"]["launches"][name],
                               "test": vgg_test[name]}
        k["launches_int8"] = {net: {run: counts[name] for run, counts in runs.items()}
                              for net, runs in int8_launches.items()}
        k["launches_pretrained_train"] = {arm: counts[name] for arm, counts in pretrained.items()}
        if name in launches:  # the served run is the serving kernels' main path
            k["launches"] = launches[name]
            k["launches_per_batch"] = per_batch[name]
    # The int8 kernels' main path is the int8 serving run of ResNet50.
    for name in ("int8_gemm", "quantize_rows"):
        kernels_line[name]["launches"] = int8_launches["resnet50"]["serve"][name]
        kernels_line[name]["launches_per_batch"] = int8_launches["resnet50"]["batch"][name]
    # The backward's main path is the trainable-trunk run of cont_train.
    kernels_line["roi_pool_backward"]["launches"] = trained["cont_train"]["launches"]["roi_pool_backward"]
    print(json.dumps({"kernels": list(kernels_line.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def paeth_png(h: int, w: int) -> bytes:
    """A grey PNG whose every row uses the Paeth filter (random filtered
    bytes: any byte string is a valid filtered stream)."""
    import struct
    import zlib

    from radnet_torch.data import png

    raw = np.random.default_rng(1).integers(0, 256, (h, w + 1), dtype=np.uint8)
    raw[:, 0] = 4
    return (png._SIGNATURE + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + png._chunk(b"IEND", b""))


if __name__ == "__main__":
    sys.exit(main())
