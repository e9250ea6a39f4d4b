#!/usr/bin/env python3
"""Smoke test of radnet_torch, the PyTorch port, on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. device     card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build      nvcc builds every kernel of radnet_torch/csrc for sm_90a;
  3. kernel 1   NMS dominance vs its plain version at (12, 2048), (72, 300)
                and a ragged N = 1000: outputs must be equal;
  4. kernel 2   RoI pooling vs its plain version at (12, 38, 38, 1024) x
                (12, 300), P = 7, center_stride 2 and 1, bf16 and f32:
                f32 within 1e-5 absolute, bf16 within one bf16 ulp of the
                plain version computed in f32 from the same bf16 inputs;
  5. timings    CUDA-event medians of each kernel, its plain version and a
                library call, beside the kernel's bound on this card;
  6. main path  the default Config (ResNet50, canvas 608, bf16, 12 tiles a
                batch) with seeded random weights, saved to a model dir and
                served through radnet_torch.cli.serve: three 4400 x 3000 grey
                PNG panels, 28 tiles each; every kernel's launch count is
                read around this run;
  7. card/CPU   one 2-tile batch of the cascade in float32 (TF32 off) on the
                card and on the CPU: the detection sets must match.

The last lines are the kernels JSON line, the nvidia-smi line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PANEL_HW = (3000, 4400)
N_PANELS = 3
SEED = 0


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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for e in prof.key_averages():
        if symbol in e.key:
            total_us += getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
            count += e.count
    return total_us / count / 1e3 if count else None


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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------- #
# Inputs made from a seed.
# --------------------------------------------------------------------------- #
def nms_inputs(b, n, seed, extent, unit, device):
    """Integer-valued boxes (some degenerate), tied scores, -inf invalids."""
    import torch

    rng = np.random.default_rng(seed)
    x1 = rng.integers(0, extent, (b, n))
    y1 = rng.integers(0, extent, (b, n))
    w = rng.integers(0, 8, (b, n))  # w == 0: degenerate
    h = rng.integers(0, 8, (b, n))
    boxes = (np.stack([x1, y1, x1 + w, y1 + h], -1) * unit).astype(np.float32)
    scores = rng.choice(np.linspace(0.05, 1.0, 40), (b, n)).astype(np.float32)
    scores[rng.random((b, n)) < 0.15] = -np.inf
    return torch.from_numpy(boxes).to(device), torch.from_numpy(scores).to(device)


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


def synthetic_grey_panel(seed: int) -> np.ndarray:
    """A grey panel: dark textured rock with bright carved figures."""
    rng = np.random.default_rng(seed)
    h, w = PANEL_HW
    img = rng.integers(20, 60, (h // 4, w // 4), dtype=np.uint8)
    img = np.repeat(np.repeat(img, 4, axis=0), 4, axis=1)
    for _ in range(120):
        x, y = rng.integers(0, w - 300), rng.integers(0, h - 300)
        bw, bh = rng.integers(40, 300, 2)
        img[y : y + bh, x : x + bw] = rng.integers(110, 250)
    return img


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

    totals: dict[str, int] = {}
    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, (Conv, torch.nn.Linear)):
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
        x = p.reshape((-1,) + p.shape[2:]).permute(0, 3, 1, 2)
        x = head.s5c(head.s5b(head.s5a(x.to(head.dtype))))
        feats = F.avg_pool2d(x, 7).flatten(1).float()[props.valid.reshape(-1)]
        fit(head.dense_class, feats, 4.0)
        fit(head.dense_regress, feats, 0.5)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    from radnet_torch.cli import serve
    from radnet_torch.config import Config
    from radnet_torch.data.png import decode_png, write_png
    from radnet_torch.data.tiling import plan_tiles
    from radnet_torch.inference import RADNet, load_radnet, save_radnet
    from radnet_torch.models.detector import build_model, init_weights
    from radnet_torch.ops import cuda_kernels, nms, roi_align

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
    build_s = cuda_kernels.build(cuda_kernels.KERNELS)
    emit({"phase": "build", "seconds": build_s,
          "libraries": [k.lib_path().name for k in cuda_kernels.KERNELS]})

    # 3. kernel 1 vs plain: exact equality.
    nms_cases = [(12, 2048, 0.7, 10, 1.0), (72, 300, 0.2, 8, 16.0), (5, 1000, 0.5, 12, 1.0)]
    dom_err = 0.0
    for i, (b, n, thr, extent, unit) in enumerate(nms_cases):
        boxes, scores = nms_inputs(b, n, SEED + i, extent, unit, dev)
        got = nms.dominates_cuda(boxes, scores, thr)
        want = nms.dominates_plain(boxes, scores, thr)
        torch.cuda.synchronize()
        mism = int((got != want).sum())
        dom_err = max(dom_err, float((got.float() - want.float()).abs().max()))
        emit({"phase": "kernel1", "shape": [b, n], "thresh": thr, "mismatches": mism,
              "true_frac": float(want.float().mean())})
        check(mism == 0, f"nms_dominance disagrees with its plain version at {(b, n)}")

    # 4. kernel 2 vs plain: f32 <= 1e-5 abs; bf16 within one bf16 ulp.
    roi_err = {}
    for dtype in (torch.bfloat16, torch.float32):
        for stride in (2, 1):
            fmap, rois = roi_inputs(dtype, SEED + stride, dev)
            got = roi_align.roi_pool_cuda(fmap, rois, pool_size=7, center_stride=stride)
            ref = roi_align.roi_pool_plain(fmap.float(), rois, pool_size=7, center_stride=stride)
            torch.cuda.synchronize()
            err = (got.float() - ref).abs()
            max_err = float(err.max())
            if dtype == torch.float32:
                ok, tol = max_err <= 1e-5, "1e-5 abs"
            else:
                ulps = float((err / bf16_ulp(ref)).max())
                ok, tol = ulps <= 1.0, f"1 bf16 ulp (max {ulps:.3f} ulp)"
            roi_err[(str(dtype), stride)] = max_err
            emit({"phase": "kernel2", "dtype": str(dtype), "center_stride": stride,
                  "max_abs_err": max_err, "tolerance": tol, "exact": bool(err.max() == 0)})
            check(ok, f"roi_pool disagrees with its plain version ({dtype}, stride {stride})")
            del fmap, got, ref, err

    # 5. timings at the main path's shapes.
    def timed(kernel_fn, symbol, plain_fn, n_bytes, n_ops, shape):
        call_ms = time_cuda(kernel_fn)
        dev_ms = device_ms(kernel_fn, symbol)
        bnd, by = bound_ms(n_bytes, n_ops)
        return {"shape": shape, "ms": dev_ms if dev_ms is not None else call_ms,
                "call_ms": call_ms, "ms_source": "profiler" if dev_ms is not None else "cuda_events",
                "plain_ms": time_cuda(plain_fn, iters=5), "bound_ms": bnd, "bound_by": by}

    dom_times = []
    for i, (b, n, thr, extent, unit) in enumerate(nms_cases[:2]):  # proposal, per-class
        boxes, scores = nms_inputs(b, n, SEED + i, extent, unit, dev)
        dom_times.append(timed(
            lambda: nms.dominates_cuda(boxes, scores, thr), "dominance_kernel",
            lambda: nms.dominates_plain(boxes, scores, thr),
            b * n * 20 + b * n * n, 16.0 * b * n * n, [b, n]))
    kernels_line = {"nms_dominance": {
        "name": "nms_dominance", "route": "cuda", "source": "radnet_torch/csrc/nms_dominance.cu",
        "replaces": "radnet_tpu/ops/pallas_nms.py:31", **dom_times[0], "library_ms": None,
        "max_abs_err": dom_err, "per_class_shape": dom_times[1],
    }}

    fmap, rois = roi_inputs(torch.bfloat16, SEED, dev)
    b, hw, _, c = fmap.shape
    r, p, elt = rois.shape[1], 7, fmap.element_size()
    grid = grid_sample_centres(rois, p, 2, hw).to(fmap.dtype)
    fmap_nchw = fmap.permute(0, 3, 1, 2)  # channels-last NCHW view

    def library():
        return torch.nn.functional.grid_sample(
            fmap_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)

    lib_dev_ms = device_ms(library, "grid_sampler")
    kernels_line["roi_pool"] = {
        "name": "roi_pool", "route": "cuda", "source": "radnet_torch/csrc/roi_pool.cu",
        "replaces": "radnet_tpu/ops/pallas_roi.py:37",
        **timed(lambda: roi_align.roi_pool_cuda(fmap, rois, pool_size=p, center_stride=2),
                "roi_pool_kernel",
                lambda: roi_align.roi_pool_plain(fmap, rois, pool_size=p, center_stride=2),
                b * hw * hw * c * elt + b * r * 16 + b * r * p * p * c * elt,
                9.0 * b * r * p * p * c, [b, hw, hw, c, r, p]),
        "library_ms": lib_dev_ms if lib_dev_ms is not None else time_cuda(library),
        "max_abs_err": roi_err[(str(torch.bfloat16), 2)],
    }
    del fmap, rois, grid, fmap_nchw
    emit({"phase": "timings", "kernels": list(kernels_line.values())})

    # 6. main path through serve, default Config at full width.
    cfg = Config()
    gen = torch.Generator().manual_seed(SEED)
    model = init_weights(build_model(cfg), gen)
    radnet = RADNet(cfg, model, device="cuda")
    panels = [synthetic_grey_panel(SEED + k) for k in range(N_PANELS)]
    panel3 = np.repeat(panels[0][..., None], 3, axis=-1)
    small, scale, sw, sh = radnet._prescale_panel(panel3)
    tiles = plan_tiles(PANEL_HW[1], PANEL_HW[0], cfg.tile_size, cfg.tile_overlap)
    origins = np.round(tiles[:, :2] * scale).astype(np.int64)
    calib = radnet._window_canvases(small, origins[:2])
    calibrate_heads(radnet, calib, gen)

    with tempfile.TemporaryDirectory() as tmp:
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
        nms.NMS_STATS.update(calls=0, rounds=0)

        class Stamped(io.StringIO):
            """Keeps the time of every line written; forwards to ``echo``."""

            def __init__(self, echo=None):
                super().__init__()
                self.stamps = []
                self.echo = echo

            def write(self, s):
                if s.endswith("\n"):
                    self.stamps.append(time.perf_counter())
                if self.echo is not None:
                    self.echo.write(s)
                return super().write(s)

        out, err = Stamped(), Stamped(echo=sys.stderr)
        t0 = time.perf_counter()
        real_stderr, sys.stderr = sys.stderr, err
        try:
            rc = serve.main(
                ["--models-path", os.path.join(tmp, "models"), "--model-name", "smoke",
                 "--warmup-size", str(cfg.tile_size)],
                stdin=io.StringIO("\n".join(paths) + "\n"), stdout=out,
            )
        finally:
            sys.stderr = real_stderr
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in cuda_kernels.KERNELS}
        nms_stats = dict(nms.NMS_STATS)
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
        n_batches = len(radnet._batch_schedule(len(tiles)))
        emit({"phase": "serve", "kind": kind, "nvidia_smi": smi, "panels": len(recs),
              "tiles_per_panel": len(tiles), "batches_per_panel": n_batches,
              "detections": [len(r["detections"]) for r in recs],
              "sec_field": [r["sec"] for r in recs],
              "panels_per_s": len(recs) / results_s[-1],
              "result_s_after_ready": results_s, "serve_wall_s": serve_s,
              "launches": launches, "nms_calls": nms_stats["calls"],
              "nms_rounds": nms_stats["rounds"],
              "png_write_s": write_s / N_PANELS, "png_decode_filter0_s": decode_s})

        # Per-stage times of one 12-tile batch, on the same weights.
        net = load_radnet(os.path.join(tmp, "models", "smoke"), device="cuda")
    images = net._window_canvases(small, origins[: cfg.infer_tile_batch])
    valid_wh = torch.full((len(images), 2), float(cfg.img_size), device=dev)

    def stages():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        with torch.inference_mode():
            ev[0].record()
            fmap = net._features(images)
            ev[1].record()
            props = net._proposals(fmap, valid_wh)
            ev[2].record()
            head = net._head(fmap, props)
            ev[3].record()
            net._detections(*head)
            ev[4].record()
        ev[4].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]

    stages()
    runs = [stages() for _ in range(5)]
    stage_ms = {k: statistics.median(r[i] for r in runs)
                for i, k in enumerate(["trunk", "rpn_proposals", "roi_pool_head", "class_nms"])}
    batch_ms = time_cuda(lambda: net._predict_tiles_impl(images, valid_wh), iters=5, warmup=1)
    cuda_kernels.reset_launch_counts()
    with count_flops(net.model) as flops:
        net._predict_tiles_impl(images, valid_wh)
    per_batch = {k.name: k.launches for k in cuda_kernels.KERNELS}
    for k in cuda_kernels.KERNELS:  # the main path's counts stay the reported ones
        k.launches = launches[k.name]
    prescale_ms = time_cuda(lambda: net._prescale_panel(panel3), iters=5, warmup=1)
    panel_wall_ms, panel_busy_ms = device_busy(lambda: net.predict([panel3]))
    t0 = time.perf_counter()
    net._grey_channel(panel3)
    t1 = time.perf_counter()
    pending = net.predict_dispatch([panel3])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    net.predict_collect(pending)
    t3 = time.perf_counter()
    host_ms = {"grey_check": (t1 - t0) * 1e3, "dispatch": (t2 - t1) * 1e3,
               "collect": (t3 - t2) * 1e3}
    flag = torch.zeros((12, 2048), dtype=torch.bool, device=dev)
    sync_ms = time_cuda(lambda: bool((flag != flag).any()), iters=50)
    paeth = paeth_png(1000, 1000)
    t0 = time.perf_counter()
    decode_png(paeth)
    paeth_s = time.perf_counter() - t0
    emit({"phase": "stages", "kind": kind, "nvidia_smi": smi, "batch_tiles": len(images),
          "stage_ms": stage_ms, "batch_ms": batch_ms, "launches_per_batch": per_batch,
          "tflop_per_batch": {k: v / 1e12 for k, v in flops.items()},
          "tflop_per_s": {"trunk": flops["trunk"] / stage_ms["trunk"] / 1e9,
                          "head": flops["head"] / stage_ms["roi_pool_head"] / 1e9},
          "prescale_panel_ms": prescale_ms, "convergence_sync_ms": sync_ms,
          "panel_predict_ms": panel_wall_ms, "panel_device_busy_ms": panel_busy_ms,
          "panel_device_idle_share": 1.0 - panel_busy_ms / panel_wall_ms,
          "panel_host_ms": host_ms,
          "png_decode_paeth_1000x1000_s": paeth_s})

    # 7. card vs CPU, float32, TF32 off.
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    state = {k: v.detach().cpu() for k, v in net.model.state_dict().items()}
    m_gpu = build_model(cfg32)
    m_gpu.load_state_dict(state)
    m_cpu = copy.deepcopy(m_gpu)
    gpu = RADNet(cfg32, m_gpu, device="cuda")
    cpu = RADNet(cfg32, m_cpu, device="cpu")
    torch.set_num_threads(os.cpu_count() or 1)
    canv = images[2:4]
    wh = torch.full((2, 2), float(cfg.img_size))
    t0 = time.perf_counter()
    got = [t.cpu().numpy() for t in gpu._predict_tiles_impl(canv, wh.to(dev))]
    want = [t.numpy() for t in cpu._predict_tiles_impl(canv.cpu(), wh)]
    cmp_s = time.perf_counter() - t0
    n_g, n_w, unmatched = int(got[2].sum()), int(want[2].sum()), 0
    for t in range(2):
        for k in range(cfg.n_classes - 1):
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
    emit({"phase": "card_vs_cpu", "dtype": "float32", "tf32": False, "tiles": 2,
          "detections_card": n_g, "detections_cpu": n_w, "unmatched": unmatched,
          "seconds": cmp_s})
    check(pooled > 0, "float32 comparison has no detections")
    check(unmatched <= 0.05 * pooled, f"{unmatched} of {pooled} detections unmatched card vs CPU")

    for k in kernels_line.values():
        k["launches"] = launches[k["name"]]
        k["launches_per_batch"] = per_batch[k["name"]]
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
