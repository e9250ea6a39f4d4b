#!/usr/bin/env python3
"""Where the RoI-pool backward kernel's time goes, on one NVIDIA card.

Run from the root of a checkout:  python3 scripts/roi_backward_probe.py

Builds radnet_torch/csrc/roi_pool_backward.cu and three variants made from
its source:
  stamped          the kernel with a globaltimer stamp at the start and end
                   of every block and the number of row taps it listed
                   (same output);
  no_accumulate    the sums left out: the rounds, the listing, the staged
                   copies and the write only (wrong output, timing only);
  no_copies        the copies left out (wrong output, timing only).
It times them and the kernel at chip_smoke.py's (8, 20) and (12, 300) shapes
(38 x 38 x 1024 bf16 map, P = 7, stride 2), on chip_smoke.py's seeded random
RoIs (some past the map, whose taps clamp onto its last row or column) and
on RoIs that lie inside the map.  Device times come from torch.profiler.
Prints the card's nvidia-smi line, then one JSON line per case: the times,
the per-block durations (median, 90th percentile, largest), the listed row
taps a block (mean, largest) and the least-squares microseconds a listed
row tap costs a block.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

START = "  const int chunk = blockIdx.x % n_chunks;"
LIST = "    if (mine.flags) listed[at] = mine;"
END = "  if (!active) return;\n  T* out ="
ACCUMULATE = "      for (unsigned bits = owned[buf][grp]; bits; bits &= bits - 1) {  // in cell order"
COPY = "        if (active)\n          cp_async16("
MAX_BLOCKS = 1 << 16

STAMPS = f"""
__device__ unsigned long long g_stamps[3 * {MAX_BLOCKS}];
extern "C" int radnet_probe_stamps(void* dst, int n) {{
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, (size_t)n * 24, 0, cudaMemcpyDeviceToDevice);
}}
__device__ __forceinline__ unsigned long long probe_now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
"""


def variants(cuda_kernels) -> dict:
    """The kernel and its variants, written under radnet_torch/_build/."""
    src = (cuda_kernels.CSRC / "roi_pool_backward.cu").read_text()
    for marker in (START, LIST, END, ACCUMULATE, COPY):
        if src.count(marker) != 1:
            raise RuntimeError(f"csrc/roi_pool_backward.cu no longer holds {marker.strip()!r} once")
    head, body = src.split("namespace {", 1)
    stamped = (head + STAMPS + "namespace {" + body) \
        .replace(START, "  const unsigned long long t_start = probe_now();\n  int n_total = 0;\n" + START) \
        .replace(LIST, "    n_total += n_listed;\n" + LIST) \
        .replace(END, f"  if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) {{\n"
                      "    g_stamps[3 * blockIdx.x] = t_start;\n"
                      "    g_stamps[3 * blockIdx.x + 1] = probe_now();\n"
                      "    g_stamps[3 * blockIdx.x + 2] = n_total;\n  }\n" + END)
    texts = {
        "stamped": stamped,
        "no_accumulate": src.replace(ACCUMULATE, ACCUMULATE.replace("bits = owned[buf][grp]",
                                                                    "bits = 0u * owned[buf][grp]")),
        "no_copies": src.replace(COPY, "        if (active && k0 < 0)\n          cp_async16("),
    }
    out = {"kernel": cuda_kernels.ROI_POOL_BACKWARD}
    gen = cuda_kernels.BUILD_DIR / "probe"
    gen.mkdir(parents=True, exist_ok=True)
    for name, text in texts.items():
        (gen / f"roi_pool_backward_{name}.cu").write_text(text)
        out[name] = cuda_kernels.CudaKernel(
            f"../_build/probe/roi_pool_backward_{name}.cu", "radnet_roi_pool_backward",
            list(cuda_kernels.ROI_POOL_BACKWARD.argtypes[:-1]),
            extra_flags=("--fmad=false", "-I", str(cuda_kernels.CSRC)))
    return out


def inside_rois(b, r, hw, seed, device):
    """RoIs of 0-19 feature pixels a side that lie inside the map."""
    import torch

    rng = np.random.default_rng(seed)
    wh = rng.integers(0, 20, (b, r, 2))
    xy = rng.integers(0, hw - wh)
    return torch.from_numpy(np.concatenate([xy, wh], -1).astype(np.float32)).to(device)


def main() -> int:
    import torch

    from radnet_torch.ops import cuda_kernels
    from radnet_torch.ops.cuda_kernels import ptr

    if not torch.cuda.is_available():
        print("roi_backward_probe: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    ks = variants(cuda_kernels)
    cuda_kernels.build(list(ks.values()))
    ks["stamped"]._load()
    lib = ctypes.CDLL(str(ks["stamped"].lib_path()))
    lib.radnet_probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda")
    hw, c, p = 38, 1024, 7
    for b, r in cs.BACKWARD_CASES:
        for kind in ("random", "inside"):
            g, rois = cs.roi_backward_inputs(torch.bfloat16, cs.SEED + 2, dev, b, r, "random")
            if kind == "inside":
                rois = inside_rois(b, r, hw, cs.SEED + 7, dev)
            out = torch.empty((b, hw, hw, c), dtype=g.dtype, device=dev)
            line = {"shape": [b, hw, hw, c, r, p], "rois": kind}
            for name, k in ks.items():
                line[f"{name}_ms"] = cs.device_ms(
                    lambda k=k: k.launch(ptr(g), ptr(rois), ptr(out), b, hw, hw, c, r, p, 2, 1),
                    "roi_pool_backward_kernel", iters=10)
            n_blocks = b * hw * (c // 256)
            ks["stamped"].launch(ptr(g), ptr(rois), ptr(out), b, hw, hw, c, r, p, 2, 1)
            st = torch.empty((n_blocks, 3), dtype=torch.int64, device=dev)
            torch.cuda.synchronize()
            if lib.radnet_probe_stamps(ctypes.c_void_p(st.data_ptr()), n_blocks) != 0:
                raise RuntimeError("reading the stamps failed")
            st = st.cpu().numpy().astype(np.float64)
            dur_us = (st[:, 1] - st[:, 0]) / 1e3
            taps = st[:, 2]
            slope, base = np.linalg.lstsq(np.stack([taps, np.ones_like(taps)], 1), dur_us, rcond=None)[0]
            line.update({
                "span_us": float((st[:, 1].max() - st[:, 0].min()) / 1e3),
                "block_us_median": float(np.median(dur_us)),
                "block_us_p90": float(np.percentile(dur_us, 90)),
                "block_us_max": float(dur_us.max()),
                "listed_row_taps_mean": float(taps.mean()), "listed_row_taps_max": float(taps.max()),
                "us_per_listed_row_tap": float(slope), "us_per_block_base": float(base),
            })
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
