#!/usr/bin/env python3
"""The split row's amax kernel on one NVIDIA card: its build, its special
rows, and its time at other plans beside its earlier design and the library.

Run from the root of a checkout:
    python3 scripts/row_amax_probe.py

Builds radnet_torch/csrc/row_amax.cu and its earlier design (the amax-only
mode of radnet_torch/csrc/quantize_rows.cu), then:
  * prints what ptxas reports of row_amax.cu (registers, spills);
  * holds both against the plain version
    (radnet_torch/ops/quant.py::quantize_rows_amax_plain) on
    chip_smoke.amax_special_inputs (zeros, -0.0, +-inf, subnormals, NaN)
    at chip_smoke.AMAX_SPECIAL_LENGTHS, both types;
  * on the first piece of each chip_smoke.MESH_QUANT_CASES row (a model
    axis of 2), checks the kernel bit-equal to the plain version at the
    plan (quant.row_amax_plan) and at each plan of VARIANTS, then times
    (torch.profiler device ms a launch, 20 launches on the same input, so an
    input under the 50 MB L2 is read warm) the plan, each variant, the
    earlier design and torch.linalg.vector_norm(ord=inf) in turns, forward
    then backward, beside the bytes bound; and, at the plan, variants made
    from the kernel's source by text edits (SOURCE_VARIANTS: other load
    instructions), each checked bit-equal first.
Prints the card's nvidia-smi line, then one JSON line per check and case.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

# Plans (row_threads, threads, unroll) timed beside the wrapper's, by the
# piece's row length in values.
VARIANTS = {
    2048: [(8, 256, 4), (16, 256, 4), (32, 256, 8), (64, 256, 4), (128, 256, 4), (32, 128, 4),
           (32, 512, 4)],
    50176: [(128, 256, 4), (128, 128, 8), (256, 256, 8), (512, 512, 4), (512, 512, 8),
            (1024, 1024, 4)],
}


# name: edits of csrc/row_amax.cu (every load of the row goes through one
# instruction or another).
_HINTED = """__device__ __forceinline__ uint4 ldg_hint(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

template <typename T, int UNROLL>"""
SOURCE_VARIANTS = {
    "ld_l2_256b_prefetch": (("template <typename T, int UNROLL>\n__global__", _HINTED + "\n__global__"),
                            ("__ldg(p + i + k * row_threads)", "ldg_hint(p + i + k * row_threads)"),
                            ("__ldg(p + i),", "ldg_hint(p + i),")),
    "ldcs_evict_first": (("__ldg(p + i + k * row_threads)", "__ldcs(p + i + k * row_threads)"),
                         ("__ldg(p + i),", "__ldcs(p + i),")),
}


def source_variants(cuda_kernels) -> dict:
    """Each SOURCE_VARIANTS kernel, built from an edited copy of the source
    written under _build/."""
    src = (cuda_kernels.CSRC / "row_amax.cu").read_text()
    base = cuda_kernels.QUANTIZE_ROWS_AMAX
    out = {}
    for name, edits in SOURCE_VARIANTS.items():
        text = src
        for a, b in edits:
            assert a in text, a
            text = text.replace(a, b)
        cuda_kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = cuda_kernels.BUILD_DIR / f"row_amax_{name}.cu"
        path.write_text(text)
        out[name] = cuda_kernels.CudaKernel(os.path.relpath(path, cuda_kernels.CSRC), base.symbol,
                                            base.argtypes[:-1], name=f"row_amax_{name}")
    return out


def ptxas_report(kernel) -> list[str]:
    """ptxas's registers and spills of each of the kernel's functions (a
    build with -Xptxas -v beside the real one)."""
    kernel.lib_path().parent.mkdir(parents=True, exist_ok=True)
    out = str(kernel.lib_path().with_suffix(".ptxas.so"))
    cmd = kernel.compile_command(out)
    log = subprocess.run(cmd[:1] + ["-Xptxas", "-v"] + cmd[1:], capture_output=True, text=True,
                         check=True)
    os.remove(out)
    return [ln.strip() for ln in (log.stdout + log.stderr).splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def launch_plan(x, plan, kernel=None):
    """row_amax.cu (or a variant ``kernel``) at ``plan`` (row_threads,
    threads, unroll)."""
    import torch

    from radnet_torch.ops import cuda_kernels, quant

    rows = x.shape[0]
    amax = torch.empty((rows,), dtype=torch.float32, device=x.device)
    (kernel or cuda_kernels.QUANTIZE_ROWS_AMAX).launch(
        cuda_kernels.ptr(x), cuda_kernels.ptr(amax), rows, x.numel() // rows,
        quant._DTYPE_CODE[x.dtype], *plan)
    return amax


def main() -> int:
    import torch

    from radnet_torch.ops import cuda_kernels, quant

    if not torch.cuda.is_available():
        print("row_amax_probe: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    earlier = cs.earlier_kernels()["quantize_rows_amax"]
    variants = source_variants(cuda_kernels)
    build_s = cuda_kernels.build([cuda_kernels.QUANTIZE_ROWS_AMAX, earlier, *variants.values()])
    print(json.dumps({"build_s": build_s, "ptxas": ptxas_report(cuda_kernels.QUANTIZE_ROWS_AMAX)}),
          flush=True)
    print(json.dumps({"special_rows": cs.amax_special_checks(dev, earlier)}), flush=True)

    for i, case in enumerate(cs.MESH_QUANT_CASES):
        name, _, shape, dtype, _ = case
        x = cs.mesh_quant_inputs(case, dev, cs.SEED + 120 + i)
        n = shape[-1] // cs.MESH_MODEL_AXIS
        p = x[..., :n].contiguous()
        del x
        rows, length = p.shape[0], p.numel() // p.shape[0]
        want = quant.quantize_rows_amax_plain(p)
        plan = tuple(quant.row_amax_plan(rows, length, p.dtype))
        plans = [plan] + [v for v in VARIANTS.get(length, []) if v != plan]
        for v in plans:
            cs.check(cs.amax_bits_equal(launch_plan(p, v), want), f"{name}: plan {v} disagrees")
        for vname, k in variants.items():
            cs.check(cs.amax_bits_equal(launch_plan(p, plan, k), want), f"{name}: {vname} disagrees")
        cs.check(cs.amax_bits_equal(cs.earlier_row_amax(earlier, p), want), f"{name}: the earlier design")
        arms = {f"plan {list(v)}": (lambda v=v: cs.kernel_ms(lambda: launch_plan(p, v), "row_amax_kernel"))
                for v in plans}
        for vname, k in variants.items():
            arms[vname] = lambda k=k: cs.kernel_ms(lambda: launch_plan(p, plan, k), "row_amax_kernel")
        arms["earlier"] = lambda: cs.kernel_ms(lambda: cs.earlier_row_amax(earlier, p),
                                               "quantize_rows_kernel")
        arms["vector_norm"] = lambda: cs.call_device_ms(
            lambda: torch.linalg.vector_norm(p.reshape(rows, -1), ord=float("inf"), dim=1,
                                             dtype=torch.float32))
        turns = {k: [] for k in arms}
        for k in list(arms) + list(arms)[::-1]:
            turns[k].append(arms[k]())
        bound, by = cs.bound_ms(p.numel() * p.element_size() + 4 * rows, 1.0 * p.numel())
        print(json.dumps({"case": name, "piece": list(p.shape), "dtype": dtype, "plan": list(plan),
                          "bound_ms": bound, "bound_by": by, "nvidia_smi": smi,
                          "ms": {k: statistics.mean(v) for k, v in turns.items()}, "turns": turns}),
              flush=True)
        del p
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
