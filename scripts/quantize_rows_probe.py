#!/usr/bin/env python3
"""The int8 quantizer on one NVIDIA card: what its division compiles to, and
how its time depends on the share of zeros in its input.

Run from the root of a checkout:
    python3 scripts/quantize_rows_probe.py [--variants] [--sass-dir DIR]

Builds radnet_torch/csrc/quantize_rows.cu and the earlier design
(radnet_torch/csrc/earlier/quantize_rows_two_pass.cu), then:
  * prints what ptxas reports of each (registers, spills);
  * dumps each library's SASS with cuobjdump into <DIR>/<library>.sass
    (default radnet_torch/_build/quantize_rows_probe) and prints, for each
    kernel instantiation, how many FCHK (the IEEE division's fast-path
    check), MUFU.RCP and CALL instructions it holds, and the lines around
    the first FCHK of a value's division;
  * times both kernels (torch.profiler device ms a launch) on the ResNet50
    int8 head's activation shapes, 3600 RoIs of 7 x 7 x C bf16 for C = 512,
    1024 and 2048, on VGG16's fc1 weight rows (4096 x 25 088 float32), fc2
    inputs and weights (3600 and 4096 x 4096 float32) and on ResNet50's five
    weight shapes (float32, K-major rows), with every value zero, with a
    seeded half zero (a ReLU of normal values) and with none zero, each
    output checked bit-equal to the plain
    version (radnet_torch/ops/quant.py::quantize_rows_plain).
With --variants it instead times the kernel on the half-zero and no-zero
inputs at the plan's thread count and at each of THREADS, and variants made
from its source (F2I for the int8 conversion, chunks of 4-16 KiB folded
as each lands; same output), each checked bit-equal, beside the earlier
design.
Prints the card's nvidia-smi line, then one JSON line per kernel's SASS and
per case.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

SHAPES = [("resnet50_s5_c512", (3600, 7, 7, 512), "bfloat16"),
          ("resnet50_s5_c1024", (3600, 7, 7, 1024), "bfloat16"),
          ("resnet50_s5_c2048", (3600, 7, 7, 2048), "bfloat16"),
          ("vgg16_fc1_weights", (4096, 25088), "float32"),
          ("vgg16_fc2_inputs", (3600, 4096), "float32"),
          ("vgg16_fc2_weights", (4096, 4096), "float32"),
          ("resnet50_s5a_conv2a_weights", (512, 1024), "float32"),
          ("resnet50_s5a_conv_sc_weights", (2048, 1024), "float32"),
          ("resnet50_conv2b_weights", (512, 9 * 512), "float32"),
          ("resnet50_conv2c_weights", (2048, 512), "float32"),
          ("resnet50_s5b_conv2a_weights", (512, 2048), "float32")]
FILLS = ("all_zero", "half_zero", "no_zero")


def cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "cuobjdump")


def sass_summary(lib_path, name: str, out_dir: str) -> list[dict]:
    """Each kernel function's instruction counts in the library's SASS, the
    full dump written under ``out_dir``."""
    text = subprocess.run([cuobjdump(), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    with open(os.path.join(out_dir, f"{name}.sass"), "w") as f:
        f.write(text)
    out = []
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        func, _, body = block.partition("\n")
        lines = [ln.strip() for ln in body.splitlines() if re.match(r"\s*/\*[0-9a-f]{4}\*/", ln)]
        # The first division of a value (the scale's divides by the constant 127).
        first = next((i for i, ln in enumerate(lines) if "FCHK" in ln and ", 127" not in ln), None)
        out.append({"library": name, "function": func.strip(),
                    "instructions": len(lines),
                    "FCHK": sum("FCHK" in ln for ln in lines),
                    "MUFU.RCP": sum("MUFU.RCP" in ln for ln in lines),
                    "CALL": sum(" CALL" in ln for ln in lines),
                    "FRND": sum("FRND" in ln for ln in lines),
                    "around_first_FCHK": [] if first is None else lines[max(0, first - 12):first + 10]})
    return out


def ptxas_report(kernel) -> list[str]:
    """ptxas's registers, shared memory and spills of each of the kernel's
    functions (a build with -Xptxas -v beside the real one)."""
    kernel.lib_path().parent.mkdir(parents=True, exist_ok=True)
    out = str(kernel.lib_path().with_suffix(".ptxas.so"))
    cmd = kernel.compile_command(out)
    log = subprocess.run(cmd[:1] + ["-Xptxas", "-v"] + cmd[1:], capture_output=True, text=True,
                         check=True)
    os.remove(out)
    return [ln.strip() for ln in (log.stdout + log.stderr).splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


THREADS = (64, 128, 256, 288, 384, 416, 448, 512, 1024)
# name: (edits of the kernel's source, threads a CTA or None for the plan's)
VARIANTS = {
    "plan": ((), None),
    **{f"threads_{t}": ((), t) for t in THREADS},
    "f2i": ((("b[k] = int8_in_low_byte(fminf(fmaxf(r, -127.0f), 127.0f));",
              "b[k] = (uint32_t)(uint8_t)(int8_t)__float2int_rn(fminf(fmaxf(r, -127.0f), 127.0f));"),),
            None),
    "chunk_4k": ((("kChunkBytes = kSliceBytes;", "kChunkBytes = 4 * 1024;"),
                  ("kDataOffset = 256;", "kDataOffset = 512;")), None),
    "chunk_8k": ((("kChunkBytes = kSliceBytes;", "kChunkBytes = 8 * 1024;"),), None),
    "chunk_16k": ((("kChunkBytes = kSliceBytes;", "kChunkBytes = 16 * 1024;"),), None),
}


def variant_kernels(cuda_kernels) -> dict:
    """Each variant's CudaKernel: the kernel itself where the source is not
    edited, else one built from an edited copy written under _build/."""
    src = (cuda_kernels.CSRC / "quantize_rows.cu").read_text()
    out = {}
    for name, (edits, _) in VARIANTS.items():
        if not edits:
            out[name] = cuda_kernels.QUANTIZE_ROWS
            continue
        text = src
        for a, b in edits:
            assert a in text, a
            text = text.replace(a, b)
        cuda_kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = cuda_kernels.BUILD_DIR / f"quantize_rows_{name}.cu"
        path.write_text(text)
        base = cuda_kernels.QUANTIZE_ROWS
        out[name] = cuda_kernels.CudaKernel(os.path.relpath(path, cuda_kernels.CSRC), base.symbol,
                                            base.argtypes[:-1])
    return out


def run_variant(kernel, threads, x):
    """Launch a variant with the wrapper's plan, at ``threads`` threads a
    CTA if given."""
    import torch

    from radnet_torch.ops import quant
    from radnet_torch.ops.cuda_kernels import ptr

    rows = x.shape[0]
    length = x.numel() // rows
    plan = quant.quantize_plan(length, x.dtype)
    if threads is not None:
        plan = plan._replace(threads=threads)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    kernel.launch(ptr(x), ptr(q), ptr(scale), rows, length, quant._DTYPE_CODE[x.dtype], *plan)
    return quant.Quantized(q, scale)


def variants_main(smi: str) -> int:
    import torch

    from radnet_torch.ops import cuda_kernels, quant

    kernels = variant_kernels(cuda_kernels)
    earlier = cs.earlier_kernels()["quantize_rows"]
    cuda_kernels.build(list({id(k): k for k in kernels.values()}.values()) + [earlier])
    for name, k in kernels.items():
        if VARIANTS[name][0]:
            print(json.dumps({"variant": name, "ptxas": ptxas_report(k)}), flush=True)
    ok = True
    for i, (case, shape, dtype) in enumerate(SHAPES):
        for fill in ("half_zero", "no_zero"):
            x = inputs(shape, dtype, fill, 100 + i)
            ref = quant.quantize_rows_plain(x)
            row = {"case": case, "fill": fill, "nvidia_smi": smi,
                   "plan": quant.quantize_plan(x.numel() // x.shape[0], x.dtype)._asdict()}
            for name, k in kernels.items():
                fn = (lambda k=k, t=VARIANTS[name][1]: run_variant(k, t, x))
                got = fn()
                torch.cuda.synchronize()
                equal = bool(torch.equal(got.q, ref.q) and torch.equal(got.scale, ref.scale))
                ok &= equal
                row[f"{name}_ms"] = cs.kernel_ms(fn, "quantize_rows_kernel") if equal else "differs"
                del got
            row["earlier_ms"] = cs.kernel_ms(lambda: cs.earlier_quantize_rows(earlier, x),
                                             "quantize_rows_two_pass_kernel")
            print(json.dumps(row), flush=True)
            del x, ref
            torch.cuda.empty_cache()
    return 0 if ok else 1


def inputs(shape, dtype: str, fill: str, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda")
    if fill == "all_zero":
        x.zero_()
    elif fill == "half_zero":
        x.relu_()
    else:
        x.abs_().add_(1e-3)
    return x.to(getattr(torch, dtype))


def main() -> int:
    import torch

    from radnet_torch.ops import cuda_kernels, quant

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", action="store_true", help="time the variants instead")
    ap.add_argument("--sass-dir", default=os.path.join("radnet_torch", "_build", "quantize_rows_probe"),
                    help="where the SASS dumps go")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("quantize_rows_probe: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.variants:
        return variants_main(smi)
    os.makedirs(args.sass_dir, exist_ok=True)
    earlier = cs.earlier_kernels()["quantize_rows"]
    kernels = {"quantize_rows": cuda_kernels.QUANTIZE_ROWS, "earlier": earlier}
    cuda_kernels.build(list(kernels.values()))
    for name, k in kernels.items():
        print(json.dumps({"library": name, "ptxas": ptxas_report(k)}), flush=True)
        for row in sass_summary(k.lib_path(), name, args.sass_dir):
            print(json.dumps(row), flush=True)

    run = {"quantize_rows": (quant.quantize_rows_cuda, "quantize_rows_kernel"),
           "earlier": (lambda x: cs.earlier_quantize_rows(earlier, x), "quantize_rows_two_pass_kernel")}
    ok = True
    for i, (case, shape, dtype) in enumerate(SHAPES):
        for fill in FILLS:
            x = inputs(shape, dtype, fill, 100 + i)
            ref = quant.quantize_rows_plain(x)
            row = {"case": case, "shape": list(shape), "dtype": dtype, "fill": fill,
                   "zero_share": float((x == 0).float().mean()), "nvidia_smi": smi}
            for name, (fn, symbol) in run.items():
                got = fn(x)
                torch.cuda.synchronize()
                equal = bool(torch.equal(got.q, ref.q) and torch.equal(got.scale, ref.scale))
                ok &= equal
                row[f"{name}_equal"] = equal
                row[f"{name}_ms"] = cs.kernel_ms(lambda fn=fn: fn(x), symbol)
                del got
            row["bound_ms"] = cs.bound_ms(x.numel() * (x.element_size() + 1) + 4 * x.shape[0],
                                          4.0 * x.numel())[0]
            print(json.dumps(row), flush=True)
            del x, ref
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
