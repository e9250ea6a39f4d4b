#!/usr/bin/env python3
"""Readings that set chip_smoke.py's card-vs-CPU limits for the int8 head
(``INT8_HEAD_LIMIT``, ``INT8_UNMATCHED_SHARE``).

For each backbone and several weight seeds, the calibrated serving weights
(made as chip_smoke.py's serve phases make them) go through
``chip_smoke.int8_card_vs_cpu`` on the first serving panel's canvases: a
float32 2-tile batch's detections card vs CPU, and the int8 head alone on
identical pooled inputs.  Beside each reading, the same batch on the card
through the float head (how far int8 moves the detections).  Then once more
for the first seed with a deliberate fault on the card: ResNet50's 3x3
im2col one column off (the quantized map rolled one column before the
product), VGG16's fc rows one RoI off (the quantized rows rolled by one).
One JSON line per reading.

Card only (it needs chip_smoke.py beside it at the repo root):
  python3 scripts/int8_card_vs_cpu_probe.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEEDS = {"resnet50": (0, 1, 2), "vgg16": (8, 9, 10)}  # the first is the serve phase's


@contextlib.contextmanager
def faulty_product(kind: str):
    """``radnet_torch.ops.quant.int8_gemm_cuda`` fed a shifted operand: a 4-D
    map rolled one column ("im2col_column") or 2-D rows rolled by one
    ("rows")."""
    import torch

    from radnet_torch.ops import quant

    real = quant.int8_gemm_cuda

    def shifted(a, b, bias=None, rows_per_sample=1, **epilogue):
        q = a.q
        if kind == "im2col_column" and q.dim() == 4:
            q = torch.roll(q, 1, dims=2).contiguous()
        elif kind == "rows" and q.dim() == 2:
            q = torch.roll(q, 1, dims=0).contiguous()
        return real(quant.Quantized(q, a.scale), b, bias, rows_per_sample, **epilogue)

    quant.int8_gemm_cuda = shifted
    try:
        yield
    finally:
        quant.int8_gemm_cuda = real


def serving_weights(cs, cfg, dev, seed: int):
    """(calibrated weights, the first serving panel's first batch of
    canvases), as chip_smoke's serve phases make them."""
    import numpy as np
    import torch

    from radnet_torch.data.tiling import plan_tiles
    from radnet_torch.inference import RADNet
    from radnet_torch.models.detector import build_model, init_weights

    gen = torch.Generator().manual_seed(seed)
    radnet = RADNet(cfg, init_weights(build_model(cfg), gen), device=dev)
    small, scale, _, _ = radnet._prescale_panel(cs.bgr(cs.synthetic_grey_panel(cs.SEED)))
    tiles = plan_tiles(cs.PANEL_HW[1], cs.PANEL_HW[0], cfg.tile_size, cfg.tile_overlap)
    origins = np.round(tiles[:, :2] * scale).astype(np.int64)
    cs.calibrate_heads(radnet, radnet._window_canvases(small, origins[:2]), gen)
    images = radnet._window_canvases(small, origins[: cfg.infer_tile_batch])
    return {k: v.detach().cpu() for k, v in radnet.model.state_dict().items()}, images


def int8_vs_float(cs, weights, cfg, dev, images) -> int:
    """Detections of a 2-tile float32 batch on the card without a partner,
    int8 head against float head."""
    import torch

    from radnet_torch.inference import RADNet
    from radnet_torch.models.detector import build_model

    dets = []
    for quantize in ("int8", None):
        c = dataclasses.replace(cfg, compute_dtype="float32", infer_quantize=quantize)
        m = build_model(c)
        m.load_state_dict(weights)
        net = RADNet(c, m, device=dev)
        wh = torch.full((2, 2), float(c.img_size), device=dev)
        dets.append(cs.tile_detections(net._predict_tiles_impl(images[2:4].contiguous(), wh),
                                       c.n_classes - 1))
    return cs.unmatched(*dets)


def main() -> int:
    import torch

    import chip_smoke as cs
    from radnet_torch.config import Config
    from radnet_torch.ops import cuda_kernels

    if not torch.cuda.is_available():
        print("int8_card_vs_cpu_probe: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cuda_kernels.build(cuda_kernels.KERNELS)
    for network, seeds in SEEDS.items():
        cfg = Config() if network == "resnet50" else cs.vgg_config()
        fault = "im2col_column" if network == "resnet50" else "rows"
        for i, seed in enumerate(seeds):
            weights, images = serving_weights(cs, cfg, dev, seed)
            r = cs.int8_card_vs_cpu(weights, cfg, dev, images)
            r["int8_vs_float_unmatched_card"] = int8_vs_float(cs, weights, cfg, dev, images)
            print(json.dumps({"network": network, "seed": seed, "fault": None, **r}), flush=True)
            if i == 0:
                with faulty_product(fault):
                    r = cs.int8_card_vs_cpu(weights, cfg, dev, images)
                print(json.dumps({"network": network, "seed": seed, "fault": fault, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
