#!/usr/bin/env python3
"""Card probe: does a rank whose numeric settings differ from its peer's
change what a tensor-parallel serve returns?

Builds the default Config's ResNet50 with seeded weights (the output layers
calibrated as chip_smoke.py calibrates them), serves one synthetic 4400 x
3000 grey panel with --quantize int8 on the single device, then through
cli.serve's worker on two ranks sharing the card (a 1 x 2 mesh, gloo) in
two arms:

* ``same``: the launcher passes the caller's settings to both ranks;
* ``tf32_split``: rank 1 turns cuDNN's TF32 flag on, its peer keeps it off.

Prints, for each arm, the panel's detections against the single device's
(unmatched at 1e-3 on a confidence) and whether the two ranks' feature maps
and proposals, the RoI pool's inputs, were equal.  Run on the card from the
repository root:

  python3 scripts/mesh_settings_probe.py
"""

from __future__ import annotations

import io
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (the synthetic panel, the calibration, unmatched)


def serve_rank(tmp: str, path: str, arm: str, stdout=None) -> dict:
    """One rank of an arm: cli.serve's worker on a 1 x 2 mesh."""
    import torch
    import torch.distributed as dist

    from radnet_torch.cli import serve
    from radnet_torch.inference import RADNet

    if arm != "same" and dist.get_rank() == 1:
        torch.backends.cudnn.allow_tf32 = True
    pools = []
    real_head = RADNet._head

    def head(self, fmap, props):  # keep this rank's RoI pool input: the proposals and map
        pools.append((fmap.clone(), props.boxes.clone()))
        return real_head(self, fmap, props)

    RADNet._head = head
    args = serve.build_argparser().parse_args(
        ["--models-path", os.path.join(tmp, "models"), "--model-name", "m", "--quantize", "int8",
         "--n-devices", "2", "--model-parallel", "2"])
    serve.serve(args, stdin=io.StringIO(path + "\n") if stdout is not None else None, stdout=stdout)
    same = all(cs.ranks_agree(t) for fmap, boxes in pools for t in (fmap, boxes))
    return {"rank_inputs_equal": same}


def main() -> int:
    import torch

    from radnet_torch.cli import serve
    from radnet_torch.config import Config
    from radnet_torch.data.png import write_png
    from radnet_torch.data.tiling import plan_tiles
    from radnet_torch.inference import RADNet, save_radnet
    from radnet_torch.models.detector import build_model, init_weights
    from radnet_torch.parallel.launch import launch

    if not torch.cuda.is_available():
        print("mesh_settings_probe: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    tmp = tempfile.mkdtemp(prefix="mesh_probe_", dir=os.getcwd())
    cfg = Config()
    gen = torch.Generator().manual_seed(cs.SEED)
    radnet = RADNet(cfg, init_weights(build_model(cfg), gen), device="cuda")
    panel = cs.synthetic_grey_panel(cs.SEED)
    small, scale, _, _ = radnet._prescale_panel(cs.bgr(panel))
    tiles = plan_tiles(cs.PANEL_HW[1], cs.PANEL_HW[0], cfg.tile_size, cfg.tile_overlap)
    origins = (tiles[:2, :2] * scale).round().astype("int64")
    cs.calibrate_heads(radnet, radnet._window_canvases(small, origins), gen)
    save_radnet(os.path.join(tmp, "models", "m"), cfg, radnet.model)
    path = os.path.join(tmp, "panel.png")
    write_png(path, panel)

    def detections(text):
        rec = json.loads(text.splitlines()[0])
        return [dict(d, **{"class": d["label"], "prob": d["confidence"]}) for d in rec["detections"]]

    out = io.StringIO()
    serve.main(["--models-path", os.path.join(tmp, "models"), "--model-name", "m",
                "--quantize", "int8"], stdin=io.StringIO(path + "\n"), stdout=out)
    want = detections(out.getvalue())
    for arm in ("same", "tf32_split"):
        out = io.StringIO()
        res = launch(serve_rank, 2, devices=[0, 0], args=(tmp, path, arm), rank0_kwargs={"stdout": out})
        got = detections(out.getvalue())
        print(json.dumps({"arm": arm, "nvidia_smi": smi, "detections": [len(got), len(want)],
                          "unmatched": cs.unmatched(got, want), **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
