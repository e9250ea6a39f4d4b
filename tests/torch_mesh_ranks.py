"""Rank bodies of the port's mesh tests.

Each runs in every rank that ``radnet_torch.parallel.launch`` spawns, and a
spawned rank imports its target by module name, so this module imports only
numpy, torch and ``radnet_torch`` (never JAX, ``tests/util.py`` or the
conftest, which would bring JAX's virtual devices into every rank).
"""

from __future__ import annotations

import numpy as np
import torch

from radnet_torch.config import Config
from radnet_torch.inference import RADNet
from radnet_torch.models.detector import build_model
from radnet_torch.parallel.mesh import make_mesh


def build_net(cfg_dict: dict, state: dict, mesh) -> RADNet:
    """A RADNet on the CPU from a Config dict and a numpy state_dict."""
    cfg = Config.from_dict(cfg_dict)
    model = build_model(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return RADNet(cfg, model, device="cpu", mesh=mesh)


def _numpy(out) -> tuple:
    return tuple(t.detach().cpu().numpy() for t in out)


def run_jobs(model_parallel: int, jobs: list) -> list:
    """Each job on this rank's mesh (all the launched ranks, the model axis
    ``model_parallel``), rank 0's results in order.  A job is a dict:

    * ``{"kind": "tiles", "cfg", "state", "images", "wh"}``: the cascade on
      one batch of host canvases -> (boxes, scores, valid);
    * ``{"kind": "roi_heads", "cfg", "state", "fmap", "rois"}``: RoI pooling
      and the head (``quantize=True``: int8 where the config says so) on an
      NHWC feature map and xywh RoIs -> (class probs, deltas);
    * ``{"kind": "panel", "cfg", "state", "panel"}``: ``predict`` on one
      panel -> its detections.
    """
    mesh = make_mesh(model_parallel=model_parallel, device_type="cpu")
    out = []
    for job in jobs:
        net = build_net(job["cfg"], job["state"], mesh)
        if job["kind"] == "tiles":
            out.append(_numpy(net._predict_host(job["images"], job["wh"])))
        elif job["kind"] == "roi_heads":
            fmap = torch.from_numpy(job["fmap"]).permute(0, 3, 1, 2)
            with torch.inference_mode():
                out.append(_numpy(net.model.roi_heads(fmap, torch.from_numpy(job["rois"]),
                                                      quantize=True, head=net._tp_head)))
        elif job["kind"] == "panel":
            out.append(net.predict([job["panel"]]))
        else:
            raise ValueError(f"unknown job {job['kind']!r}")
    return out


def fails_on(rank: int) -> int:
    """Raise on ``rank`` after the rendezvous; the others wait in a
    collective for it."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.all_reduce(torch.zeros(1))
    return 0


def grey_canvases(n: int, canvas: int, valid: int, seed: int) -> np.ndarray:
    """``n`` uint8 canvases ``(canvas, canvas, 3)``: a grey panel of bright
    blocks on a dark ground in the top-left ``valid`` square, zero beyond."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, canvas, canvas, 3), np.uint8)
    for i in range(n):
        grey = rng.integers(0, 60, (valid, valid), dtype=np.uint8)
        for _ in range(8):
            x, y = rng.integers(0, valid - 20, 2)
            bw, bh = rng.integers(8, 30, 2)
            grey[y : y + bh, x : x + bw] = rng.integers(120, 255)
        out[i, :valid, :valid] = grey[..., None]
    return out
