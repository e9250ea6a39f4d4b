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


def draws_to_numpy(draws) -> dict:
    """A StepDraws as a dict of numpy arrays (it pickles to spawned ranks)."""
    import dataclasses

    out = {f: getattr(draws, f).numpy() for f in ("rpn_pos_bits", "rpn_neg_bits",
                                                   "roi_pos_u", "roi_neg_u")}
    if draws.photometric is not None:
        for f in dataclasses.fields(draws.photometric):
            v = getattr(draws.photometric, f.name)
            if isinstance(v, torch.Tensor):
                out[f"photo.{f.name}"] = v.numpy()
    if draws.head_masks is not None:
        out["mask1"], out["mask2"] = (m.numpy() for m in draws.head_masks)
    return out


def draws_from_numpy(d: dict):
    from radnet_torch.engine.steps import StepDraws
    from radnet_torch.ops.augment_device import PhotometricDraws

    t = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    photo = {k[len("photo."):]: v for k, v in t.items() if k.startswith("photo.")}
    return StepDraws(t["rpn_pos_bits"], t["rpn_neg_bits"], t["roi_pos_u"], t["roi_neg_u"],
                     PhotometricDraws(**photo) if photo else None,
                     (t["mask1"], t["mask2"]) if "mask1" in t else None)


def _replicated_equal(state, mesh) -> dict:
    """Whether every replicated parameter is bit-equal across each axis of
    the mesh (each rank's whole flat copy gathered over the axis)."""
    from radnet_torch.parallel.collectives import all_gather
    from radnet_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

    flat = torch.cat([p.detach().reshape(-1) for n, p in state.model.named_parameters()
                      if n not in state.shard_dims])
    out = {}
    for axis in (DATA_AXIS, MODEL_AXIS):
        g = all_gather(flat[None], mesh, axis, dim=0)
        out[axis] = all(torch.equal(g[0], g[i]) for i in range(g.shape[0]))
    return out


def train_steps(model_parallel: int, jobs: list) -> list:
    """Each job's train steps of one whole batch on this rank's mesh (all
    the launched ranks, the model axis ``model_parallel``; rank 0's results
    in order): each rank takes its rows of the batch and of the draws.  A
    job's result holds the metrics of each step, the whole state after them
    (``gather_train_state``), and whether the replicated parameters are
    bit-equal over each axis after each step.

    A job: ``cfg`` (a Config dict), ``state`` (a numpy state_dict),
    ``batch`` (numpy), ``draws`` (a list of :func:`draws_to_numpy`, one a
    step), ``lr``, ``trainable``, and optionally ``fault``:
    "mean_of_ratios" has each rank divide its losses by its own tiles'
    denominators (no all-reduce of them), a deliberately wrong step."""
    from radnet_torch.engine import steps

    mesh = make_mesh(model_parallel=model_parallel, device_type="cpu")
    out = []
    for job in jobs:
        real = steps._whole_batch
        if job.get("fault") == "mean_of_ratios":
            steps._whole_batch = lambda mesh, *local: None
        elif job.get("fault") is not None:
            raise ValueError(f"unknown fault {job['fault']!r}")
        try:
            out.append(_train_job(mesh, job))
        finally:
            steps._whole_batch = real
    return out


def _train_job(mesh, job: dict) -> dict:
    from radnet_torch.data.pipeline import rank_rows
    from radnet_torch.engine.steps import make_step, rank_draws
    from radnet_torch.engine.train_state import create_train_state
    from radnet_torch.parallel.mesh import gather_train_state

    cfg = Config.from_dict(job["cfg"])
    model = build_model(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in job["state"].items()})
    state = create_train_state(cfg, torch.Generator(), "cpu", learning_rate=job["lr"],
                               base_net_trainable=job["trainable"], model=model.train(),
                               mesh=mesh)
    step = make_step(state, cfg, trunk_trainable=job["trainable"])
    batch = {k: torch.from_numpy(np.array(v)) for k, v in rank_rows(job["batch"], mesh).items()}
    metrics, equal = [], []
    for d in job["draws"]:
        m = step(batch, rank_draws(draws_from_numpy(d), mesh))
        metrics.append({k: float(v) for k, v in m.items()})
        equal.append(_replicated_equal(state, mesh))
    model_sd, opt_sd = gather_train_state(state)
    return {"metrics": metrics, "equal": equal, "shard_dims": dict(state.shard_dims),
            "model": {k: v.numpy() for k, v in model_sd.items()},
            "optimizer": _tree_numpy(opt_sd)}


def bundle_steps(job: dict) -> dict:
    """A bundle of len(job["draws"]) joint steps against as many single
    steps, each from the same state on this rank's mesh (all the launched
    ranks on the data axis), each rank with its rows of the batches and the
    draws.  Rank 0's: whether the bundle is a CUDA graph, whether the
    metrics and the parameters are bit-equal, and each state's step."""
    from radnet_torch.data.pipeline import rank_rows
    from radnet_torch.engine import steps
    from radnet_torch.engine.train_state import create_train_state

    mesh = make_mesh(model_parallel=1, device_type="cpu")
    cfg = Config.from_dict(job["cfg"])
    states = []
    for _ in range(2):
        model = build_model(cfg)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in job["state"].items()})
        states.append(create_train_state(cfg, torch.Generator(), "cpu", learning_rate=job["lr"],
                                         model=model.train(), mesh=mesh))
    batches = [{k: torch.from_numpy(np.array(v)) for k, v in rank_rows(b, mesh).items()}
               for b in job["batches"]]
    draws = [steps.rank_draws(draws_from_numpy(d), mesh) for d in job["draws"]]
    bundle = steps.make_train_bundle(states[0], cfg, len(draws))
    got = bundle(batches, draws)
    step = steps.make_train_step(states[1], cfg)
    want = [step(b, d) for b, d in zip(batches, draws)]
    return {"graph": isinstance(bundle, steps.GraphBundle),
            "metrics_equal": all(torch.equal(got[k], torch.stack([m[k] for m in want]))
                                 for k in steps.METRIC_KEYS),
            "params_equal": all(torch.equal(a, b) for a, b in zip(states[0].model.parameters(),
                                                                  states[1].model.parameters())),
            "steps": [s.step for s in states]}


def _tree_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.numpy()
    if isinstance(obj, dict):
        return {k: _tree_numpy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_tree_numpy(v) for v in obj]
    return obj


def restore_and_gather(model_parallel: int, cfg_dict: dict, ckpt_path: str) -> dict:
    """A checkpoint restored into a train state sharded on this rank's mesh,
    then gathered whole again (rank 0's): ``{"step", "model",
    "optimizer"}`` as numpy, and each rank's shard shapes."""
    from radnet_torch.engine import checkpoint as ckpt
    from radnet_torch.engine.train_state import create_train_state
    from radnet_torch.parallel.mesh import gather_train_state

    mesh = make_mesh(model_parallel=model_parallel, device_type="cpu")
    cfg = Config.from_dict(cfg_dict)
    state = create_train_state(cfg, torch.Generator().manual_seed(1), "cpu",
                               base_net_trainable=cfg.base_net_cont_trainable, mesh=mesh)
    state, best = ckpt.restore_checkpoint(ckpt_path, state)
    model_sd, opt_sd = gather_train_state(state)
    shapes = {k: tuple(v.shape) for k, v in state.model.state_dict().items()}
    return {"step": state.step, "best": best, "model": _tree_numpy(model_sd),
            "optimizer": _tree_numpy(opt_sd), "shard_shapes": shapes}
