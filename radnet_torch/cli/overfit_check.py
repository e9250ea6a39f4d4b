"""End-to-end learning check on synthetic panels.

Trains the detector from its plain seeded init on a tiny synthetic set
(bright rectangles on dark 600 x 600 panels; the class is the aspect: wide
= 'boat', tall = 'human') with the joint step and the trunk trainable, then
predicts 8 of the panels at a score cut of 0.5 and scores them: the whole
path (target assignment on the device, the train step, proposal decode, the
RoI head, the inference cascade, VOC evaluation) must learn to put
detections on the rectangles.  It is the JAX package's
``scripts/overfit_check.py`` with the same flags, panels, batches, config,
log lines and JSON summary, plus ``--device`` (default cuda).

Prints a JSON summary on the standard output, one loss line every 50 steps
on the standard error, and exits 0 exactly when there is a detection and
some class has an AP above 0 (the JAX script's criterion), 1 otherwise.

Use vgg16 for this check: ResNet50 with frozen batch norm does not train
from a random init (the JAX script's note).

Examples:
  python -m radnet_torch.cli.overfit_check                  # the card, 300 steps
  python -m radnet_torch.cli.overfit_check --device cpu --steps 2
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from radnet_torch.config import Config
from radnet_torch.data.pipeline import batch_samples, make_sample, upload_batch
from radnet_torch.engine.steps import draw_step, make_train_step
from radnet_torch.engine.train_state import create_train_state
from radnet_torch.evaluation import evaluate_detections, match_detections
from radnet_torch.inference import RADNet, resolve_device

N_SCORED = 8  # panels predicted and scored
LOG_EVERY = 50  # steps between loss lines
SCORE_THRESHOLD = 0.5  # the detector's score cut while scoring


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--network", default="vgg16")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--n-panels", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; without a card pass --device cpu)")
    return p


def make_panel(rng, size=600, n_boxes=2):
    """A dark ``size`` x ``size`` BGR panel with ``n_boxes`` bright
    rectangles, and their boxes: the JAX script's draws in its order."""
    img = np.full((size, size, 3), 30, np.uint8)
    boxes = []
    for _ in range(n_boxes):
        wide = rng.random() < 0.5
        w = int(rng.integers(120, 220)) if wide else int(rng.integers(50, 90))
        h = int(rng.integers(50, 90)) if wide else int(rng.integers(120, 220))
        x1 = int(rng.integers(0, size - w))
        y1 = int(rng.integers(0, size - h))
        img[y1 : y1 + h, x1 : x1 + w] = 220
        boxes.append({"class": "boat" if wide else "human", "x1": x1, "y1": y1,
                      "x2": x1 + w, "y2": y1 + h})
    return img, boxes


def check_config(network: str) -> Config:
    """The check's config: one 600 px tile a panel, no base weights, no
    photometric augmentation, batch 8, two classes, the default anchors."""
    return Config(
        network=network,
        class_mapping={"boat": 0, "human": 1, "bg": 2},
        tile_size=600,
        tile_overlap=600,
        base_net_weights=None,
        use_noise=False,
        use_brightness=False,
        batch_size=8,
    )


def stage_batches(samples, rng, config: Config, device, n_batches: int = 4) -> list[dict]:
    """``n_batches`` batches of ``config.batch_size`` samples picked with
    replacement by ``rng``, on ``device`` (the check reuses them in turn, so
    its step rate leaves out the host's data path)."""
    batches = []
    for _ in range(n_batches):
        picks = rng.choice(len(samples), size=config.batch_size, replace=True)
        batches.append(upload_batch(batch_samples([samples[i] for i in picks]), device))
    return batches


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(state, config: Config, batches: list, steps: int,
          generator: torch.Generator) -> tuple[dict, float, float]:
    """``steps`` joint steps of ``state`` in place, trunk trainable, step
    ``i`` on ``batches[i % len(batches)]`` with draws from ``generator`` (a
    generator on the state's device).  Returns the last step's metrics, the
    first step's seconds and the other steps'."""
    device = next(state.model.parameters()).device
    step = make_train_step(state, config, trunk_trainable=True)
    _sync(device)
    t0 = time.perf_counter()
    first_s = 0.0
    metrics = {}
    for i in range(steps):
        draws = draw_step(generator, config, config.batch_size, device)
        metrics = step(batches[i % len(batches)], draws)
        if i == 0:
            _sync(device)
            first_s = time.perf_counter() - t0
        if i % LOG_EVERY == 0:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {i}: total={m['total_loss']:.3f} rpn_cls={m['loss_rpn_cls']:.3f} "
                  f"det_acc={m['detector_acc']:.3f} overlap={m['mean_overlapping_bboxes']:.1f}",
                  file=sys.stderr)
    _sync(device)
    return metrics, first_s, time.perf_counter() - t0 - first_s


def score(radnet: RADNet, panels: list) -> dict:
    """Each ``(image, boxes)`` panel predicted alone, then the detections
    scored at IoU 0.5: their count, the boxes' count, the share of boxes
    found (a match scoring above 0), mAP and each class's AP."""
    all_dets, all_gt = [], []
    for img, boxes in panels:
        all_dets.extend(radnet.predict([img]))
        all_gt.extend(dict(b) for b in boxes)
    result = evaluate_detections(all_dets, all_gt, 0.5)
    T, P = match_detections(all_dets, all_gt, 0.5)
    tp = sum(int(t) for cls in T for t, p in zip(T[cls], P[cls]) if p > 0)
    return {"n_detections": len(all_dets), "n_gt": len(all_gt),
            "recall": round(tp / max(len(all_gt), 1), 3), "mAP": result["mAP"],
            "per_class": result["per_class"]}


def passed(summary: dict) -> bool:
    """The check's criterion: a detection, and some class with an AP above 0."""
    return summary["n_detections"] > 0 and any(v > 0 for v in summary["per_class"].values())


def run(args, config: Config) -> dict:
    """The check of parsed ``args`` at ``config``: the summary."""
    device = resolve_device(args.device)
    state = create_train_state(config, torch.Generator().manual_seed(0), device,
                               learning_rate=args.lr, base_net_trainable=True)
    rng = np.random.default_rng(0)
    panels = [make_panel(rng) for _ in range(args.n_panels)]
    samples = [make_sample(img, boxes, config, config.class_mapping) for img, boxes in panels]
    batches = stage_batches(samples, rng, config, device)
    generator = torch.Generator(device=device).manual_seed(1)
    metrics, first_s, train_s = train(state, config, batches, args.steps, generator)

    radnet = RADNet(config, state.model, device=device)
    radnet.bbox_threshold = SCORE_THRESHOLD
    scored = score(radnet, panels[:N_SCORED])
    return {
        "steps": args.steps,
        "compile_seconds": round(first_s, 1),
        "train_seconds": round(train_s, 1),
        "steps_per_sec": round((args.steps - 1) / train_s, 2),
        "images_per_sec": round((args.steps - 1) * config.batch_size / train_s, 1),
        "final_total_loss": float(metrics["total_loss"]),
        **scored,
    }


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    summary = run(args, check_config(args.network))
    print(json.dumps(summary, indent=2))
    return 0 if passed(summary) else 1


if __name__ == "__main__":
    sys.exit(main())
