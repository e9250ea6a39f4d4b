"""Evaluation from the command line: test-set inference and VOC mAP.

Predicts every panel of an annotation CSV, writes each panel with its
detections outlined and labelled ``class: percent`` to ``<model>/test/``
(a class name with a character the label glyph table lacks stops the run
before the first panel), computes per-class AP and mAP
(``radnet_torch.evaluation``), draws the precision/recall curves to
``<model>/viz/precision_recall.svg``, and writes ``test_accuracy.json``
(and with ``--coco-map`` also ``test_accuracy_coco.json``).  Panels are
pipelined through the card: panel k+1 is dispatched before panel k is
collected.  ``--compare REF_JSON`` prints per-class AP deltas against a
reference accuracy file and exits 2 when the mAP falls short of it by more
than ``--parity-tolerance``.

The JAX package draws the curves with matplotlib as a PNG; the card's host
has no matplotlib, so they are an SVG here, with the same curves, legend
and title.  ``--n-devices N [--model-parallel M]`` predicts over a mesh of
N ranks (radnet_torch/parallel); rank 0 writes the files.

Example:
  python -m radnet_torch.cli.test --models-path models \\
      --model-name faster_rcnn_resnet50_x --test-annot data/test.csv --test-data data/test
"""

from __future__ import annotations

import argparse
import html
import json
import os
import sys
import time

import numpy as np

from radnet_torch.cli.common import (add_mesh_args, add_quantize_arg, draw_detections,
                                     mesh_from_args, model_dir, quantize_from_args,
                                     require_drawable, run_on_mesh)
from radnet_torch.data.dataset import get_data, get_image
from radnet_torch.data.png import write_png
from radnet_torch.evaluation import evaluate_detections, evaluate_detections_multi

# matplotlib's default colour cycle, which the JAX package's curves take.
CURVE_COLORS = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b",
                "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--models-path", default="models")
    p.add_argument("--model-name", default="faster_rcnn_resnet50_raod_base")
    p.add_argument("--test-annot", default="data/test.csv")
    p.add_argument("--test-data", default="data/test")
    p.add_argument("--gt-iou-threshold", type=float, default=0.5)
    p.add_argument("--viz-img-type", default=None,
                   help="image type used for the annotated output PNGs")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--coco-map", action="store_true",
                   help="also report COCO-style mAP@[.5:.95] (per-threshold APs written to "
                        "test_accuracy_coco.json; test_accuracy.json keeps its single-threshold format)")
    p.add_argument("--compare", default=None, metavar="REF_JSON",
                   help="a test_accuracy.json to compare with: per-class AP deltas and a "
                        "pass/fail verdict on the mAP")
    p.add_argument("--parity-tolerance", type=float, default=0.005,
                   help="max acceptable mAP shortfall vs --compare (0.005 = 0.5 pts)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; without a card pass --device cpu)")
    add_mesh_args(p)
    add_quantize_arg(p)
    return p


def compare_accuracy(ours: dict, ref: dict, tolerance: float = 0.005) -> tuple[bool, str]:
    """Per-class AP deltas + a parity verdict vs a reference accuracy dict.

    Returns ``(parity_ok, report)``.  Parity = our mAP is no more than
    ``tolerance`` below the reference's (exceeding it is fine); per-class
    rows are informational.  Classes missing on either side are reported
    as n/a and excluded from the verdict."""
    lines = [f"{'class':<12} {'ref AP':>8} {'ours':>8} {'delta':>8}"]
    for key in sorted((set(ref) | set(ours)) - {"mAP"}):
        r, o = ref.get(key), ours.get(key)
        if r is None or o is None:
            lines.append(f"{key:<12} {r if r is not None else 'n/a':>8} "
                         f"{o if o is not None else 'n/a':>8} {'n/a':>8}")
            continue
        lines.append(f"{key:<12} {r:>8.4f} {o:>8.4f} {o - r:>+8.4f}")
    r_map, o_map = ref.get("mAP"), ours.get("mAP")
    if r_map is None or o_map is None:
        lines.append("mAP missing on one side; no verdict")
        return False, "\n".join(lines)
    delta = o_map - r_map
    ok = delta >= -tolerance
    lines.append(f"{'mAP':<12} {r_map:>8.4f} {o_map:>8.4f} {delta:>+8.4f}")
    lines.append(f"PARITY {'OK' if ok else 'FAIL'}: mAP delta {delta:+.4f} (tolerance -{tolerance:.4f})")
    return ok, "\n".join(lines)


def precision_recall_svg(result: dict, size: int = 640) -> str:
    """The precision/recall curves of ``evaluate_detections``'s result as
    one SVG document: per class a solid curve, its interpolated curve dashed
    in the same colour, a ``class: AP %`` legend and an ``mAP`` title.  The
    curves' points ride along unrounded in a ``data-curves`` attribute."""
    pad_l, pad_r, pad_t, pad_b = 64, 24, 40, 56
    pw, ph = size - pad_l - pad_r, size - pad_t - pad_b

    def pt(x, y):
        return f"{pad_l + pw * x:.2f},{pad_t + ph * (1.0 - y):.2f}"

    body = []
    for t in np.linspace(0.0, 1.0, 6):
        x, y = pad_l + pw * t, pad_t + ph * (1.0 - t)
        body.append(f'<line x1="{pad_l}" y1="{y:.2f}" x2="{pad_l + pw}" y2="{y:.2f}" stroke="#e4e2de"/>')
        body.append(f'<text x="{pad_l - 8}" y="{y + 4:.2f}" text-anchor="end">{t:.1f}</text>')
        body.append(f'<text x="{x:.2f}" y="{pad_t + ph + 18}" text-anchor="middle">{t:.1f}</text>')
    body.append(f'<rect x="{pad_l}" y="{pad_t}" width="{pw}" height="{ph}" fill="none" stroke="#52514e"/>')
    legend = []
    for k, (key, curve) in enumerate(result["curves"].items()):
        color = CURVE_COLORS[k % len(CURVE_COLORS)]
        for xs, ys, dash in ((curve["recall"], curve["precision"], ""),
                             (curve["interpolated_recall"], curve["interpolated_precision"],
                              ' stroke-dasharray="6 4"')):
            points = " ".join(pt(x, y) for x, y in zip(xs, ys))
            body.append(f'<polyline points="{points}" fill="none" stroke="{color}" stroke-width="1.5"{dash}/>')
        ap = result["per_class"][key]
        y = pad_t + 20 + 18 * k
        legend.append(f'<line x1="{pad_l + pw - 170}" y1="{y - 4}" x2="{pad_l + pw - 146}" y2="{y - 4}" '
                      f'stroke="{color}" stroke-width="2"/>'
                      f'<text x="{pad_l + pw - 140}" y="{y}">{html.escape(f"{key}: {100 * ap:.2f} %")}</text>')
    payload = html.escape(json.dumps(result["curves"]), quote=True)
    return "".join([
        f'<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 {size} {size}" width="{size}" '
        f'height="{size}" font-family="Helvetica, Arial, sans-serif" font-size="12" '
        f'data-curves="{payload}">',
        f'<rect width="{size}" height="{size}" fill="#ffffff"/>',
        f'<text x="{pad_l + pw / 2:.2f}" y="{pad_t - 14}" text-anchor="middle" font-size="15">'
        f'mAP: {100 * result["mAP"]:.2f} %</text>',
        *body, *legend,
        f'<text x="{pad_l + pw / 2:.2f}" y="{size - 14}" text-anchor="middle">Recall (TP / TP + FN)</text>',
        f'<text x="16" y="{pad_t + ph / 2:.2f}" text-anchor="middle" '
        f'transform="rotate(-90 16 {pad_t + ph / 2:.2f})">Precision (TP / TP + FP)</text>',
        "</svg>\n",
    ])


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    return run_on_mesh(args, evaluate, args)


def evaluate(args) -> int:
    """The evaluation on this process (one rank of a mesh under
    ``--n-devices``: every rank predicts every panel, rank 0 writes the
    files and returns the exit code)."""
    from radnet_torch.inference import load_radnet

    mesh = mesh_from_args(args)
    main_rank = mesh is None or mesh.is_main
    model_path = model_dir(args.models_path, args.model_name)

    print("\n\nMaking predictions on TEST data.")
    radnet = load_radnet(model_path, device=args.device, quantize=quantize_from_args(args),
                         mesh=mesh)
    require_drawable(radnet.C.class_mapping)
    data_test, _, _ = get_data(args.test_annot, args.test_data, radnet.C.img_types)
    if args.limit:
        data_test = data_test[: args.limit]
    # A missing output folder is created, not skipped: a failed PNG write raises.
    test_dir = os.path.join(model_path, "test")
    if main_rank:
        os.makedirs(test_dir, exist_ok=True)

    all_dets: list = []
    all_gt: list = []
    elapsed = []
    viz_type = args.viz_img_type or radnet.C.img_types[0]

    def _load(img_meta):
        """The panels predict_from_path would read, split out so the next
        panel's decode overlaps the card's work."""
        if radnet.C.use_img_type:
            return [get_image(img_meta["filepath"], [t]) for t in radnet.C.img_types]
        return [get_image(img_meta["filepath"], radnet.C.img_types)]

    def _finish(img_meta, detections):
        all_dets.extend(detections)
        all_gt.extend(img_meta["bboxes"])
        if not main_rank:
            return
        try:
            img = get_image(img_meta["filepath"], [viz_type], writable=True)
        except FileNotFoundError:  # no panel of the viz type: nothing to draw
            img = None
        if img is not None:
            draw_detections(img, detections)
            write_png(os.path.join(test_dir, img_meta["filepath"].split("/")[-1]), img)

    # "Average prediction time" is the mean gap between two collected panels.
    pending = None
    t_last = time.time()
    for idx, img_meta in enumerate(data_test):
        print(f"{img_meta['filepath']} ({idx + 1}/{len(data_test)})")
        handles = radnet.predict_dispatch(_load(img_meta))
        if pending is not None:
            prev_meta, prev_handles = pending
            detections = radnet.predict_collect(prev_handles)
            elapsed.append(time.time() - t_last)
            t_last = time.time()
            _finish(prev_meta, detections)
        pending = (img_meta, handles)
    if pending is not None:
        prev_meta, prev_handles = pending
        detections = radnet.predict_collect(prev_handles)
        elapsed.append(time.time() - t_last)
        _finish(prev_meta, detections)
    if not main_rank:
        return 0

    result = evaluate_detections(all_dets, all_gt, args.gt_iou_threshold)
    for key in result["curves"]:
        print(f"{key} AP: {result['per_class'][key]}\n")
    os.makedirs(os.path.join(model_path, "viz"), exist_ok=True)
    with open(os.path.join(model_path, "viz", "precision_recall.svg"), "w") as f:
        f.write(precision_recall_svg(result))

    accuracy = dict(result["per_class"])
    accuracy["mAP"] = result["mAP"]
    with open(os.path.join(model_path, "test_accuracy.json"), "w") as f:
        json.dump(accuracy, f, indent=4)

    print("mAP: " + str(result["mAP"]))
    if args.coco_map:
        coco = evaluate_detections_multi(all_dets, all_gt)
        with open(os.path.join(model_path, "test_accuracy_coco.json"), "w") as f:
            json.dump(coco, f, indent=4)
        print(f"mAP@[.5:.95]: {coco['mAP_50_95']:.4f}  "
              f"(AP50 {coco['AP50']:.4f}, AP75 {coco['AP75']:.4f})")
    if elapsed:
        # The steady-state line leaves out panel 0, which pays first-call costs.
        print(f"Average prediction time: {np.mean(elapsed):.3f}s")
        if len(elapsed) > 1:
            print(f"Steady-state prediction time (excl. first panel): {np.mean(elapsed[1:]):.3f}s")

    if args.compare:
        with open(args.compare) as f:
            ref = json.load(f)
        ok, report = compare_accuracy(accuracy, ref, args.parity_tolerance)
        print("\nParity vs " + args.compare)
        print(report)
        return 0 if ok else 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
