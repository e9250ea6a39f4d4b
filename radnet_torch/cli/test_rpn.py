"""RPN-recall debugging from the command line.

Draws the raw first-stage proposals of each panel
(``RADNet.predict_region_proposals``) in white and the ground truth in green
to ``<model>/test_rpn/<panel>.png``, and reports the fraction of ground-truth
boxes that at least one proposal overlaps at IoU >= ``--iou``.
``--n-devices N`` splits the tiles over N ranks (radnet_torch/parallel;
the RPN has no head to shard, so ``--model-parallel`` only repeats work).

Example:
  python -m radnet_torch.cli.test_rpn --models-path models \\
      --model-name faster_rcnn_resnet50_x --annot data/train.csv --data data/train
"""

from __future__ import annotations

import argparse
import os
import sys

from radnet_torch.cli.common import (add_mesh_args, draw_rectangle, mesh_from_args, model_dir,
                                     run_on_mesh)
from radnet_torch.data.dataset import get_data, get_image
from radnet_torch.data.png import write_png
from radnet_torch.evaluation import box_iou


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--models-path", default="models")
    p.add_argument("--model-name", default="faster_rcnn_resnet50_raod_base")
    p.add_argument("--annot", default="data/train.csv")
    p.add_argument("--data", default="data/train")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--iou", type=float, default=0.5)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; without a card pass --device cpu)")
    add_mesh_args(p)
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    return run_on_mesh(args, test_rpn, args)


def test_rpn(args) -> int:
    """The debug run on this process (one rank of a mesh under
    ``--n-devices``: the tiles split over the data axis, as the RPN has no
    head to shard; rank 0 writes the files)."""
    from radnet_torch.inference import load_radnet

    mesh = mesh_from_args(args)
    main_rank = mesh is None or mesh.is_main
    model_path = model_dir(args.models_path, args.model_name)
    out_dir = os.path.join(model_path, "test_rpn")
    if main_rank:
        os.makedirs(out_dir, exist_ok=True)

    radnet = load_radnet(model_path, device=args.device, mesh=mesh)
    data, _, _ = get_data(args.annot, args.data, radnet.C.img_types)
    if args.limit:
        data = data[: args.limit]

    recalled = total = 0
    for img_meta in data:
        img = get_image(img_meta["filepath"], radnet.C.img_types, writable=True)
        proposals = radnet.predict_region_proposals(img)
        print(f"{img_meta['filepath']}: {len(proposals)} proposals")

        for p in proposals:
            draw_rectangle(img, p["x1"], p["y1"], p["x2"], p["y2"], (255, 255, 255), 4)
        for g in img_meta["bboxes"]:
            draw_rectangle(img, g["x1"], g["y1"], g["x2"], g["y2"], (0, 255, 0), 4)
            total += 1
            gt_box = (g["x1"], g["y1"], g["x2"], g["y2"])
            if any(box_iou((p["x1"], p["y1"], p["x2"], p["y2"]), gt_box) >= args.iou
                   for p in proposals):
                recalled += 1
        if main_rank:
            write_png(os.path.join(out_dir, img_meta["filepath"].split("/")[-1]), img)

    if total:
        print(f"RPN recall@{args.iou}: {recalled}/{total} = {recalled / total:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
