"""RPN-recall debugging from the command line.

Draws the raw first-stage proposals of each panel
(``RADNet.predict_region_proposals``) in white and the ground truth in green
to ``<model>/test_rpn/<panel>.png``, and reports the fraction of ground-truth
boxes that at least one proposal overlaps at IoU >= ``--iou``.

Example:
  python -m radnet_torch.cli.test_rpn --models-path models \\
      --model-name faster_rcnn_resnet50_x --annot data/train.csv --data data/train
"""

from __future__ import annotations

import argparse
import os
import sys

from radnet_torch.cli.common import draw_rectangle, model_dir
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
    p.add_argument("--n-devices", type=int, default=None, help="not ported yet")
    p.add_argument("--model-parallel", type=int, default=None, help="not ported yet")
    return p


def main(argv=None) -> int:
    from radnet_torch.inference import load_radnet

    args = build_argparser().parse_args(argv)
    if args.n_devices or args.model_parallel:
        raise NotImplementedError("--n-devices/--model-parallel are not ported yet (ROADMAP Queue 1 item 13)")
    model_path = model_dir(args.models_path, args.model_name)
    out_dir = os.path.join(model_path, "test_rpn")
    os.makedirs(out_dir, exist_ok=True)

    radnet = load_radnet(model_path, device=args.device)
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
        write_png(os.path.join(out_dir, img_meta["filepath"].split("/")[-1]), img)

    if total:
        print(f"RPN recall@{args.iou}: {recalled}/{total} = {recalled / total:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
