"""Single-panel prediction from the command line.

Reads the panel of every configured image type from a scan directory's
layout (:func:`resolve_type_path`), predicts across them, and writes
``arrays/predictions.json`` and ``img/predictions/{all,boat,human,
other}_predictions.png`` (the detections drawn on the scan's blended map,
when it has one: outlined and labelled ``class: percent`` in the first,
outlined in the class's colour in the others) under the scan directory.  A
class name with a character the label glyph table lacks stops the run
before the first panel.  ``--n-devices N
[--model-parallel M]`` predicts over a mesh of N ranks
(radnet_torch/parallel): the tiles split over the data axis, the RoI head
over the model axis; rank 0 writes the files.

Example:
  python -m radnet_torch.cli.predict --models-path models \\
      --model-name faster_rcnn_resnet50_x --scan-data-path scans/panel_17
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from radnet_torch.cli.common import (add_mesh_args, add_quantize_arg, draw_detections,
                                     draw_rectangle, mesh_from_args, model_dir,
                                     quantize_from_args, require_drawable, run_on_mesh)
from radnet_torch.cli.serve import detections_to_json
from radnet_torch.data.image import read_image
from radnet_torch.data.png import write_png


def resolve_type_path(scan_path: str, img_type: str) -> Path:
    """The file of an image type inside the scan layout."""
    path = Path(scan_path) / "img"
    grey = "grey" in img_type
    if "enhanced_topo" in img_type:
        path = path / "enhanced_topo_maps"
        name = ("enhanced_topo_map_object_level_grey.png" if grey
                else "enhanced_topo_map_object_level.png")
    elif "blended_map" in img_type:
        path = path / "blended_maps"
        name = ("blended_map_object_level_grey.png" if grey
                else "blended_topo_map_object_level.png")
    elif "topo" in img_type:
        path = path / "topo_maps"
        name = "topo_map_object_level_grey.png" if grey else "topo_map_object_level.png"
    else:
        raise ValueError(f"unknown image type {img_type!r}")
    return path / name


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--models-path", default="models")
    p.add_argument("--model-name", default="faster_rcnn_resnet50_raod_base")
    p.add_argument("--scan-data-path", required=True)
    p.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda; without a card pass --device cpu)",
    )
    add_mesh_args(p)
    add_quantize_arg(p)
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    return run_on_mesh(args, predict, args)


def predict(args) -> int:
    """Predict on this process (one rank of a mesh under ``--n-devices``:
    every rank predicts, rank 0 writes the files)."""
    from radnet_torch.inference import load_radnet

    mesh = mesh_from_args(args)
    print("\n\nMaking predictions.")
    radnet = load_radnet(model_dir(args.models_path, args.model_name), device=args.device,
                         quantize=quantize_from_args(args), mesh=mesh)
    require_drawable(radnet.C.class_mapping)
    images = [read_image(str(resolve_type_path(args.scan_data_path, t))) for t in radnet.C.img_types]
    detections = radnet.predict(images)
    if mesh is not None and not mesh.is_main:
        return 0

    scan = Path(args.scan_data_path)
    viz_path = scan / "img" / "blended_maps" / "blended_map_object_level_grey.png"
    pred_dir = scan / "img" / "predictions"
    pred_dir.mkdir(parents=True, exist_ok=True)
    arr_dir = scan / "arrays"
    arr_dir.mkdir(parents=True, exist_ok=True)
    with open(arr_dir / "predictions.json", "w") as f:
        json.dump(detections_to_json(detections), f, indent=4)

    def render(keep, out_name, color):
        try:
            img = read_image(str(viz_path))
        except FileNotFoundError:
            return
        chosen = [d for d in detections if keep(d)]
        if color is None:
            draw_detections(img, chosen)
        else:
            for d in chosen:
                draw_rectangle(img, d["x1"], d["y1"], d["x2"], d["y2"], color, 8)
        write_png(str(pred_dir / out_name), img)

    render(lambda d: True, "all_predictions.png", None)
    render(lambda d: d["class"] == "boat", "boat_predictions.png", (28, 26, 228))
    render(lambda d: d["class"] == "human", "human_predictions.png", (184, 126, 55))
    render(lambda d: d["class"] not in ("boat", "human"), "other_predictions.png", (0, 127, 255))
    print(f"{len(detections)} detections written.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
