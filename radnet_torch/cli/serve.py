"""Long-lived serving worker: panel paths in, detections out.

Protocol (newline-delimited, stdin -> stdout):

  input   one panel image path per line (optionally ``path<TAB>out.json``
          to also write the detections to a file)
  output  one JSON object per line, in input order:
          {"path": ..., "detections": [{"label", "confidence",
           "x1", "y1", "x2", "y2"}, ...], "sec": wall_seconds}
          or {"path": ..., "error": "..."} for unreadable inputs.
          ``sec`` is wall time from reading the input line to emitting the
          result, including time queued behind other panels in flight.

A blank line or EOF ends the session; ``READY`` is printed to stderr once
the model is loaded.  A reader thread decodes panel k+1 (PNG or JPEG, see
``radnet_torch/data/image.py``) while panel k runs; ``--pipeline-depth N``
keeps up to N panels dispatched before the oldest is collected.

With ``--n-devices N [--model-parallel M]`` the worker spawns N ranks, one a
device (radnet_torch/parallel): rank 0 reads stdin and broadcasts each line
(and the end) to the others, every rank runs every panel over the mesh, and
rank 0 alone prints results and writes files; ``READY`` comes once every
rank has loaded.

Example:
  printf '%s\\n' panel1.png panel2.png | \\
      python -m radnet_torch.cli.serve --models-path models --model-name faster_rcnn_resnet50_x
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
import time
from collections import deque

import numpy as np

from radnet_torch.cli.common import (add_mesh_args, add_quantize_arg, mesh_from_args,
                                     quantize_from_args, run_on_mesh)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--models-path", default="models")
    p.add_argument("--model-name", default="faster_rcnn_resnet50_raod_base")
    p.add_argument(
        "--warmup-size", type=int, default=0,
        help="run one synthetic panel of this side length (grey, then colour) "
        "before READY, so the first real panel pays no first-call cost",
    )
    p.add_argument(
        "--pipeline-depth", type=int, default=1,
        help="panels kept in flight at once (>=1); results stay in input order",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda; without a card pass --device cpu)",
    )
    add_quantize_arg(p)
    add_mesh_args(p)
    return p


def detections_to_json(detections) -> list[dict]:
    return [
        {
            "label": d["class"],
            "confidence": float(d["prob"]),
            "x1": int(d["x1"]),
            "y1": int(d["y1"]),
            "x2": int(d["x2"]),
            "y2": int(d["y2"]),
        }
        for d in detections
    ]


def main(argv=None, stdin=None, stdout=None) -> int:
    args = build_argparser().parse_args(argv)
    return run_on_mesh(args, serve, args,
                       stdin=sys.stdin if stdin is None else stdin,
                       stdout=sys.stdout if stdout is None else stdout)


def _next_request(stdin) -> str | None:
    """The next request line, or None at a blank line or EOF."""
    line = stdin.readline().rstrip("\n")
    return line or None


def serve(args, stdin=None, stdout=None) -> int:
    """The worker on this process (one rank of a mesh under ``--n-devices``;
    only rank 0 has ``stdin`` and ``stdout``)."""
    from radnet_torch.data.image import read_image
    from radnet_torch.inference import load_radnet
    from radnet_torch.parallel.collectives import broadcast_text, host_barrier

    mesh = mesh_from_args(args)
    main_rank = mesh is None or mesh.is_main
    radnet = load_radnet(os.path.join(args.models_path, args.model_name), device=args.device,
                         quantize=quantize_from_args(args), mesh=mesh)

    if args.warmup_size:
        s = args.warmup_size
        rng = np.random.default_rng(0)
        color = rng.integers(1, 255, (s, s, 3), dtype=np.uint8)
        grey = np.repeat(color[..., :1], 3, axis=-1)
        radnet.warmup(grey)
        radnet.warmup(color)

    if mesh is not None:
        host_barrier(mesh)
    if main_rank:
        print("READY", file=sys.stderr, flush=True)

    depth = max(1, args.pipeline_depth)
    inbox: queue.Queue = queue.Queue(maxsize=depth)
    eof = object()

    def reader() -> None:
        while True:
            line = _next_request(stdin) if main_rank else None
            if mesh is not None:  # rank 0's line, or its end, on every rank
                line = broadcast_text(line, mesh)
            if line is None:
                break
            path, _, out_file = line.partition("\t")
            t0 = time.time()
            try:
                img = read_image(path)
                inbox.put((path, out_file, t0, img, None))
            except Exception as e:  # keep serving on bad inputs
                inbox.put((path, out_file, t0, None, f"{type(e).__name__}: {e}"))
        inbox.put(eof)

    threading.Thread(target=reader, daemon=True).start()

    def emit(result: dict, out_file: str) -> None:
        if not main_rank:
            return
        if out_file:
            try:
                with open(out_file, "w") as f:
                    json.dump(result, f, indent=2)
            except OSError as e:
                result = dict(result)
                result["out_file_error"] = f"{type(e).__name__}: {e}"
        print(json.dumps(result), file=stdout, flush=True)

    outstanding: deque = deque()  # (path, out_file, t0, pending), FIFO

    def collect_oldest() -> None:
        path, out_file, t0, pending = outstanding.popleft()
        try:
            dets = radnet.predict_collect(pending)
            result = {
                "path": path,
                "detections": detections_to_json(dets),
                "sec": round(time.time() - t0, 3),
            }
        except Exception as e:
            result = {"path": path, "error": f"{type(e).__name__}: {e}"}
        emit(result, out_file)

    def drain() -> None:
        while outstanding:
            collect_oldest()

    while True:
        item = inbox.get()
        if item is eof:
            drain()
            break
        path, out_file, t0, img, err = item
        if err is not None:
            drain()  # preserve output order
            emit({"path": path, "error": err}, out_file)
            continue
        try:
            pending = radnet.predict_dispatch([img])
        except Exception as e:
            drain()
            emit({"path": path, "error": f"{type(e).__name__}: {e}"}, out_file)
            continue
        outstanding.append((path, out_file, t0, pending))
        while len(outstanding) > depth:
            collect_oldest()
    return 0


if __name__ == "__main__":
    sys.exit(main())
