"""Training loop: epochs, validation, best checkpoints, record.csv and logs.

The observable contract of the JAX package's ``engine/loop.py``:

* ``record.csv`` with ``RECORD_COLUMNS``, one row per epoch: means rounded
  to 3 decimals, empty cells for absent values (``val_*`` without
  validation, ``model_improvement`` without one), written with the ``csv``
  module;
* ``metrics.jsonl``, one line per step, and TensorBoard events under the
  same tags, per step and per epoch (``utils/tbevents.py``);
* ``ckpt_best`` on a lower watched loss (validation total, or the training
  total without validation) and ``ckpt_last`` every epoch, saved on a
  thread from a snapshot taken on the device first; each ``ckpt_best``
  save also writes ``model.pt``.

Step metrics stay on the device during an epoch and are fetched once at
its end.

On a mesh (``state.mesh``) every rank runs the loop in step: each draws the
whole batch's :class:`~radnet_torch.engine.steps.StepDraws` from one seed
and keeps its rows, and the metrics are the whole batch's on every rank.
Rank 0's watched loss decides ``ckpt_best`` for all (a broadcast), every
rank takes part in a checkpoint's gather, and only rank 0 writes:
record.csv, the logs, the checkpoints, ``viz/`` and the dashboard.  The
Poisson noise of the photometric augmentation comes from a generator of its
own, one a data index, seeded ``seed + 1 + data index``: its sampler reads a
data-dependent count of random numbers, which would set the ranks' step
generators apart.  So a mesh run draws the single device's draws, step
after step, except the Poisson noise of data indices above 0.  When the run ends, the loss plots are written into ``viz/``
(``engine/plots.py``) and ``dashboard.html`` is rendered from the two logs
(``utils/dashboard.py``).
"""

from __future__ import annotations

import csv
import json
import os
import threading
import time
from typing import Any, Callable, Iterator

import torch

from radnet_torch.config import Config
from radnet_torch.engine import checkpoint as ckpt
from radnet_torch.engine.plots import save_training_plots
from radnet_torch.engine.steps import METRIC_KEYS, draw_step, rank_draws
from radnet_torch.engine.train_state import TrainState
from radnet_torch.inference import WEIGHTS_FILE
from radnet_torch.utils.dashboard import generate_dashboard
from radnet_torch.utils.tbevents import EventWriter

# metrics.jsonl key -> per-step TensorBoard tag.
_STEP_TAGS = {
    "loss_rpn_cls": "rpn_cls_loss",
    "loss_rpn_regr": "rpn_reg_loss",
    "loss_detector_cls": "detector_cls_loss",
    "loss_detector_regr": "detector_reg_loss",
    "detector_acc": "detector_acc",
}

RECORD_COLUMNS = [
    "elapsed_time", "mean_overlapping_bboxes", "val_mean_overlapping_bboxes",
    "loss_rpn_cls", "val_loss_rpn_cls", "loss_rpn_regr", "val_loss_rpn_regr",
    "loss_detector_cls", "val_loss_detector_cls", "loss_detector_regr",
    "val_loss_detector_regr", "total_loss", "val_total_loss", "detector_acc",
    "val_detector_acc", "model_improvement",
]

LOSS_KEYS = ("loss_rpn_cls", "loss_rpn_regr", "loss_detector_cls", "loss_detector_regr")


def create_model_folder(model_path: str) -> None:
    """``<model>/{viz,test}``; never deletes an existing folder."""
    os.makedirs(os.path.join(model_path, "viz"), exist_ok=True)
    os.makedirs(os.path.join(model_path, "test"), exist_ok=True)


def read_record(path: str) -> list[dict[str, Any]]:
    """record.csv rows as dicts of floats (None for empty cells)."""
    with open(path, newline="") as f:
        return [{k: (float(v) if v not in ("", None) else None) for k, v in row.items()}
                for row in csv.DictReader(f)]


def write_record(path: str, rows: list[dict[str, Any]]) -> None:
    with open(path + ".new", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=RECORD_COLUMNS, extrasaction="ignore")
        w.writeheader()
        for row in rows:
            w.writerow({k: ("" if row.get(k) is None else row[k]) for k in RECORD_COLUMNS})
    os.replace(path + ".new", path)


def _fetch(metrics: list[dict[str, torch.Tensor]]) -> list[dict[str, float]]:
    """One device -> host copy of an epoch's step metrics: a row a step, a
    bundle's entry (each metric stacked ``(K,)``) flattened into its K
    steps' rows."""
    if not metrics:
        return []
    table = torch.cat([torch.stack([m[k].float() for k in METRIC_KEYS], dim=-1)
                       .reshape(-1, len(METRIC_KEYS)) for m in metrics])
    return [dict(zip(METRIC_KEYS, row)) for row in table.cpu().tolist()]


def _mean(rows: list[dict[str, float]], key: str) -> float:
    return sum(r[key] for r in rows) / len(rows) if rows else float("nan")


class AsyncSaver:
    """Checkpoint writes on a worker thread, so the device -> host copy and
    the file writes overlap the next epoch.  Submissions for one path
    coalesce (only the newest matters); ``close()`` flushes, and a worker
    failure is raised there or on the next ``submit``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pending: dict[str, tuple[dict, str | None]] = {}
        self._wake = threading.Event()
        self._stop = False
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, path: str, tree: dict, model_pt: str | None = None) -> None:
        if self._error is not None:
            raise self._error
        with self._lock:
            self._pending[path] = (tree, model_pt)
        self._wake.set()

    def _run(self) -> None:
        while True:
            self._wake.wait()
            with self._lock:
                if not self._pending:
                    if self._stop:
                        return
                    self._wake.clear()
                    continue
                path, (tree, model_pt) = next(iter(self._pending.items()))
                del self._pending[path]
            try:
                ckpt.save_checkpoint_tree(path, tree, model_pt)
            except BaseException as e:
                self._error = e
                return

    def close(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join()
        if self._error is not None:
            raise self._error


def _agreed(value: float, mesh) -> float:
    """Rank 0's ``value`` on every rank of ``mesh`` (None: as it is)."""
    if mesh is None or mesh.size == 1:
        return value
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.float64)
    dist.broadcast(t, src=0, group=mesh.host_group)
    return float(t)


def fit(
    config: Config,
    state: TrainState,
    train_step: Callable,
    train_batches: Iterator[dict],
    model_path: str,
    *,
    epoch_length: int = 173,
    n_epochs: int = 100,
    eval_step: Callable | None = None,
    val_batches_factory: Callable[[], Iterator[dict]] | None = None,
    seed: int = 64,
    best_total_loss: float = float("inf"),
    record: list[dict[str, Any]] | None = None,
    train_bundle: Callable | None = None,
) -> tuple[TrainState, list[dict[str, Any]]]:
    """Run ``n_epochs`` of ``epoch_length`` steps; returns the state and the
    record rows.  Each step's :class:`~radnet_torch.engine.steps.StepDraws`
    come from a ``torch.Generator`` on the model's device seeded by
    ``seed``.  ``train_bundle`` (``engine.steps.make_train_bundle``) runs
    K steps a call: while K steps of an epoch remain, K batches and their K
    steps' draws, drawn in the single steps' order, go through it; the rest
    of the epoch runs ``train_step``.  The trajectory and the logs are the
    unbundled loop's."""
    mesh = getattr(state, "mesh", None)  # any state without one runs on one device
    main = mesh is None or mesh.is_main
    dp = 1 if mesh is None else mesh.data
    record_path = os.path.join(model_path, "record.csv")
    if main:
        create_model_folder(model_path)
        metrics_log = open(os.path.join(model_path, "metrics.jsonl"), "a")
        events = EventWriter(model_path)
    record = list(record or [])
    device = next(state.model.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    noise_gen = torch.Generator(device=device)
    noise_gen.manual_seed(seed + 1 + (0 if mesh is None else mesh.data_index))

    def draws_for(batch, photometric=True):
        draws = draw_step(gen, config, batch["image"].shape[0] * dp, device,
                          photometric=photometric)
        if draws.photometric is not None:
            draws.photometric.poisson_generator = noise_gen
        return rank_draws(draws, mesh)

    bundle_k = getattr(train_bundle, "_bundle_steps", 1) if train_bundle is not None else 1
    start_time = time.time()
    saver = AsyncSaver() if main else None

    def close_logs():
        if main:
            metrics_log.close()
            events.close()

    try:
        for epoch in range(n_epochs):
            print(f"Epoch {epoch + 1}/{n_epochs}")
            step_metrics, done = [], 0
            while done < epoch_length:
                if bundle_k > 1 and epoch_length - done >= bundle_k:
                    batches = [next(train_batches) for _ in range(bundle_k)]
                    step_metrics.append(train_bundle(batches, [draws_for(b) for b in batches]))
                    done += bundle_k
                else:
                    batch = next(train_batches)
                    step_metrics.append(train_step(batch, draws_for(batch)))
                    done += 1
            rows = _fetch(step_metrics)  # the epoch's one read back
            first_step = state.step - epoch_length
            if main:
                for i, m in enumerate(rows):
                    metrics_log.write(json.dumps({"step": first_step + i, **m}) + "\n")
                    events.add_scalars(first_step + i,
                                       {tag: m[k] for k, tag in _STEP_TAGS.items()})
                metrics_log.flush()

            # The watermark compares unrounded means; record.csv shows 3 decimals.
            curr_total = sum(_mean(rows, k) for k in LOSS_KEYS)
            row: dict[str, Any] = {
                "elapsed_time": round((time.time() - start_time) / 60, 3),
                "mean_overlapping_bboxes": round(_mean(rows, "mean_overlapping_bboxes"), 3),
                **{k: round(_mean(rows, k), 3) for k in LOSS_KEYS},
                "detector_acc": round(_mean(rows, "detector_acc"), 3),
                "total_loss": round(curr_total, 3),
            }
            print("(TRAINING) overlap={mean_overlapping_bboxes} rpn_cls={loss_rpn_cls} "
                  "rpn_regr={loss_rpn_regr} det_cls={loss_detector_cls} "
                  "det_regr={loss_detector_regr} acc={detector_acc} total={total_loss}".format(**row))

            if eval_step is not None and val_batches_factory is not None:
                val = _fetch([eval_step(b, draws_for(b, photometric=False))
                              for b in val_batches_factory()])
                val_total = sum(_mean(val, k) for k in LOSS_KEYS)
                row["val_mean_overlapping_bboxes"] = round(_mean(val, "mean_overlapping_bboxes"), 3)
                for k in LOSS_KEYS:
                    row[f"val_{k}"] = round(_mean(val, k), 3)
                row["val_detector_acc"] = round(_mean(val, "detector_acc"), 3)
                row["val_total_loss"] = round(val_total, 3)
                watch = val_total
                print(f"(VALIDATION) total={val_total:.3f} best={best_total_loss:.3f}")
            else:
                watch = curr_total

            watch = _agreed(watch, mesh)
            improved = watch < best_total_loss
            row["model_improvement"] = watch - best_total_loss if improved else None
            if improved:
                print(f"Total loss decreased from {best_total_loss} to {watch}, saving weights")
                best_total_loss = watch
            tree = ckpt.snapshot(state, best_total_loss)
            if main:
                if improved:
                    saver.submit(os.path.join(model_path, "ckpt_best"), tree,
                                 os.path.join(model_path, WEIGHTS_FILE))
                saver.submit(os.path.join(model_path, "ckpt_last"), tree)

                events.add_scalars(len(record), {
                    "Elapsed_time": (time.time() - start_time) / 60,
                    "mean_overlapping_bboxes": _mean(rows, "mean_overlapping_bboxes"),
                    "mean_rpn_cls_loss": _mean(rows, "loss_rpn_cls"),
                    "mean_rpn_reg_loss": _mean(rows, "loss_rpn_regr"),
                    "mean_detector_cls_loss": _mean(rows, "loss_detector_cls"),
                    "mean_detector_reg_loss": _mean(rows, "loss_detector_regr"),
                    "mean_detector_acc": _mean(rows, "detector_acc"),
                    "total_loss": curr_total,
                })
            record.append(row)
            if main:
                write_record(record_path, record)
    except BaseException:
        if main:
            try:
                saver.close()
            except BaseException as save_err:
                print(f"checkpoint flush during shutdown failed: {save_err!r}")
        close_logs()
        raise
    if not main:
        return state, record
    try:
        saver.close()
    finally:
        # Every epoch completed: close the logs, draw the plots and render
        # the dashboard even if the last checkpoint flush failed.
        close_logs()
        save_training_plots(record, os.path.join(model_path, "viz"))
        try:
            generate_dashboard(model_path)
        except Exception as e:  # a dashboard never fails a training run
            print(f"dashboard generation failed: {e}")
    return state, record
