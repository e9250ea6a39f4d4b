"""Timing and tracing helpers.

* :class:`Timer` / :func:`stage_timer` - structured wall-clock timing with
  a summary table (per-stage totals and counts), for host-side pipeline
  stages;
* :func:`profile_trace` - a context manager around ``torch.profiler`` (CPU
  and, where the build has it, CUDA activity) that writes a trace of any
  code region under ``log_dir``, readable by TensorBoard's profiler plugin
  and by Perfetto (kernel times, launches, the host's gaps between them).
"""

from __future__ import annotations

import collections
import contextlib
import time


class Timer:
    """Accumulating named wall-clock timer.

    >>> t = Timer()
    >>> with t("decode"): ...
    >>> t.summary()  # {'decode': {'total_s': ..., 'count': ...}}
    """

    def __init__(self) -> None:
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k]}
            for k in sorted(self.totals)
        }

    def report(self) -> str:
        lines = ["stage                          total_s    count   mean_ms"]
        for k, v in self.summary().items():
            mean_ms = 1000.0 * v["total_s"] / max(v["count"], 1)
            lines.append(f"{k:<30} {v['total_s']:>8.3f} {v['count']:>8d} {mean_ms:>9.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def stage_timer(name: str, verbose: bool = True):
    """One-shot timer printing '<name>: Xs' like the reference's prints."""
    t0 = time.perf_counter()
    yield
    if verbose:
        print(f"{name}: {time.perf_counter() - t0:.3f}s")


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the region into ``log_dir/<host>_<pid>.<stamp>.pt.trace.json``;
    yields the ``torch.profiler.profile`` (``key_averages()`` for sums by
    kernel)."""
    from torch import profiler

    with profiler.profile(activities=sorted(profiler.supported_activities(), key=str),
                          on_trace_ready=profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
