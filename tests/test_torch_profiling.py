"""The port's profiling helpers against the JAX package's: Timer's summary
and report text and stage_timer's line under the same clock; profile_trace
writes a trace on the CPU."""

import itertools
import json
import time

import torch

from radnet_torch.utils import Timer, profile_trace, stage_timer
from radnet_tpu.utils import profiling as jprof

torch.set_num_threads(1)


def _drive(timer_cls, stage, monkeypatch, capsys):
    clock = itertools.count(start=1.0, step=0.125)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock) ** 1.5)
    t = timer_cls()
    for name in ("decode", "predict", "decode", "a_very_long_stage_name_of_thirty_four"):
        with t(name):
            pass
    with stage("panel"):
        pass
    with stage("quiet", verbose=False):
        pass
    return t.summary(), t.report(), capsys.readouterr().out


def test_timer_and_stage_timer_equal_jax(monkeypatch, capsys):
    got = _drive(Timer, stage_timer, monkeypatch, capsys)
    want = _drive(jprof.Timer, jprof.stage_timer, monkeypatch, capsys)
    assert got == want
    assert got[0]["decode"]["count"] == 2 and got[2].startswith("panel: ")


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)
    assert any(e.key == "aten::matmul" for e in prof.key_averages())
