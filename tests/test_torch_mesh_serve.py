"""``cli.serve`` and ``cli.test_rpn`` on two spawned CPU ranks against the
same CLIs on one device, on tests/test_torch_mesh_cli.py's directories.

* ``cli.serve --n-devices 2`` answers three requests in order on stdout
  with the single device's detections (confidences within PANEL_PROB_TOL),
  and READY is printed once, by rank 0, after both ranks have loaded;
* ``cli.test_rpn --n-devices 2`` (data parallelism: the RPN has no head to
  shard) finds the same proposals: the same lines and PNGs.
"""

import io
import json

import torch

from radnet_torch.cli import serve as tserve
from radnet_torch.cli import test_rpn as ttest_rpn
from radnet_torch.data.png import write_png
from tests.test_torch_mesh_cli import copy_model, panel, root, same_dets  # noqa: F401 (fixture)

torch.set_num_threads(1)


def test_serve_cli_at_two_devices_answers_in_order_with_one_ready(root, capfd):
    paths = []
    for k in range(3):
        p = root / f"serve{k}.png"
        write_png(str(p), panel(20 + k, 96 + 8 * k, 100))
        paths.append(str(p))
    outs = {}
    for name, flags in (("single", []), ("mesh", ["--n-devices", "2"])):
        out = io.StringIO()
        capfd.readouterr()
        rc = tserve.main(["--device", "cpu", "--models-path", str(root / "models"), "--model-name",
                          "m", *flags], stdin=io.StringIO("\n".join(paths) + "\n"), stdout=out)
        assert rc == 0
        assert capfd.readouterr().err.count("READY") == 1
        outs[name] = [json.loads(line) for line in out.getvalue().splitlines()]
        assert [r["path"] for r in outs[name]] == paths
    assert sum(len(r["detections"]) for r in outs["single"]) > 0
    for got, want in zip(outs["mesh"], outs["single"]):
        same_dets(got["detections"], want["detections"])


def test_test_rpn_cli_on_two_devices_finds_the_same_proposals(root, capsys):
    lines = {}
    for name, flags in (("single", []), ("mesh", ["--n-devices", "2"])):
        argv = copy_model(root, f"rpn_{name}") + [
            "--annot", str(root / "test.csv"), "--data", str(root / "test")]
        capsys.readouterr()
        assert ttest_rpn.main(argv + flags) == 0
        lines[name] = [ln for ln in capsys.readouterr().out.splitlines()
                       if "proposals" in ln or "recall" in ln]
        pngs = sorted(p.name for p in (root / "models" / f"rpn_{name}" / "test_rpn").iterdir())
        assert pngs == ["p0.png", "p1.png"]
    assert any("recall" in ln for ln in lines["single"])
    assert lines["mesh"] == lines["single"]
