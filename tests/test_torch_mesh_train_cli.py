"""Training through the port's CLIs on a 2 x 2 gloo mesh of spawned CPU
ranks (``--n-devices 4 --model-parallel 2``: two data indices, the
ResNet50 stage-5 head split in two), against the same CLIs on one device,
on the tiny on-disk set of tests/test_torch_train_cli.py, as
tests/test_cli_end_to_end.py drives the JAX package's:

* ``cli.train`` on the mesh tracks the single device's record.csv (one
  pipeline at ``--num-workers 1``: the same samples in the same order, and
  the same draws but the Poisson noise of the second data index);
* rank 0 writes whole checkpoints in the single device's form, and the
  mesh's ``model.pt`` serves on one device;
* a single device's checkpoint restores on the mesh with its step, Adam's
  moments and weights as saved, and ``cli.cont_train`` resumes it there;
* ``cli.test`` gives the same mAP on the mesh-trained model with and
  without a mesh.

Also the loss normalisation itself: each data index's share of a loss,
``num / den`` over the whole batch's ``den``, sums to the whole batch's
loss, gradients included, where a mean of per-index ratios does not.
"""

import json

import numpy as np
import pytest
import torch

from radnet_torch import losses
from radnet_torch.cli import cont_train as tcont
from radnet_torch.cli import test as ttest
from radnet_torch.cli import train as ttrain
from radnet_torch.engine.loop import read_record
from radnet_torch.inference import load_radnet
from radnet_torch.parallel.launch import launch
from tests.test_torch_train_cli import _args, _panel, dataset  # noqa: F401 (a fixture)
from tests.torch_mesh_ranks import restore_and_gather
from tests.torch_port_util import torch_config

torch.set_num_threads(1)

MESH_2X2 = ["--n-devices", "4", "--model-parallel", "2"]
# record.csv's means of the mesh against the single device's, absolute: the
# same samples and draws, but the second data index's Poisson noise, and
# float32 sums in another order.  A row holds 3 decimals; these runs read
# equal in every cell compared (the JAX package's test allows 0.05).
RECORD_TOL = 0.002


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):  # noqa: F811
    """Two epochs of two steps, with validation, on one device and on the
    mesh; the config resumes with the partition it trained (so Adam's state
    resumes too)."""
    root, cfg, _ = dataset
    tcfg = torch_config(cfg)
    tcfg.base_net_cont_trainable = tcfg.base_net_trainable
    tmp = tmp_path_factory.mktemp("mesh_train")
    cfg_path = tmp / "config.json"
    tcfg.save(str(cfg_path))
    args = _args(root, cfg_path)
    args[args.index("--models-path") + 1] = str(tmp / "models")
    args[args.index("--num-workers") + 1] = "1"
    common = args + ["--config-json", str(cfg_path), "--allow-random-init", "--n-epochs", "2",
                     "--lr", "1e-4"]
    assert ttrain.main(common + ["--model-name", "single"]) == 0
    assert ttrain.main(common + ["--model-name", "mesh"] + MESH_2X2) == 0
    models = tmp / "models"
    return root, tcfg, args, models / "faster_rcnn_resnet50_single", models / "faster_rcnn_resnet50_mesh"


def test_mesh_train_cli_tracks_the_single_device_record(runs):
    _, _, _, single, mesh = runs
    rec1, rec4 = read_record(str(single / "record.csv")), read_record(str(mesh / "record.csv"))
    assert len(rec1) == len(rec4) == 2
    for r1, r4 in zip(rec1, rec4):
        for k in ("total_loss", "val_total_loss", "loss_rpn_cls", "loss_detector_cls",
                  "mean_overlapping_bboxes", "val_mean_overlapping_bboxes"):
            assert r4[k] == pytest.approx(r1[k], rel=0, abs=RECORD_TOL), k
    steps = [json.loads(line)["step"] for line in open(mesh / "metrics.jsonl")]
    assert steps == [0, 1, 2, 3]
    for name in ("config.json", "model.pt", "ckpt_best/train_state.pt",
                 "ckpt_last/train_state.pt", "viz/total_loss.svg", "dashboard.html"):
        assert (mesh / name).exists(), name


def test_mesh_checkpoint_is_whole_and_serves_on_one_device(runs):
    _, _, _, single, mesh = runs
    want = torch.load(single / "ckpt_last" / "train_state.pt", weights_only=True)
    got = torch.load(mesh / "ckpt_last" / "train_state.pt", weights_only=True)
    assert got["step"] == want["step"] == 4 and int(got["optimizer"]["count"]) == 4
    assert got["model"].keys() == want["model"].keys()
    for k, v in want["model"].items():
        assert got["model"][k].shape == v.shape, k
    for key in ("exp_avg", "exp_avg_sq"):
        assert [t.shape for t in got["optimizer"][key]] == [t.shape for t in want["optimizer"][key]]
    weights = torch.load(mesh / "model.pt", weights_only=True)
    assert weights["head.s5a.conv2a.weight"].shape == (512, 1024, 1, 1)
    net = load_radnet(str(mesh), device="cpu")
    img = np.repeat(_panel(np.random.default_rng(9), 120, 130, 3)[0][..., None], 3, -1)
    assert isinstance(net.predict([img]), list)


def test_single_device_checkpoint_restores_and_resumes_on_the_mesh(runs):
    root, tcfg, args, single, _ = runs
    path = single / "ckpt_last"
    saved = torch.load(path / "train_state.pt", weights_only=True)
    got = launch(restore_and_gather, 4, device_type="cpu",
                 args=(2, tcfg.to_dict(), str(path)))
    assert got["step"] == saved["step"] == 4
    assert got["shard_shapes"]["head.s5a.conv2a.weight"] == (512, 512, 1, 1)
    for k, v in saved["model"].items():
        assert np.array_equal(got["model"][k], v.numpy()), k
    assert int(got["optimizer"]["count"]) == int(saved["optimizer"]["count"]) == 4
    for key in ("exp_avg", "exp_avg_sq"):
        for a, b in zip(got["optimizer"][key], saved["optimizer"][key]):
            assert np.array_equal(a, b.numpy())

    resume = args + ["--model-name", single.name, "--n-epochs", "1", "--no-validation"]
    assert tcont.main(resume + MESH_2X2) == 0
    assert len(read_record(str(single / "record.csv"))) == 3
    steps = [json.loads(line)["step"] for line in open(single / "metrics.jsonl")]
    assert steps[-2:] == [4, 5]  # the step count resumed
    state = torch.load(path / "train_state.pt", weights_only=True)
    assert state["step"] == 6 and int(state["optimizer"]["count"]) == 6


def test_test_cli_gives_the_same_map_with_and_without_a_mesh(runs):
    root, _, _, _, mesh = runs
    accuracy = {}
    for name, flags in (("single", []), ("mesh", MESH_2X2)):
        argv = ["--device", "cpu", "--models-path", str(mesh.parent), "--model-name", mesh.name,
                "--test-annot", str(root / "data" / "val.csv"),
                "--test-data", str(root / "data" / "val")]
        assert ttest.main(argv + flags) == 0
        accuracy[name] = json.loads((mesh / "test_accuracy.json").read_text())
    assert accuracy["mesh"].keys() == accuracy["single"].keys()
    for k, v in accuracy["single"].items():
        assert accuracy["mesh"][k] == pytest.approx(v, abs=1e-9), k


def test_loss_shares_sum_to_the_whole_batch_loss():
    """Two data indices with different numbers of valid anchors and RoIs:
    the shares over the whole batch's denominators sum to the whole batch's
    losses and accuracy, and so do their gradients; the mean of the
    per-index ratios is another number."""
    rng = np.random.default_rng(0)
    a, k, r = 3, 2, 5  # anchors a cell, foreground classes, RoIs a tile

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    valid = (rng.random((2, 4, 4, a)) < np.array([0.8, 0.2])[:, None, None, None]).astype(np.float32)
    y_cls = t(np.concatenate([valid, rng.random((2, 4, 4, a)) < 0.5], -1))
    regr_mask = np.repeat(valid * (rng.random(valid.shape) < 0.5), 4, -1)
    y_regr = t(np.concatenate([regr_mask, rng.normal(0, 1, regr_mask.shape)], -1))
    roi_mask = t([[1, 1, 1, 1, 0], [1, 0, 0, 0, 0]])
    labels = rng.integers(0, k + 1, (2, r))
    y_class = t(np.eye(k + 1)[labels])
    det_mask = np.repeat(np.eye(k + 1)[labels][..., :k], 4, -1)
    y_det = t(np.concatenate([det_mask, rng.normal(0, 1, det_mask.shape)], -1))
    p_rpn = t(rng.random((2, 4, 4, a))).requires_grad_()
    d_rpn = t(rng.normal(0, 1, (2, 4, 4, 4 * a))).requires_grad_()
    p_cls = torch.softmax(t(rng.normal(0, 1, (2, r, k + 1))), -1).detach().requires_grad_()
    d_det = t(rng.normal(0, 1, (2, r, 4 * k))).requires_grad_()

    d_cls, d_regr = losses.rpn_denominators(y_cls, y_regr, a)
    n_rois, d_det_regr = losses.detector_denominators(y_det, k, roi_mask)
    halves = [slice(0, 1), slice(1, 2)]
    # (loss, its prediction, its arguments but the prediction, the whole
    # batch's denominators)
    cases = [
        (losses.rpn_loss_cls, p_rpn, (y_cls, a), {"den": d_cls}),
        (losses.rpn_loss_regr, d_rpn, (y_regr, a), {"den": d_regr}),
        (losses.class_loss_cls, p_cls, (y_class, roi_mask), {"n_rois": n_rois}),
        (losses.class_loss_regr, d_det, (y_det, k, roi_mask), {"den": d_det_regr}),
        (losses.detector_accuracy, p_cls, (y_class, roi_mask), {"n_rois": n_rois}),
    ]
    for fn, pred, (target, *rest), dens in cases:
        def call(h=slice(None), **kw):
            return fn(target[h], pred[h], *[x[h] if torch.is_tensor(x) else x for x in rest], **kw)

        whole = call()
        shares = sum(call(h, **dens) for h in halves)
        torch.testing.assert_close(shares, whole, rtol=1e-6, atol=0, msg=fn.__name__)
        ratios = sum(call(h) for h in halves) / 2
        assert abs(float((ratios - whole).detach())) > 1e-3 * abs(float(whole.detach())), fn.__name__
        if whole.requires_grad:
            (g_whole,) = torch.autograd.grad(whole, pred)
            (g_shares,) = torch.autograd.grad(sum(call(h, **dens) for h in halves), pred)
            torch.testing.assert_close(g_shares, g_whole, rtol=1e-6, atol=1e-9, msg=fn.__name__)
