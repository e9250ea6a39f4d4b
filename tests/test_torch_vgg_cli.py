"""VGG16 through the port's CLIs on the CPU: ``radnet_torch.cli.train
--network vgg16 --train-schedule alternating`` (2 epochs of 2 steps, with
validation), ``cli.cont_train`` on its directory, ``cli.test`` and
``cli.serve`` on the model they wrote; and ``scripts/export_jax_model.py``
on a JAX VGG16 directory, whose detections the port then gives as the JAX
package does (tests/test_torch_vgg_predict.py's criterion)."""

import io
import json
import os
import sys

import cv2
import jax
import numpy as np
import torch

from radnet_torch.cli import cont_train as tcont
from radnet_torch.cli import serve as tserve
from radnet_torch.cli import test as ttest
from radnet_torch.cli import train as ttrain
from radnet_torch.inference import load_radnet
from radnet_tpu.engine.checkpoint import save_checkpoint
from radnet_tpu.engine.train_state import create_train_state
from radnet_tpu.inference import RADNet as JaxRADNet
from tests.test_torch_cascade import _assert_same_dets, _grey_panel
from tests.test_torch_train_cli import IMG_TYPE, _args, dataset  # noqa: F401  (a fixture)
from tests.torch_port_util import jax_vgg, port_cv2_resize, port_model

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
import export_jax_model  # noqa: E402

torch.set_num_threads(1)


def test_vgg16_alternating_train_cont_train_test_and_serve(dataset, tmp_path):  # noqa: F811
    root, _, cfg_path = dataset
    args = _args(root, cfg_path)
    args[args.index("--models-path") + 1] = str(tmp_path / "models")
    assert ttrain.main(args + ["--config-json", str(cfg_path), "--network", "vgg16",
                               "--train-schedule", "alternating", "--model-name", "alt",
                               "--n-epochs", "2", "--lr", "1e-4"]) == 0
    model_dir = tmp_path / "models" / "faster_rcnn_vgg16_alt"
    cfg = json.loads((model_dir / "config.json").read_text())
    assert (cfg["network"], cfg["train_schedule"]) == ("vgg16", "alternating")
    state = torch.load(model_dir / "ckpt_last" / "train_state.pt", weights_only=True)
    assert set(state["optimizer"]) == {"rpn", "det"} and state["step"] == 4
    assert int(state["optimizer"]["rpn"]["count"]) == 4
    assert 0 <= int(state["optimizer"]["det"]["count"]) <= 4  # batches without a valid RoI skip
    assert any(k.startswith("head.fc1") for k in state["model"])
    rows = (model_dir / "record.csv").read_text().splitlines()
    assert len(rows) == 3 and (model_dir / "model.pt").exists()

    # base_net_cont_trainable changes the partition: the weights resume.
    assert tcont.main(args + ["--model-name", model_dir.name, "--n-epochs", "1"]) == 0
    assert len((model_dir / "record.csv").read_text().splitlines()) == 4
    state = torch.load(model_dir / "ckpt_last" / "train_state.pt", weights_only=True)
    n_trunk = sum(1 for _ in state["optimizer"]["det"]["exp_avg"]) - 8  # the head's 8 tensors
    assert n_trunk == 18  # blocks 3-5 train on resume

    d = root / "data"
    assert ttest.main(["--device", "cpu", "--models-path", str(tmp_path / "models"),
                       "--model-name", model_dir.name, "--test-annot", str(d / "val.csv"),
                       "--test-data", str(d / "val")]) == 0
    acc = json.loads((model_dir / "test_accuracy.json").read_text())
    assert "mAP" in acc and 0.0 <= acc["mAP"] <= 1.0

    panel = next((d / "val" / IMG_TYPE).iterdir())
    out = io.StringIO()
    assert tserve.main(["--device", "cpu", "--models-path", str(tmp_path / "models"),
                        "--model-name", model_dir.name, "--warmup-size", "0"],
                       stdin=io.StringIO(f"{panel}\n"), stdout=out) == 0
    (rec,) = [json.loads(line) for line in out.getvalue().splitlines()]
    assert rec["path"] == str(panel) and isinstance(rec["detections"], list)


def test_export_jax_vgg16_directory(tmp_path, monkeypatch):
    """A VGG16 directory the JAX package wrote converts; the port's
    load_radnet then gives the JAX package's detections."""
    monkeypatch.setattr(cv2, "resize", port_cv2_resize)
    cfg, model, params, bstats = jax_vgg(0)
    path = tmp_path / "jax_vgg"
    state = create_train_state(model, cfg, jax.random.PRNGKey(0))
    save_checkpoint(str(path / "ckpt_best"), state.replace(params=params, batch_stats=bstats))
    cfg.save(str(path / "config.json"))
    export_jax_model.main([str(path)])

    want = port_model(cfg, params, bstats).state_dict()
    got = torch.load(path / "model.pt", weights_only=True)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k].float(), rtol=0, atol=0, msg=k)
    net = load_radnet(str(path), device="cpu")
    img = _grey_panel(3)
    dets = JaxRADNet(cfg, model, params, bstats).predict([img])
    assert len(dets) > 0
    _assert_same_dets(net.predict([img]), dets)
