"""``radnet_torch.cli.train`` from pretrained backbone weights on the CPU: a
converted Keras file trains a tiny ResNet50 for 2 steps; the first step
moves a loaded trainable tensor; the frozen ones reach ``model.pt``
unchanged, the trained ones moved; the loss plots are drawn.  An ``.h5``
is refused naming the converter, and the refusal and warning of
``apply_pretrained_weights`` are the JAX package's, word for word."""

import csv
import os
import types
import xml.etree.ElementTree as ET

import h5py
import numpy as np
import pytest
import torch

from radnet_torch.cli import train as ttrain
from radnet_torch.data.png import write_png
from radnet_torch.engine import steps as tsteps
from radnet_torch.models.weights import save_keras_layers
from radnet_tpu.cli import train as jtrain
from tests.torch_port_util import torch_config
from tests.util import tiny_config

torch.set_num_threads(1)

IMG_TYPE = "enhanced_topo_grey"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Two grey panels of 100-120 px (tiles of 64) with bright figures in
    train.csv, and a tiny ResNet50 config that names base_net_weights, its
    trunk trainable above stage 2."""
    root = tmp_path_factory.mktemp("synth")
    rng = np.random.default_rng(0)
    rows = []
    os.makedirs(root / "data" / "train" / IMG_TYPE)
    for k in range(2):
        img = rng.integers(20, 60, (int(rng.integers(100, 120)), int(rng.integers(100, 120))),
                           dtype=np.uint8)
        for i in range(4):
            bw, bh = rng.integers(14, 30, 2)
            x, y = int(rng.integers(0, img.shape[1] - bw)), int(rng.integers(0, img.shape[0] - bh))
            img[y:y + bh, x:x + bw] = rng.integers(120, 250)
            rows.append([f"panel{k}.png", ("boat", "human")[i % 2], x, y, x + int(bw), y + int(bh)])
        write_png(str(root / "data" / "train" / IMG_TYPE / f"panel{k}.png"), img)
    with open(root / "data" / "train.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["img_path", "label", "xmin", "ymin", "xmax", "ymax"])
        w.writerows(rows)
    cfg = torch_config(tiny_config("resnet50"))
    assert cfg.base_net_weights == "imagenet"
    cfg.base_net_trainable = True
    cfg_path = root / "config.json"
    cfg.save(str(cfg_path))
    return root, cfg_path


def _argv(root, cfg_path, tmp_path, name):
    d = root / "data"
    return ["--device", "cpu", "--config-json", str(cfg_path), "--models-path", str(tmp_path / "models"),
            "--train-annot", str(d / "train.csv"), "--train-data", str(d / "train"), "--no-validation",
            "--num-workers", "1", "--epoch-length", "2", "--n-epochs", "1", "--model-name", name]


def _keras_layers(seed: int) -> dict:
    """Seeded arrays at the Keras names of the stem, one stage-4 block's
    first conv and stage 5's first conv: HWIO kernels, batch-norm variances
    in [0.5, 2)."""
    rng = np.random.default_rng(seed)

    def conv(shape):
        fan_in = shape[0] * shape[1] * shape[2]
        return [("kernel:0", (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)),
                ("bias:0", rng.normal(0, 0.01, shape[-1]).astype(np.float32))]

    def bn(c):
        return list(zip(("gamma:0", "beta:0", "moving_mean:0", "moving_variance:0"),
                        (rng.uniform(0.5, 1.5, c).astype(np.float32), rng.normal(0, 0.05, c).astype(np.float32),
                         rng.normal(0, 0.05, c).astype(np.float32), rng.uniform(0.5, 2.0, c).astype(np.float32))))

    return {"conv1": conv((7, 7, 3, 64)), "bn_conv1": bn(64),
            "res4b_branch2a": conv((1, 1, 1024, 256)), "bn4b_branch2a": bn(256),
            "res5a_branch2a": conv((1, 1, 1024, 512)), "bn5a_branch2a": bn(512)}


def _mapped(layers) -> dict:
    """The port's names and layouts of ``_keras_layers``."""
    out = {}
    for keras, mod in (("conv1", "trunk.conv1"), ("res4b_branch2a", "trunk.s4b.conv2a"),
                       ("res5a_branch2a", "head.s5a.conv2a")):
        (_, k), (_, b) = layers[keras]
        out[mod + ".weight"] = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
        out[mod + ".bias"] = torch.from_numpy(b)
    for keras, mod in (("bn_conv1", "trunk.bn_conv1"), ("bn4b_branch2a", "trunk.s4b.bn2a"),
                       ("bn5a_branch2a", "head.s5a.bn2a")):
        for field, (_, a) in zip(("gamma", "beta", "mean", "var"), layers[keras]):
            out[f"{mod}.{field}"] = torch.from_numpy(a)
    return out


def test_train_from_converted_keras_file(dataset, tmp_path, monkeypatch, capsys):
    root, cfg_path = dataset
    layers = _keras_layers(1)
    path = tmp_path / "resnet50_keras.pt"
    save_keras_layers(str(path), layers)
    want = _mapped(layers)

    # Read the loaded trainable kernel right after the first step.
    after_first = []
    real = tsteps.make_step

    def make_step(state, config, *a, **k):
        fn = real(state, config, *a, **k)

        def step(*sa, **sk):
            out = fn(*sa, **sk)
            if not after_first:
                after_first.append(state.model.trunk.s4b.conv2a.weight.detach().clone())
            return out
        return step

    monkeypatch.setattr(tsteps, "make_step", make_step)
    assert ttrain.main(_argv(root, cfg_path, tmp_path, "pre") + ["--weights", str(path)]) == 0
    assert f"Loaded pretrained base-net weights from {path}" in capsys.readouterr().out

    # The first step moves the loaded kernel: the optimizer steps the model's
    # own tensor.  (Stage 5 gets no gradient before the zero-initialised
    # output layers have moved once.)
    assert not torch.equal(after_first[0], want["trunk.s4b.conv2a.weight"])
    model_dir = tmp_path / "models" / "faster_rcnn_resnet50_pre"
    trained = torch.load(model_dir / "model.pt", weights_only=True)
    for k, v in want.items():  # batch norm and the stem never train
        frozen = k.startswith("trunk.conv1.") or k.rsplit(".", 1)[1] in ("gamma", "beta", "mean", "var")
        assert torch.equal(trained[k], v) == frozen, k
    for name in ("accuracy", "rpn_loss", "detector_loss", "total_loss"):
        ET.parse(model_dir / "viz" / f"{name}.svg")


def test_h5_weights_are_refused_naming_the_converter(dataset, tmp_path):
    root, cfg_path = dataset
    h5 = tmp_path / "w.h5"
    with h5py.File(h5, "w") as f:
        f.create_group("conv1").attrs["weight_names"] = []
    with pytest.raises(SystemExit, match="scripts/h5_to_torch.py"):
        ttrain.main(_argv(root, cfg_path, tmp_path, "h5") + ["--weights", str(h5)])


@pytest.mark.parametrize("network,base,allow", [("resnet50", "imagenet", False),
                                                ("resnet50", "imagenet", True),
                                                ("vgg16", "imagenet", False),
                                                ("resnet50", None, False)])
def test_refusal_and_warning_equal_jax(network, base, allow, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)  # no weight file on any conventional path
    jcfg = tiny_config(network)
    jcfg.base_net_weights = base
    tcfg = torch_config(jcfg)
    results = []
    for apply, state in ((jtrain.apply_pretrained_weights, types.SimpleNamespace(params={}, batch_stats={})),
                         (ttrain.apply_pretrained_weights, types.SimpleNamespace(model=None))):
        try:
            out = apply(tcfg if apply is ttrain.apply_pretrained_weights else jcfg, state,
                        weights=str(tmp_path / "missing.pt"), allow_random_init=allow)
            results.append(("returned", out is state, capsys.readouterr().out))
        except SystemExit as e:
            results.append(("exit", str(e), capsys.readouterr().out))
    assert results[0] == results[1]
    refused = network == "resnet50" and base is not None and not allow
    assert results[0][0] == ("exit" if refused else "returned")
    assert ("WARNING" in results[0][2]) == (base is not None and not refused)
