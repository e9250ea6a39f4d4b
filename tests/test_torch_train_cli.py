"""The port's training data path and drivers on the CPU: ``get_data`` and
eval-mode tile samples equal to radnet_tpu's (both packages resizing with
the port's bicubic), then ``radnet_torch.cli.train`` for 2 x 2 steps,
``cli.cont_train`` for one more epoch, and ``load_radnet`` predicting from
the directory they wrote."""

import csv
import json
import os

import cv2
import numpy as np
import pytest
import torch

from radnet_torch.cli import cont_train as tcont
from radnet_torch.cli import train as ttrain
from radnet_torch.data import dataset as tdataset
from radnet_torch.data import pipeline as tpipe
from radnet_torch.data.png import write_png
from radnet_torch.engine.loop import RECORD_COLUMNS
from radnet_torch.inference import load_radnet
from radnet_tpu.data import dataset as jdataset
from radnet_tpu.data import pipeline as jpipe
from radnet_tpu.engine.loop import RECORD_COLUMNS as JAX_RECORD_COLUMNS
from tests.torch_port_util import port_cv2_resize, torch_config
from tests.util import tiny_config

torch.set_num_threads(1)

IMG_TYPE = "enhanced_topo_grey"


def _panel(rng, h, w, n_figures):
    img = rng.integers(20, 60, (h, w), dtype=np.uint8)
    boxes = []
    for _ in range(n_figures):
        bw, bh = rng.integers(14, 30, 2)
        x, y = rng.integers(0, w - bw), rng.integers(0, h - bh)
        img[y:y + bh, x:x + bw] = rng.integers(120, 250)
        boxes.append((int(x), int(y), int(x + bw), int(y + bh)))
    return img, boxes


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Grey panels of 96-140 px (tiles of 64) with bright figures, and
    train.csv / val.csv."""
    root = tmp_path_factory.mktemp("synth")
    rng = np.random.default_rng(0)
    for split, n in (("train", 3), ("val", 2)):
        rows = []
        os.makedirs(root / "data" / split / IMG_TYPE, exist_ok=True)
        for k in range(n):
            img, boxes = _panel(rng, int(rng.integers(96, 140)), int(rng.integers(96, 140)), 4)
            name = f"panel{k}.png"
            write_png(str(root / "data" / split / IMG_TYPE / name), img)
            for i, b in enumerate(boxes):
                rows.append([name, ("boat", "human")[i % 2], *b])
        with open(root / "data" / f"{split}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["img_path", "label", "xmin", "ymin", "xmax", "ymax"])
            w.writerows(rows)
    cfg = tiny_config("resnet50")
    cfg.batch_size = 2
    cfg.max_n_tiles_val = 2
    cfg_path = root / "config.json"
    torch_config(cfg).save(str(cfg_path))
    return root, cfg, cfg_path


def _args(root, cfg_path):
    d = root / "data"
    return ["--device", "cpu", "--models-path", str(root / "models"),
            "--train-annot", str(d / "train.csv"), "--train-data", str(d / "train"),
            "--val-annot", str(d / "val.csv"), "--val-data", str(d / "val"),
            "--epoch-length", "2", "--num-workers", "2"]


def test_get_data_matches_jax(dataset):
    root, cfg, _ = dataset
    args = (str(root / "data" / "train.csv"), str(root / "data" / "train"), [IMG_TYPE])
    got = tdataset.get_data(*args)
    want = jdataset.get_data(*args)
    assert got == want
    assert got[2] == {"boat": 0, "human": 1, "bg": 2} and got[1]["bg"] == 0


@pytest.mark.parametrize("generator", ["tile_sample_generator", "image_sample_generator"])
def test_eval_samples_match_jax(dataset, monkeypatch, generator):
    monkeypatch.setattr(cv2, "resize", port_cv2_resize)
    root, cfg, _ = dataset
    data, class_count, mapping = jdataset.get_data(str(root / "data" / "val.csv"),
                                                   str(root / "data" / "val"), [IMG_TYPE])
    tcfg = torch_config(cfg)
    counts = (class_count,) if generator == "tile_sample_generator" else ()
    got = list(getattr(tpipe, generator)(data, tcfg, *counts, mapping, train_mode=False, seed=3))
    want = list(getattr(jpipe, generator)(data, cfg, *counts, mapping, train_mode=False, seed=3))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    (batch,) = tpipe.batched(iter(got[:1]), 2, tcfg)
    assert batch["sample_valid"].tolist() == [True, False]  # padded with a masked sample


def test_train_samples_have_training_shapes(dataset):
    root, cfg, _ = dataset
    tcfg = torch_config(cfg)
    data, class_count, mapping = tdataset.get_data(str(root / "data" / "train.csv"),
                                                   str(root / "data" / "train"), [IMG_TYPE])
    gen = tpipe.parallel_sample_generator(data, tcfg, class_count, mapping, num_workers=2, seed=1)
    batch = next(tpipe.prefetch_to_device(tpipe.batched(gen, 2, tcfg, drop_remainder=True), "cpu"))
    assert batch["image"].shape == (2, 64, 64, 3) and batch["image"].dtype == torch.uint8
    assert batch["gt_mask"].any(1).all() and batch["sample_valid"].all()


def test_train_then_cont_train_then_predict(dataset):
    root, cfg, cfg_path = dataset
    base = _args(root, cfg_path)
    with pytest.raises(SystemExit, match="allow-random-init"):
        ttrain.main(base + ["--config-json", str(cfg_path), "--model-name", "refused"])
    # --weights is searched first: a file that is not there is not found.
    with pytest.raises(SystemExit, match="no weight file was found"):
        ttrain.main(base + ["--config-json", str(cfg_path), "--weights", "x.h5"])
    # A mesh trains (tests/test_torch_mesh_train_cli.py); a batch that does
    # not divide over its data axis is refused with the JAX package's message.
    with pytest.raises(SystemExit, match="batch_size=2 is not divisible by the data-parallel size 4"):
        ttrain.main(base + ["--config-json", str(cfg_path), "--n-devices", "4"])

    rc = ttrain.main(base + ["--config-json", str(cfg_path), "--model-name", "smoke",
                             "--n-epochs", "2", "--allow-random-init", "--lr", "1e-4"])
    assert rc == 0
    model_dir = root / "models" / "faster_rcnn_resnet50_smoke"
    for name in ("config.json", "record.csv", "metrics.jsonl", "model.pt",
                 "ckpt_best/train_state.pt", "ckpt_last/train_state.pt", "viz", "test",
                 "dashboard.html"):
        assert (model_dir / name).exists(), name
    assert any(n.startswith("events.out.tfevents") for n in os.listdir(model_dir))
    with open(model_dir / "record.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0].keys()) == RECORD_COLUMNS == JAX_RECORD_COLUMNS
    assert len(rows) == 2
    assert rows[0]["model_improvement"] == "-inf" and rows[0]["val_total_loss"] != ""
    for r in rows:
        assert np.isfinite(float(r["total_loss"])) and np.isfinite(float(r["val_total_loss"]))
    steps = [json.loads(line)["step"] for line in open(model_dir / "metrics.jsonl")]
    assert steps == [0, 1, 2, 3]
    assert ttrain.main(base + ["--config-json", str(cfg_path), "--model-name", "smoke",
                               "--allow-random-init"]) == 1  # exists

    rc = tcont.main(base + ["--model-name", "faster_rcnn_resnet50_smoke", "--n-epochs", "1"])
    assert rc == 0
    with open(model_dir / "record.csv", newline="") as f:
        assert len(list(csv.DictReader(f))) == 3
    # The dashboard is rendered again, from all three epochs.
    assert (model_dir / "dashboard.html").read_text().count("<tr><td>") == 3
    # base_net_cont_trainable changes the partition: weights only, so the
    # step count restarts, as in the JAX package.
    steps = [json.loads(line)["step"] for line in open(model_dir / "metrics.jsonl")]
    assert steps[-2:] == [0, 1]

    net = load_radnet(str(model_dir), device="cpu")
    img = np.repeat(_panel(np.random.default_rng(9), 120, 130, 3)[0][..., None], 3, -1)
    dets = net.predict([img])
    assert isinstance(dets, list)


def test_training_clis_default_to_cuda_and_refuse_alternating(dataset, tmp_path):
    """Both CLIs default to the card.  ``--train-schedule alternating`` is
    ported (it was refused, naming ROADMAP Queue 1 item 12, before): one
    step of it on the ResNet50 writes the schedule into config.json and a
    checkpoint with the two phase Adam states."""
    root, _, cfg_path = dataset
    base = _args(root, cfg_path)[2:]  # no --device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.main(base + ["--config-json", str(cfg_path), "--allow-random-init"])
        with pytest.raises(RuntimeError, match="CUDA"):
            tcont.main(base + ["--model-name", "any"])
    args = _args(root, cfg_path) + ["--no-validation", "--epoch-length", "1"]
    args[args.index("--models-path") + 1] = str(tmp_path / "models")
    assert ttrain.main(args + ["--config-json", str(cfg_path), "--allow-random-init",
                               "--train-schedule", "alternating", "--model-name", "alt",
                               "--n-epochs", "1"]) == 0
    model_dir = tmp_path / "models" / "faster_rcnn_resnet50_alt"
    assert json.loads((model_dir / "config.json").read_text())["train_schedule"] == "alternating"
    state = torch.load(model_dir / "ckpt_last" / "train_state.pt", weights_only=True)
    assert set(state["optimizer"]) == {"rpn", "det"} and int(state["optimizer"]["det"]["count"]) <= 1


def test_cont_train_resumes_adam_and_step_when_partition_unchanged(dataset, tmp_path):
    root, cfg, _ = dataset
    tcfg = torch_config(cfg)
    tcfg.base_net_cont_trainable = tcfg.base_net_trainable = False
    cfg_path = tmp_path / "same_partition.json"
    tcfg.save(str(cfg_path))
    args = _args(root, cfg_path) + ["--no-validation", "--epoch-length", "1"]
    args[args.index("--models-path") + 1] = str(tmp_path / "models")
    assert ttrain.main(args + ["--config-json", str(cfg_path), "--model-name", "same",
                               "--allow-random-init", "--n-epochs", "1"]) == 0
    model_dir = tmp_path / "models" / "faster_rcnn_resnet50_same"
    assert tcont.main(args + ["--model-name", model_dir.name, "--n-epochs", "1"]) == 0
    steps = [json.loads(line)["step"] for line in open(model_dir / "metrics.jsonl")]
    assert steps == [0, 1]  # Adam's moments and the step count resumed
    state = torch.load(model_dir / "ckpt_last" / "train_state.pt", weights_only=True)
    assert state["step"] == 2 and int(state["optimizer"]["count"]) == 2
    assert state["optimizer"]["lr"] == 2e-5  # cont_train's rate, not train's
    with open(model_dir / "record.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 and rows[0]["val_total_loss"] == ""
