"""The port stands alone and runs on the card unless asked otherwise:
no JAX, flax, OpenCV, PIL, tifffile, pandas, h5py, matplotlib or radnet_tpu
import in radnet_torch (its image reader included), chip_smoke.py, the
synthetic chain's scripts, the reader's timing script or the TIFF and JPEG
writers they use; entry points
default to CUDA and raise without a card; the serving protocol works
in-process on the CPU when asked."""

import ast
import io
import json
import pathlib

import numpy as np
import pytest
import torch

from radnet_torch.config import Config
from radnet_torch.data.png import write_png
from radnet_torch.inference import RADNet, load_radnet, save_radnet
from radnet_torch.models.detector import build_model, init_weights
from tests.util import tiny_config

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL", "tifffile", "radnet_tpu",
             "pandas", "h5py", "matplotlib"}
PORT_FILES = sorted((ROOT / "radnet_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "synthetic_chain.py",
    ROOT / "scripts" / "anchor_coverage.py", ROOT / "scripts" / "image_reader_timing.py",
    ROOT / "scripts" / "tiff_writer.py", ROOT / "scripts" / "jpeg_writer.py"]
READER = ["radnet_torch/data/image.py", "radnet_torch/data/jpeg.py", "radnet_torch/data/png.py",
          "radnet_torch/data/tiff.py", "radnet_torch/ops/host_kernels.py",
          "scripts/tiff_writer.py", "scripts/jpeg_writer.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_reader_modules_are_checked():
    """The image reader's modules are among the files checked above."""
    assert set(READER) <= {str(p.relative_to(ROOT)) for p in PORT_FILES}


def _tiny_model_dir(tmp_path):
    cfg = Config.from_dict(tiny_config("resnet50").to_dict())
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    save_radnet(str(tmp_path / "m"), cfg, model)
    return cfg, model


def test_default_device_is_cuda_and_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg, model = _tiny_model_dir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        RADNet(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_radnet(str(tmp_path / "m"))


def test_serve_protocol_on_cpu(tmp_path):
    from radnet_torch.cli import serve

    _tiny_model_dir(tmp_path)
    rng = np.random.default_rng(0)
    paths = []
    for i, shape in enumerate([(130, 140), (96, 100, 3)]):
        p = tmp_path / f"panel{i}.png"
        write_png(str(p), rng.integers(0, 255, shape, dtype=np.uint8))
        paths.append(str(p))
    lines = [paths[0], str(tmp_path / "missing.png"), paths[1]]
    out = io.StringIO()
    rc = serve.main(
        ["--models-path", str(tmp_path), "--model-name", "m", "--device", "cpu"],
        stdin=io.StringIO("\n".join(lines) + "\n"), stdout=out,
    )
    assert rc == 0
    recs = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [r["path"] for r in recs] == lines
    assert "error" in recs[1] and "detections" not in recs[1]
    for r in (recs[0], recs[2]):
        assert isinstance(r["detections"], list) and r["sec"] >= 0


@pytest.mark.parametrize("module", ["radnet_torch.cli.test", "radnet_torch.cli.test_rpn",
                                    "radnet_torch.cli.test_data"])
def test_eval_clis_load_without_a_card_and_default_to_cuda(module, tmp_path):
    import importlib

    cli = importlib.import_module(module)
    assert cli.build_argparser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        return
    _tiny_model_dir(tmp_path)
    argv = ["--models-path", str(tmp_path), "--model-name", "m"]
    if module.endswith("test_data"):
        argv = ["--train-annot", str(tmp_path / "none.csv")]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)
