"""Pretrained backbone weights in the port against the JAX package's loaders:
partial Keras ``.h5`` files through ``load_keras_h5`` and the bridge on one
side, through ``scripts/h5_to_torch.py`` and ``load_keras_layers`` on the
other, bit-equal on every key; a full-width torchvision dict; the search
list; the errors; and the dispatch of ``maybe_load_pretrained``."""

import importlib.util
import pathlib
import zlib

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from radnet_torch.models import weights as tw
from radnet_torch.models.bridge import state_dict_from_flax
from radnet_torch.models.detector import build_model as torch_build_model
from radnet_tpu.models import weights as jw
from radnet_tpu.models.detector import build_model as jax_build_model
from tests.torch_port_util import torch_config
from tests.util import tiny_config

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _h5_to_torch():
    spec = importlib.util.spec_from_file_location("h5_to_torch", ROOT / "scripts" / "h5_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seeded_trees(network: str, seed: int = 0):
    """The JAX detector's params and batch_stats trees (tiny config, full
    backbone widths) filled with seeded values in [0.5, 1.5): shapes from
    ``jax.eval_shape``, so no init runs."""
    cfg = tiny_config(network)
    model = jax_build_model(cfg)
    s = cfg.canvas_size
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, s, s, 3)),
                                               jnp.asarray([[[0.0, 0.0, 2.0, 2.0]]])))
    rng = np.random.default_rng(seed)
    trees = jax.tree_util.tree_map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                                   shapes)
    return cfg, trees["params"], trees.get("batch_stats", {})


def _port_model(cfg, params, stats):
    model = torch_build_model(torch_config(cfg))
    model.load_state_dict(state_dict_from_flax(params, stats))
    return model


def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _case_layers(case: str, params, stats, rng):
    """(network, {group: [(weight name, array)]}, nested under model_weights)."""
    def conv(path, names=("kernel:0", "bias:0")):
        node = _node(params, path)
        return [(n, rng.normal(size=node[leaf].shape).astype(np.float32))
                for n, leaf in zip(names, ("kernel", "bias"))]

    def bn(path, fourth="moving_variance:0"):
        c = _node(stats, path)["gamma"].shape[0]
        vals = [rng.uniform(0.5, 1.5, c), rng.normal(0, 0.1, c), rng.normal(0, 0.1, c),
                rng.uniform(0.5, 2.0, c)]
        return list(zip(("gamma:0", "beta:0", "moving_mean:0", fourth),
                        (v.astype(np.float32) for v in vals)))

    if case == "vgg_conv_with_bias":
        return "vgg16", {"block1_conv1": conv(("trunk", "block1_conv1"),
                                              ("block1_conv1/kernel:0", "block1_conv1/bias:0")),
                         "block4_conv2": conv(("trunk", "block4_conv2"), ("W:0", "b:0"))}, False
    if case == "resnet_bn_conv1_moving_variance":
        return "resnet50", {"bn_conv1": bn(("trunk", "bn_conv1"))}, False
    if case == "resnet_stage2_block":
        layers = {}
        for br, c, b in (("2a", "conv2a", "bn2a"), ("2b", "conv2b", "bn2b"), ("2c", "conv2c", "bn2c"),
                         ("1", "conv_sc", "bn_sc")):
            layers[f"res2a_branch{br}"] = conv(("trunk", "s2a", c))
            layers[f"bn2a_branch{br}"] = bn(("trunk", "s2a", b), "running_std:0")
        return "resnet50", layers, False
    if case == "resnet_stage5_head":
        return "resnet50", {"res5b_branch2b": conv(("head", "s5b", "conv2b")),
                            "bn5b_branch2b": bn(("head", "s5b", "bn2b")),
                            "fc1000": [("kernel:0", rng.normal(size=(2048, 1000)).astype(np.float32))]}, False
    if case == "nested_model_weights":
        return "resnet50", {"conv1": conv(("trunk", "conv1")), "bn_conv1": bn(("trunk", "bn_conv1"))}, True
    if case == "kernel_by_position":
        return "resnet50", {"res3b_branch2a": conv(("trunk", "s3b", "conv2a"), ("param_0", "param_1"))}, False
    raise ValueError(case)


def _write_h5(path, layers, nested: bool):
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights") if nested else f
        f.attrs["layer_names"] = [n.encode() for n in layers]
        for name, weights in layers.items():
            g = root.create_group(name)
            g.attrs["weight_names"] = [n.encode() for n, _ in weights]
            for n, a in weights:
                g.create_dataset(n, data=a)


def test_name_maps_equal_jax():
    assert tw._resnet_name_map() == jw._resnet_name_map()
    assert tw._vgg_name_map() == jw._vgg_name_map()
    for network in ("resnet50", "vgg16"):
        assert tw._name_map(network) == jw._name_map(network)
    with pytest.raises(ValueError, match="unknown network"):
        tw._name_map("resnet101")


@pytest.mark.parametrize("case", ["vgg_conv_with_bias", "resnet_bn_conv1_moving_variance",
                                  "resnet_stage2_block", "resnet_stage5_head", "nested_model_weights",
                                  "kernel_by_position"])
def test_converted_h5_loads_bit_equal_to_jax(case, tmp_path):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    network = "vgg16" if case.startswith("vgg") else "resnet50"
    cfg, params, stats = _seeded_trees(network)
    network, layers, nested = _case_layers(case, params, stats, rng)
    h5 = tmp_path / "w.h5"
    _write_h5(h5, layers, nested)

    jp, js, jloaded = jw.load_keras_h5(str(h5), params, stats, network)
    want = state_dict_from_flax(jp, js)

    converted = tmp_path / "w.pt"
    assert _h5_to_torch().main([str(h5), str(converted)]) == 0
    kind, content = tw.read_weight_file(str(converted))
    assert kind == "keras" and set(content) == set(layers)  # nothing mapped or dropped
    model = _port_model(cfg, params, stats)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loaded = tw.load_keras_layers(content, model, network)

    assert loaded == jloaded and loaded == [n for n, _, _ in tw._name_map(network) if n in layers]
    got = model.state_dict()
    assert got.keys() == want.keys()
    touched = [k for k in got if not torch.equal(got[k], before[k])]
    assert touched, "nothing loaded"
    for k in got:
        assert torch.equal(got[k], want[k]), k  # tolerance 0
    # Every key the file names changed; every other key kept its init.
    named = {tw._name(path) for n, path, _ in tw._name_map(network) if n in layers}
    for k in got:
        assert (k in touched) == (k.rsplit(".", 1)[0] in named), k


def test_torchvision_full_width_bit_equal_to_jax():
    cfg, params, stats = _seeded_trees("resnet50", seed=1)
    # Variances down to 1e-4, where the eps correction moves gamma most.
    sd = chip_smoke.torchvision_resnet50_dict(2, var_range=(1e-4, 2.0))

    jp, js = jw.load_torchvision_resnet50(sd, params, stats)
    want = state_dict_from_flax(jp, js)
    model = _port_model(cfg, params, stats)
    tw.load_torchvision_resnet50(sd, model)
    got = model.state_dict()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    # The eps correction is in gamma, and the biases keep their init.
    var = sd["bn1.running_var"].double()
    fix = torch.sqrt((var + 1e-3) / (var + 1e-5)).float()
    assert torch.equal(got["trunk.bn_conv1.gamma"], sd["bn1.weight"] * fix)
    assert not torch.equal(got["trunk.bn_conv1.gamma"], sd["bn1.weight"])
    assert torch.equal(got["trunk.conv1.bias"], torch.from_numpy(params["trunk"]["conv1"]["bias"]))
    assert torch.equal(got["head.s5c.conv2c.weight"], sd["layer4.2.conv3.weight"])


def test_candidate_paths_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    hub = tmp_path / ".cache" / "torch" / "hub" / "checkpoints"
    hub.mkdir(parents=True)
    for f in ("resnet50-0676ba61.pth", "resnet50_x.pt", "vgg16-397923af.pth", "resnet50.txt"):
        (hub / f).write_bytes(b"")
    cfg = torch_config(tiny_config("resnet50"))
    jcfg = tiny_config("resnet50")
    for network, base, search in (("resnet50", "imagenet", ()), ("vgg16", "imagenet", ("a.pt", None)),
                                  ("resnet50", "/w/explicit.pt", ("b.pt",)), ("vgg16", None, ())):
        cfg.network = jcfg.network = network
        cfg.base_net_weights = jcfg.base_net_weights = base
        got = tw._candidate_paths(cfg, search)
        assert got == jw._candidate_paths(jcfg, search)
    assert str(hub / "resnet50-0676ba61.pth") in tw._candidate_paths(
        torch_config(tiny_config("resnet50")), ())


def test_shape_mismatch_and_bn_arity_raise_as_jax(tmp_path):
    cfg, params, stats = _seeded_trees("resnet50")
    rng = np.random.default_rng(5)
    for layers, match in (
        ({"conv1": [("kernel:0", rng.normal(size=(7, 7, 3, 32)).astype(np.float32))]}, "shape mismatch"),
        ({"bn_conv1": [(f"w{i}:0", np.ones(64, np.float32)) for i in range(3)]}, "expected 4 BN arrays"),
        ({"res2a_branch2a": [("kernel:0", rng.normal(size=(1, 1, 64, 64)).astype(np.float32)),
                             ("bias:0", np.ones(32, np.float32))]}, "shape mismatch"),
    ):
        h5 = tmp_path / "bad.h5"
        _write_h5(h5, layers, False)
        with pytest.raises(ValueError, match=match) as jerr:
            jw.load_keras_h5(str(h5), params, stats, "resnet50")
        _h5_to_torch().main([str(h5), str(tmp_path / "bad.pt")])
        model = _port_model(cfg, params, stats)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        with pytest.raises(ValueError, match=match) as terr:
            tw.load_keras_layers(tw.read_weight_file(str(tmp_path / "bad.pt"))[1], model, "resnet50")
        assert str(terr.value) == str(jerr.value)
        # Checked before anything is written: the model is as it was.
        assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_maybe_load_pretrained_dispatch(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    cfg, params, stats = _seeded_trees("resnet50")
    tcfg = torch_config(cfg)
    rng = np.random.default_rng(6)
    layers = {"conv1": [("kernel:0", rng.normal(size=(7, 7, 3, 64)).astype(np.float32)),
                        ("bias:0", rng.normal(size=64).astype(np.float32))]}
    model = _port_model(cfg, params, stats)

    assert tw.maybe_load_pretrained(tcfg, model) is None  # nothing there
    tcfg.base_net_weights = None
    tw.save_keras_layers(str(tmp_path / "x.pt"), layers)
    assert tw.maybe_load_pretrained(tcfg, model, ["x.pt"]) is None  # not asked for
    tcfg.base_net_weights = "imagenet"

    # An .h5 on a conventional path stops the run, naming the converter...
    _write_h5(tmp_path / jw._RESNET_H5, layers, False)
    with pytest.raises(SystemExit, match="scripts/h5_to_torch.py"):
        tw.maybe_load_pretrained(tcfg, model)
    with pytest.raises(SystemExit, match="scripts/h5_to_torch.py"):
        tw.maybe_load_pretrained(tcfg, model, [str(tmp_path / jw._RESNET_H5)])
    # ... unless its converted file lies beside it, which loads first.
    converted = tmp_path / jw._RESNET_H5.replace(".h5", ".pt")
    tw.save_keras_layers(str(converted), layers)
    assert tw.maybe_load_pretrained(tcfg, model) == jw._RESNET_H5.replace(".h5", ".pt")
    assert torch.equal(model.trunk.conv1.weight, torch.from_numpy(layers["conv1"][0][1].transpose(3, 2, 0, 1)))

    # A converted file is told by its marker, not its suffix: a torchvision
    # dict under the same suffix is the torchvision port, ResNet50 only.
    sd = {"conv1.weight": torch.zeros(64, 3, 7, 7)}
    torch.save(sd, tmp_path / "tv.pt")
    assert tw.read_weight_file(str(tmp_path / "tv.pt"))[0] == "torchvision"
    assert tw.read_weight_file(str(tmp_path / "tv.pt"), keras_only=True) == ("torchvision", None)
    kind, mapped = tw.read_weight_file(str(converted), keras_only=True)
    assert kind == "keras" and torch.equal(mapped["conv1"]["arrays"][0], torch.from_numpy(layers["conv1"][0][1]))
    vcfg = torch_config(tiny_config("vgg16"))
    vcfg.base_net_weights = "/nowhere.pt"
    vmodel = torch_build_model(vcfg)
    assert tw.maybe_load_pretrained(vcfg, vmodel, [str(tmp_path / "tv.pt")]) is None
    capsys.readouterr()
    with pytest.raises(KeyError, match="bn1.running_var"):  # a partial dict is refused
        tw.maybe_load_pretrained(tcfg, model, [str(tmp_path / "tv.pt")])


def test_loaded_tensors_stay_the_models_own():
    """The loader copies into the parameters in place: an optimizer built
    before the load keeps stepping the loaded values."""
    cfg, params, stats = _seeded_trees("resnet50")
    model = _port_model(cfg, params, stats)
    ids = {n: id(p) for n, p in model.named_parameters()}
    kernel = np.random.default_rng(7).normal(size=(1, 1, 2048, 512)).astype(np.float32)
    tw.load_keras_layers({"res5c_branch2a": {"weight_names": ["kernel:0"],
                                             "arrays": [torch.from_numpy(kernel)]}}, model, "resnet50")
    assert {n: id(p) for n, p in model.named_parameters()} == ids
    assert torch.equal(model.head.s5c.conv2a.weight, torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
