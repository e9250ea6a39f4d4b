"""The port's mesh pieces that need no spawned ranks, against radnet_tpu:
the shard rules (``radnet_torch/parallel/mesh.py`` against
``radnet_tpu/parallel/mesh.py`` on the same weights), the quantizer's
amax-only and given-amax modes and the epilogue on summed int32 (plain
versions), the effective tile batch and the half-batch rule, and the CLIs'
refusals (a mesh asked for more cards than the host has; a model axis that
does not divide the mesh).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from radnet_torch.inference import RADNet as TorchRADNet
from radnet_torch.models.bridge import state_dict_from_flax, tensors_from_flax
from radnet_torch.ops import quant
from radnet_torch.parallel.mesh import Mesh, make_param_shardings, mesh_shape, shard_state_dict
from radnet_tpu.inference import RADNet as JaxRADNet
from radnet_tpu.parallel import make_mesh as jax_make_mesh
from radnet_tpu.parallel import make_param_shardings as jax_param_shardings
from tests.torch_port_util import jax_detector, port_model, torch_config

torch.set_num_threads(1)


def _slice_tree(tree, shardings, device):
    """Each leaf of a flax tree cut to ``device``'s index under its JAX
    sharding."""
    if isinstance(tree, dict):
        return {k: _slice_tree(v, shardings[k], device) for k, v in tree.items()}
    a = np.asarray(tree)
    return a[shardings.devices_indices_map(a.shape)[device]]


@pytest.mark.parametrize("network", ["resnet50", "vgg16"])
def test_shards_equal_jax_device_slices(network):
    """On make_mesh(8, model_parallel=2) every tensor's shard in the port, at
    each device's model index, equals JAX's slice for that device after the
    layout transpose."""
    cfg, _, params, bstats = jax_detector(network, decisive=False)
    mesh = jax_make_mesh(8, model_parallel=2)
    shardings = jax_param_shardings(params, mesh)
    full = state_dict_from_flax(jax.device_get(params), jax.device_get(bstats))
    n_sharded = sum(d is not None for d in make_param_shardings(full, 2).values())
    assert n_sharded == (3 if network == "vgg16" else 13)
    for (d, m), device in np.ndenumerate(mesh.devices):
        want = tensors_from_flax(_slice_tree(jax.device_get(params), shardings, device),
                                 jax.device_get(bstats))
        got = shard_state_dict(full, 2, m)
        assert got.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("network, model_parallel", [("vgg16", 3), ("resnet50", 3)])
def test_dims_that_do_not_divide_replicate_as_in_jax(network, model_parallel):
    """A model axis of 3 divides none of the head's sharded dimensions at
    these widths: both packages replicate every tensor."""
    cfg, _, params, bstats = jax_detector(network, decisive=False)
    mesh = jax_make_mesh(6, model_parallel=model_parallel)
    jax_specs = jax.tree_util.tree_leaves(
        jax_param_shardings(params, mesh), is_leaf=lambda s: hasattr(s, "spec"))
    assert all(s.spec == jax.sharding.PartitionSpec() for s in jax_specs)
    full = state_dict_from_flax(jax.device_get(params), jax.device_get(bstats))
    assert all(d is None for d in make_param_shardings(full, model_parallel).values())


def test_noop_model_axis_warns_on_stderr(capsys):
    make_param_shardings({"some.layer.weight": torch.zeros(4, 4)}, 2, warn_label="model")
    assert "0 model parameters matched" in capsys.readouterr().err
    cfg, _, params, bstats = jax_detector("resnet50", decisive=False)
    full = state_dict_from_flax(jax.device_get(params), jax.device_get(bstats))
    make_param_shardings(full, 2, warn_label="model")
    assert "matched" not in capsys.readouterr().err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pieces", [2, 4])
def test_given_amax_of_split_rows_equals_whole_rows(dtype, pieces):
    """Each piece's amax, reduced by MAX, then each piece quantized with it:
    bit-equal to quantize_sym on the whole row (the rows of a sharded
    activation and of a row-parallel weight)."""
    rng = np.random.default_rng(pieces)
    x = torch.from_numpy(rng.normal(0, 3, (6, 7, 7, 64)).astype(np.float32)).to(dtype)
    x[torch.from_numpy(rng.random(x.shape) < 0.4)] = 0.0
    x[2] = 0.0  # an all-zero row takes the 1e-12 floor
    whole = quant.quantize_rows_plain(x)
    parts = [x[..., i::pieces].contiguous() for i in range(pieces)]  # any split of the row
    amax = torch.stack([quant.quantize_rows_amax(p) for p in parts]).amax(dim=0)
    torch.testing.assert_close(amax, x.float().abs().amax(dim=(1, 2, 3)), rtol=0, atol=0)
    for i, p in enumerate(parts):
        got = quant.quantize_rows_given(p, amax)
        assert torch.equal(got.q, whole.q[..., i::pieces])
        assert torch.equal(got.scale, whole.scale)
    q_sym, s_sym = quant.quantize_sym(x, (1, 2, 3))
    assert torch.equal(whole.q, q_sym) and torch.equal(whole.scale, s_sym.reshape(-1))


EPILOGUES = {
    "float32": {},
    "float32_relu": {"relu": True},
    "bn_bf16_relu": {"bn": torch.bfloat16, "relu": True},
    "bn_f32": {"bn": torch.float32},
    "bn_bf16_residual_relu": {"bn": torch.bfloat16, "residual": True, "relu": True},
    "bn_f32_residual_relu": {"bn": torch.float32, "residual": True, "relu": True},
}


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
def test_epilogue_on_summed_int32_equals_the_fused_product(epilogue):
    """The int32 sums of K split in two, added, then int8_epilogue_plain:
    equal to int8_gemm_plain on the whole K (a row-parallel layer's output
    is the single device's)."""
    rng = np.random.default_rng(7)
    m, n, k, rps = 98, 64, 96, 49
    a = quant.Quantized(torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)),
                        torch.from_numpy(rng.uniform(0.001, 0.1, m // rps).astype(np.float32)))
    b = quant.Quantized(torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)),
                        torch.from_numpy(rng.uniform(0.001, 0.1, n).astype(np.float32)))
    bias = torch.from_numpy(rng.normal(0, 1, n).astype(np.float32))
    spec = EPILOGUES[epilogue]
    kw = {"relu": spec.get("relu", False)}
    if "bn" in spec:
        dt = spec["bn"]
        kw["bn"] = (torch.from_numpy(rng.uniform(0.5, 2, n).astype(np.float32)).to(dt),
                    torch.from_numpy(rng.normal(0, 1, n).astype(np.float32)).to(dt))
        if spec.get("residual"):
            kw["residual"] = torch.from_numpy(rng.normal(0, 10, (m, n)).astype(np.float32)).to(dt)
    want = quant.int8_gemm_plain(a, b, bias, rps, **kw)
    acc = sum(quant.int8_gemm_sums(quant.Quantized(a.q[:, s], a.scale),
                                   quant.Quantized(b.q[:, s], b.scale), rps)
              for s in (slice(0, 40), slice(40, k)))
    got = quant.int8_epilogue(acc, a.scale, b.scale, bias, rps, **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_int8_epilogue_cuda_refuses_cpu_tensors():
    acc = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        quant.int8_epilogue_cuda(acc, torch.ones(4), torch.ones(2))
    with pytest.raises(ValueError, match="CUDA"):
        quant.quantize_rows_amax_cuda(torch.zeros(2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        quant.quantize_rows_given_cuda(torch.zeros(2, 16), torch.zeros(2))


@pytest.fixture(scope="module")
def vgg():
    return jax_detector("vgg16", decisive=False)


@pytest.mark.parametrize("tile_batch, dp", [(3, 4), (4, 2), (4, 4), (6, 2), (8, 4)])
def test_mesh_tile_batch_and_schedule_match_jax(vgg, tile_batch, dp):
    """The effective tile batch is raised to a multiple of the data axis on
    the RADNet, not in the Config, and the schedule (with its half-batch
    rule) is JAX's on the same mesh shape."""
    cfg, model, params, bstats = vgg
    cfg = dataclasses.replace(cfg, infer_tile_batch=tile_batch)
    tcfg = torch_config(cfg)
    net = TorchRADNet(tcfg, port_model(cfg, params, bstats), device="cpu", mesh=Mesh(data=dp))
    jnet = JaxRADNet(cfg, model, params, bstats, mesh=jax_make_mesh(dp, model_parallel=1))
    assert tcfg.infer_tile_batch == tile_batch and net.tile_batch == jnet.tile_batch
    assert net.tile_batch % dp == 0
    for n in range(1, 3 * net.tile_batch + 2):
        assert net._batch_schedule(n) == jnet._batch_schedule(n), n


def test_mesh_shape_refuses_a_model_axis_that_does_not_divide():
    assert mesh_shape(8, 2) == (4, 2)
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        mesh_shape(3, 2)


def _cli_argv(module, tmp_path):
    common = ["--models-path", str(tmp_path), "--model-name", "m"]
    return {"serve": common, "predict": common + ["--scan-data-path", str(tmp_path)],
            "test": common, "test_rpn": common}[module]


@pytest.mark.parametrize("module", ["serve", "predict", "test", "test_rpn"])
def test_cli_mesh_without_the_cards_stops_with_the_numbers(module, tmp_path):
    """--n-devices on CUDA asks the host for that many cards; on a host with
    fewer it stops naming both numbers, and never runs on the CPU instead.
    A model axis that does not divide the mesh is refused first."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cli = importlib.import_module(f"radnet_torch.cli.{module}")
    argv = _cli_argv(module, tmp_path)
    with pytest.raises(SystemExit, match="needs 2 CUDA devices .*this host has 0"):
        cli.main(argv + ["--n-devices", "2"])
    with pytest.raises(ValueError, match="not divisible"):
        cli.main(argv + ["--device", "cpu", "--n-devices", "3", "--model-parallel", "2"])


@pytest.mark.parametrize("failing_rank", [0, 1])
def test_a_failing_rank_fails_the_run_without_a_hang(failing_rank):
    """A rank that raises: its peers' collective fails (gloo sees the closed
    connection) or they are stopped, and launch raises, naming the spawned
    rank or re-raising rank 0's own error."""
    import time

    from radnet_torch.parallel.launch import launch
    from tests.torch_mesh_ranks import fails_on

    t0 = time.perf_counter()
    if failing_rank == 0:
        with pytest.raises(RuntimeError, match="rank 0 fails on purpose"):
            launch(fails_on, 2, device_type="cpu", args=(0,))
    else:
        with pytest.raises(SystemExit, match="rank 1 \\(exit code 1\\)"):
            launch(fails_on, 2, device_type="cpu", args=(1,))
    assert time.perf_counter() - t0 < 60
