"""The port's bundled train step (``engine.steps.make_train_bundle``) on the
CPU, where it runs its K steps one after another: against radnet_tpu's
``make_train_bundle`` (one ``lax.scan`` of K steps) on the same weights,
batches and keys, at the single step's tolerances of
tests/test_torch_train_step.py (the stacked metrics, and the updated
parameters through the next batch's losses, within 1e-4 relative with a
floor of 1e-4 times the largest); ``fit`` with a bundle against the
unbundled loop; which bundle the training CLIs build; ``GatedAdam``'s
tensors keeping their identity, which a captured CUDA graph needs; the
bundle on a mesh; and the launch counts a graph's replays add
(``cuda_kernels.CapturedLaunches``).
"""

import dataclasses
import json
import shutil
import types

import jax
import numpy as np
import pytest
import torch

from radnet_torch.cli import cont_train as tcont
from radnet_torch.cli import train as ttrain
from radnet_torch.engine import loop as tloop
from radnet_torch.engine import steps as tsteps
from radnet_torch.engine import train_state as tstate
from radnet_torch.ops import cuda_kernels
from radnet_torch.parallel.launch import launch
from radnet_tpu.engine import steps as jsteps
from radnet_tpu.engine.train_state import create_train_state
from tests.test_torch_train_cli import _args, dataset  # noqa: F401 (a fixture)
from tests.torch_mesh_ranks import bundle_steps, draws_to_numpy
from tests.torch_port_util import jax_resnet, jax_step_draws, port_model, torch_config
from tests.util import synthetic_batch

torch.set_num_threads(1)

K = 2
# (trunk trainable, learning rate): Adam's first moves are lr * sign(g), so a
# trainable trunk's noise-level gradients move by up to 2 lr between the two
# packages' orders of summation (tests/test_torch_mesh_train.py).
CASES = [(False, 1e-3), (True, 1e-5)]
IDS = ["trunk_frozen", "trunk_trainable"]


def _close(got, want, rtol=1e-4):
    atol = rtol * max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _batch(cfg, seed):
    batch = synthetic_batch(cfg, batch=2, seed=seed)
    rng = np.random.default_rng(seed + 2)
    img = rng.integers(0, 255, batch["image"].shape).astype(np.uint8)
    img[:, 40:] = 0  # a zero band: background for the photometric ops
    batch["image"] = img
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _poisson_free(key, cfg, shape) -> bool:
    d = jax_step_draws(key, cfg, 2, shape, grey=True).photometric
    return not ((d.noise_coin < 0.5) & (d.noise_pick == 2)).any()


def _bundle_key(cfg, shape):
    """The first bundle key from 0 whose K step keys (the loop's splits)
    draw no Poisson noise: the port's Poisson sampler cannot replay JAX's
    (tests/test_torch_augment.py)."""
    for seed in range(100):
        rng, subs = jax.random.PRNGKey(seed), []
        for _ in range(K):
            rng, sub = jax.random.split(rng)
            subs.append(sub)
        if all(_poisson_free(s, cfg, shape) for s in subs):
            return jax.random.PRNGKey(seed), subs
    raise AssertionError("no Poisson-free bundle key")


@pytest.fixture(scope="module")
def setup():
    cfg, model, params, bstats = jax_resnet(0)
    batches = [_batch(cfg, 3), _batch(cfg, 4)]
    key, subs = _bundle_key(cfg, batches[0]["image"].shape)
    return cfg, model, params, bstats, batches, key, subs


@pytest.mark.parametrize("trainable,lr", CASES, ids=IDS)
def test_bundle_matches_jax_bundle(setup, trainable, lr):
    """K = 2 joint steps in one call of each package's bundle: the stacked
    metrics, Adam's count and the state's step, and the updated parameters
    through the next batch's losses."""
    cfg, model, params, bstats, batches, key, subs = setup
    jstate = create_train_state(model, cfg, jax.random.PRNGKey(0), learning_rate=lr,
                                base_net_trainable=trainable)
    jstate = jstate.replace(params=params)
    jbundle = jsteps.make_train_bundle(model, cfg, K, trunk_trainable=trainable)
    jnew, _, want = jax.device_get(jbundle(jstate, batches, key))

    tcfg = torch_config(cfg)
    ts = tstate.create_train_state(tcfg, torch.Generator(), "cpu", learning_rate=lr,
                                   base_net_trainable=trainable,
                                   model=port_model(cfg, params, bstats).train())
    bundle = tsteps.make_train_bundle(ts, tcfg, K, trunk_trainable=trainable)
    assert bundle._bundle_steps == K and not tsteps.graph_bundled(ts)
    draws = [jax_step_draws(s, cfg, 2, batches[0]["image"].shape, grey=True) for s in subs]
    got = bundle([_torch_batch(b) for b in batches], draws)
    assert set(got) == set(tsteps.METRIC_KEYS)
    for k in tsteps.METRIC_KEYS:
        assert got[k].shape == (K,)
        _close(got[k].numpy(), np.asarray(want[k]))
    assert ts.step == K == int(jnew.step)
    assert int(ts.optimizer.count) == K

    # The next batch's losses under each package's updated parameters.
    nkey = jax.random.PRNGKey(99)
    nbatch = _batch(cfg, 5)
    _, jm = jax.jit(lambda p: jsteps.compute_losses(model, cfg, p, bstats, nbatch, nkey, True))(
        jnew.params)
    with torch.no_grad():
        _, tm = tsteps.compute_losses(ts.model, tcfg, _torch_batch(nbatch),
                                      jax_step_draws(nkey, cfg, 2), tsteps.step_constants(tcfg, "cpu"),
                                      True)
    for k in tsteps.METRIC_KEYS:
        _close(float(tm[k]), float(jax.device_get(jm[k])))


def _fit(tcfg, batches, path, bundle_k):
    ts = tstate.create_train_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    step = tsteps.make_train_step(ts, tcfg)
    bundle = tsteps.make_train_bundle(ts, tcfg, bundle_k) if bundle_k else None

    def endless():
        while True:
            yield from batches

    ts, _ = tloop.fit(tcfg, ts, step, endless(), str(path), epoch_length=5, n_epochs=1,
                      seed=7, train_bundle=bundle)
    return ts


def test_fit_with_bundle_matches_unbundled(setup, tmp_path):
    """An epoch of 5 steps with K = 2 (two bundles, then a single step)
    against 5 single steps: record.csv but its elapsed time, metrics.jsonl
    steps 0-4 and the final state, bit for bit."""
    cfg, _, _, _, batches, _, _ = setup
    tcfg = torch_config(cfg)
    tbatches = [_torch_batch(b) for b in batches]
    plain = _fit(tcfg, tbatches, tmp_path / "plain", None)
    bundled = _fit(tcfg, tbatches, tmp_path / "bundled", K)

    def logs(name):
        with open(tmp_path / name / "metrics.jsonl") as f:
            lines = [json.loads(line) for line in f]
        rows = tloop.read_record(str(tmp_path / name / "record.csv"))
        # The checkpoints hold a full-width ResNet50 trunk: ~0.7 GB a run.
        shutil.rmtree(tmp_path / name)
        return lines, [{k: v for k, v in r.items() if k != "elapsed_time"} for r in rows]

    (lines_p, rows_p), (lines_b, rows_b) = logs("plain"), logs("bundled")
    assert [m["step"] for m in lines_b] == [0, 1, 2, 3, 4]
    assert lines_b == lines_p and rows_b == rows_p
    assert plain.step == bundled.step == 5
    for (n, a), b in zip(plain.model.state_dict().items(), bundled.model.state_dict().values()):
        assert torch.equal(a, b), n
    oa, ob = plain.optimizer.state_dict(), bundled.optimizer.state_dict()
    assert int(oa["count"]) == int(ob["count"]) == 5
    for a, b in zip(oa["exp_avg"] + oa["exp_avg_sq"], ob["exp_avg"] + ob["exp_avg_sq"]):
        assert torch.equal(a, b)


def test_fetch_flattens_bundled_metrics():
    """A bundle's entry (metrics stacked (K,)) becomes K rows between single
    steps' rows, in order."""
    single = {k: torch.tensor(float(i)) for i, k in enumerate(tsteps.METRIC_KEYS)}
    stacked = {k: torch.tensor([10.0 + i, 20.0 + i]) for i, k in enumerate(tsteps.METRIC_KEYS)}
    rows = tloop._fetch([stacked, single])
    assert [r["loss_rpn_cls"] for r in rows] == [10.0, 20.0, 0.0]
    assert rows[1] == {k: 20.0 + i for i, k in enumerate(tsteps.METRIC_KEYS)}


@pytest.fixture()
def spied(monkeypatch):
    """The bundles the CLIs build: (n_steps, trunk_trainable) a call of
    make_train_bundle, and each fit's train_bundle."""
    made, fitted = [], []
    real_make, real_fit = tsteps.make_train_bundle, tloop.fit

    def make(state, config, n_steps, trunk_trainable=None):
        made.append((n_steps, trunk_trainable))
        return real_make(state, config, n_steps, trunk_trainable)

    def fit(*args, train_bundle=None, **kwargs):
        fitted.append(train_bundle)
        return real_fit(*args, train_bundle=train_bundle, **kwargs)

    monkeypatch.setattr(tsteps, "make_train_bundle", make)
    monkeypatch.setattr(tloop, "fit", fit)
    return made, fitted


@pytest.mark.parametrize("schedule,k", [("joint", 4), ("alternating", 4), ("joint", 1)],
                         ids=["joint-4", "alternating-4", "joint-1"])
def test_clis_build_the_bundle_where_jax_does(dataset, spied, tmp_path, schedule, k):  # noqa: F811
    """cli.train and cli.cont_train pass fit a bundle of train_bundle_steps
    for the joint schedule when it is above 1 (cont_train's with
    base_net_cont_trainable), and none for the alternating schedule or for
    train_bundle_steps 1."""
    root, cfg, _ = dataset
    made, fitted = spied
    tcfg = dataclasses.replace(torch_config(cfg), train_schedule=schedule, train_bundle_steps=k)
    cfg_path = tmp_path / "config.json"
    tcfg.save(str(cfg_path))
    args = _args(root, cfg_path) + ["--no-validation", "--epoch-length", "1", "--n-epochs", "1"]
    args[args.index("--models-path") + 1] = str(tmp_path / "models")
    try:
        assert ttrain.main(args + ["--config-json", str(cfg_path), "--allow-random-init",
                                   "--model-name", "b"]) == 0
        assert tcont.main(args + ["--model-name", "faster_rcnn_resnet50_b"]) == 0
    finally:  # the checkpoints hold a full-width ResNet50 trunk: ~0.7 GB
        shutil.rmtree(tmp_path / "models", ignore_errors=True)
    bundled = schedule == "joint" and k > 1
    assert made == ([(k, None), (k, tcfg.base_net_cont_trainable)] if bundled else [])
    assert len(fitted) == 2
    assert all((b is not None and b._bundle_steps == k) if bundled else b is None for b in fitted)


def test_gated_adam_tensors_keep_their_identity():
    """A learning-rate change and load_state_dict write into the tensors a
    captured graph holds, and the values take."""
    params = [torch.nn.Parameter(torch.randn(3, 2)), torch.nn.Parameter(torch.randn(4))]
    opt = tstate.GatedAdam(params, 1e-3)
    held = [opt.count, opt._open, *opt.exp_avg, *opt.exp_avg_sq]
    ids = [id(t) for t in held]
    ptrs = [t.data_ptr() for t in held]
    opt.lr = 5e-4
    assert opt.lr == 5e-4 and float(opt._open[4]) == float(torch.tensor(-5e-4))
    other = tstate.GatedAdam([torch.nn.Parameter(p.detach().clone()) for p in params], 2e-3)
    for p in other.params:
        p.grad = torch.ones_like(p)
    other.step()
    opt.load_state_dict(other.state_dict())
    now = [opt.count, opt._open, *opt.exp_avg, *opt.exp_avg_sq]
    assert [id(t) for t in now] == ids and [t.data_ptr() for t in now] == ptrs
    assert int(opt.count) == 1 and opt.lr == 5e-4
    for a, b in zip(opt.exp_avg + opt.exp_avg_sq, other.exp_avg + other.exp_avg_sq):
        assert torch.equal(a, b) and a.abs().sum() > 0


def _adam_after_a_step():
    """A GatedAdam one step in, over a parameter that holds a -0.0."""
    p = torch.nn.Parameter(torch.tensor([-0.0, 1.0, -2.0, 3.0]))
    opt = tstate.GatedAdam([p], 1e-3)
    p.grad = torch.tensor([0.0, -1.0, 2.0, -1e-3])  # the -0.0 stays -0.0
    opt.step()
    return opt


@pytest.mark.parametrize("bad", [1e20, float("inf"), float("nan")],
                         ids=["square_overflows", "inf", "nan"])
def test_shut_gate_moves_nothing_whatever_the_gradient(bad):
    """A shut gate (the bundle's warm-up, the alternating schedule's
    detector phase without a valid RoI) keeps the parameters, the moments
    and the count bit for bit, also for a gradient a product with zero
    would make NaN and for a signed zero; an open gate is the ungated
    update, bit for bit."""
    opt = _adam_after_a_step()
    before = [t.clone() for t in opt.params + opt.exp_avg + opt.exp_avg_sq + [opt.count]]
    opt.params[0].grad = torch.tensor([bad, 1.0, -1.0, 0.0])
    opt.step(gate=torch.tensor(False))
    after = opt.params + opt.exp_avg + opt.exp_avg_sq + [opt.count]
    for a, b in zip(after, before):
        assert torch.equal(a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8))

    gated, ungated = _adam_after_a_step(), _adam_after_a_step()
    for o in (gated, ungated):
        o.params[0].grad = torch.tensor([0.25, 1.0, -1.0, 2.0])
    gated.step(gate=torch.tensor(True))
    ungated.step()
    for a, b in zip(gated.params + gated.exp_avg + gated.exp_avg_sq + [gated.count],
                    ungated.params + ungated.exp_avg + ungated.exp_avg_sq + [ungated.count]):
        assert torch.equal(a, b)
    assert int(gated.count) == 2


def test_bundle_is_a_graph_only_on_cuda_without_a_mesh():
    """The choice make_train_bundle makes: a CUDA graph on a card without a
    mesh; on the CPU, and on a mesh (gloo's collectives cannot be captured),
    K single steps."""
    def state(device, mesh):
        param = types.SimpleNamespace(device=torch.device(device))
        return types.SimpleNamespace(model=types.SimpleNamespace(parameters=lambda: iter([param])),
                                     mesh=mesh)

    assert tsteps.graph_bundled(state("cuda", None))
    assert not tsteps.graph_bundled(state("cuda", object()))
    assert not tsteps.graph_bundled(state("cpu", None))


def test_bundle_refuses_the_alternating_schedule_and_no_steps(setup):
    cfg = torch_config(setup[0])
    alt = dataclasses.replace(cfg, train_schedule="alternating")
    state = tstate.create_train_state(alt, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="alternating"):
        tsteps.make_train_bundle(state, alt, 2)
    joint = tstate.create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="n_steps"):
        tsteps.make_train_bundle(joint, cfg, 0)
    bundle = tsteps.make_train_bundle(joint, cfg, 2)
    with pytest.raises(ValueError, match="2 batches"):
        bundle([], [])


def test_bundle_on_a_mesh_runs_single_steps(setup):
    """Two CPU ranks at data parallelism 2: a bundle of K steps against K
    single steps from the same state, each rank with its rows: the same
    metrics and the same parameters, bit for bit, and no graph."""
    cfg, _, params, bstats, batches, _, subs = setup
    draws = [draws_to_numpy(jax_step_draws(s, cfg, 2, batches[0]["image"].shape, grey=True))
             for s in subs]
    state = {k: v.numpy() for k, v in port_model(cfg, params, bstats).state_dict().items()}
    job = {"cfg": torch_config(cfg).to_dict(), "state": state, "batches": batches,
           "draws": draws, "lr": 1e-3}
    out = launch(bundle_steps, 2, device_type="cpu", args=(job,))
    assert out["graph"] is False
    assert out["metrics_equal"] and out["params_equal"] and out["steps"] == [K, K]


class _FakeKernel:
    def __init__(self):
        self.launches = 0

    def launch(self):
        self.launches += 1


@pytest.mark.parametrize("replays", [1, 3])
def test_captured_launches_add_the_capture_on_every_replay(replays):
    """Counts after a capture are as before it; after N replays they are
    N times the capture's deltas (kernels and counters alike), and a kernel
    the capture did not launch stays as it was."""
    a, b, idle = _FakeKernel(), _FakeKernel(), _FakeKernel()
    a.launches, idle.launches = 5, 2
    stats = {"calls": 7, "other": 1}
    with cuda_kernels.CapturedLaunches([a, b, idle], counters=(stats,)) as cap:
        for _ in range(4):
            a.launch()
            stats["calls"] += 1
        b.launch()
    assert (a.launches, b.launches, idle.launches) == (5, 0, 2)
    assert stats == {"calls": 7, "other": 1}
    for _ in range(replays):
        cap.replayed()
    assert (a.launches, b.launches, idle.launches) == (5 + 4 * replays, replays, 2)
    assert stats == {"calls": 7 + 4 * replays, "other": 1}


def test_captured_launches_default_to_every_kernel():
    """Without a list, every kernel of cuda_kernels.KERNELS is followed."""
    before = [k.launches for k in cuda_kernels.KERNELS]
    try:
        with cuda_kernels.CapturedLaunches() as cap:
            cuda_kernels.ROI_POOL.launches += 1
        assert [k.launches for k in cuda_kernels.KERNELS] == before
        cap.replayed()
        assert [k.launches - b for k, b in zip(cuda_kernels.KERNELS, before)] == [
            int(k is cuda_kernels.ROI_POOL) for k in cuda_kernels.KERNELS]
    finally:
        for k, b in zip(cuda_kernels.KERNELS, before):
            k.launches = b
