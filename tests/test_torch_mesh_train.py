"""The port's train step on a 2 x 2 gloo mesh (four spawned CPU ranks: data
parallelism over the tiles, the RoI head tensor-parallel, Adam's moments
split with it) against radnet_tpu's GSPMD step on make_mesh(4,
model_parallel=2), on the same weights, batch and draws: the joint and the
alternating schedule, for both backbones.  The two tiles hold different
numbers of ground-truth boxes, so the two data indices hold different
numbers of valid anchors and RoIs, and a mean of per-rank ratios would
differ from the whole batch's ratio of sums.

Tolerances are the single device's (tests/test_torch_alternating.py,
tests/test_torch_train_step.py): the alternating step's metrics within 5e-6
absolute (5e-6 relative above 1), the joint step's within 1e-4 relative;
the updated parameters through the next batch's eval losses within 1e-4
relative.  Adam's moments after the step, gathered whole, are held
elementwise within 1e-4 relative, with a floor of 1e-3 times each tensor's
largest magnitude (the card's first mesh_train gate, PERF.md section 2), to
the port's single-device step on the same inputs: on this batch the two
packages' single devices differ by up to 0.2% of an RPN moment of the joint
ResNet50 step (float32 noise at a rounding or clipping boundary), and by
14% of a trunk moment of the alternating VGG16 one at a rate of 1e-5
(below).  The mesh sums each gradient over two data halves, so an element
a few percent of its tensor's largest can sit some 1.6e-6 from the single
device's, 5.5e-4 of it relative (a 1x1 conv's first moment of the joint
ResNet50 step with a trainable trunk, on some hosts), above a floor of
1e-4 of the largest.  A witness holds the limit to a fault: the moments of
a mesh whose ranks each divide by their own tiles' denominators (a mean of
the ranks' ratios) fail it.  The rates are small where a later phase or the next batch reads
what an update moved: Adam's first update is lr * sign(g), so a
noise-level gradient moves its element by up to 2 lr between two orders of
summation (the two-Adam-steps departure of ROADMAP Queue 3).  On this
batch the VGG16 alternating step with a trainable trunk gives a detector
class loss 8.1e-4 from JAX's at 1e-5, on both layouts of each package
alike, and 4.3e-6 at 1e-8; the ResNet50 joint step with a trainable trunk
gives a next-batch loss 3e-4 relative from JAX's at 1e-3.  The replicated
parameters (trunk, RPN, conv2b, the biases added after a sum) come out
bit-equal on every rank of both axes.

The ranks spawn once for the module (one job a case).
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from radnet_torch.engine import steps as tsteps
from radnet_torch.engine import train_state as tstate
from radnet_torch.models.bridge import state_dict_from_flax
from radnet_torch.models.detector import build_model
from radnet_torch.parallel.launch import launch
from radnet_tpu.engine import steps as jsteps
from radnet_tpu.engine.train_state import create_train_state
from radnet_tpu.parallel import make_mesh
from radnet_tpu.parallel.mesh import batch_sharding, shard_train_state
from tests.test_torch_alternating import _port_name, _port_layout
from tests.test_torch_vgg import dropout_masks
from tests.torch_mesh_ranks import draws_to_numpy, train_steps
from tests.torch_port_util import jax_detector, jax_step_draws, port_model, to_np, torch_config
from tests.util import synthetic_batch

torch.set_num_threads(1)

# (network, schedule, trunk trainable, learning rate): where a later phase
# or the next batch reads what Adam's sign noise moved, the rate is small
# (the module doc).
CASES = [("resnet50", "joint", True, 1e-5), ("resnet50", "alternating", False, 1e-5),
         ("vgg16", "joint", False, 1e-3), ("vgg16", "alternating", True, 1e-8)]
# Step keys whose photometric draws pick no Poisson noise (``_draws``).
KEYS = (40, 41, 43, 44)
IDS = [f"{n}-{s}-{'trainable' if t else 'frozen'}" for n, s, t, _ in CASES]


def _close(got, want, rtol=1e-4):
    atol = rtol * max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _close_moment(got, want, name):
    """An Adam moment: elementwise within 1e-4 relative, with a floor of
    1e-3 times the tensor's largest magnitude; ``name`` names the tensor."""
    atol = 1e-3 * max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=name)


def _batch(cfg, seed=3):
    """Two tiles, the second with a second box (the data indices hold
    different numbers of valid anchors and RoIs)."""
    batch = synthetic_batch(cfg, batch=2, seed=seed)
    batch["gt_boxes"][1, 1] = (30.0, 28.0, 52.0, 58.0)
    batch["gt_classes"][1, 1] = 1
    batch["gt_mask"][1, 1] = True
    rng = np.random.default_rng(seed + 2)
    img = rng.integers(0, 255, batch["image"].shape).astype(np.uint8)
    img[:, 44:] = 0  # a zero band: background for the photometric ops
    batch["image"] = img
    return batch


def _draws(cfg, key, batch, masks=None, train=True):
    draws = jax_step_draws(key, cfg, 2, batch["image"].shape, grey=True)
    d = draws.photometric
    # The Poisson sampler cannot be replayed (tests/test_torch_augment.py).
    assert not (train and ((d.noise_coin < 0.5) & (d.noise_pick == 2)).any()), key
    draws.head_masks = masks
    return draws


def _jax_moments(opt_state):
    """{port name: (mu, nu)} of the leaves one optax adam owns."""
    adam = opt_state.inner_states["train"].inner_state[0]
    out = {}
    leaf = {"is_leaf": lambda x: isinstance(x, optax.MaskedNode)}
    for (path, mu), (_, nu) in zip(jax.tree_util.tree_flatten_with_path(adam.mu, **leaf)[0],
                                   jax.tree_util.tree_flatten_with_path(adam.nu, **leaf)[0]):
        if not isinstance(mu, optax.MaskedNode):
            out[_port_name(path)] = (_port_layout(mu), _port_layout(nu))
    return int(adam.count), out


def _jax_case(network, schedule, trainable, lr, key):
    """JAX's GSPMD step on the 2 x 2 mesh: (config, params before, batch
    stats, metrics, the new state gathered, the dropout masks or None)."""
    cfg, model, params, bstats = jax_detector(network, 0)
    cfg = dataclasses.replace(cfg, train_schedule=schedule)
    batch = _batch(cfg)
    mesh = make_mesh(4, model_parallel=2)
    make = (jsteps.make_alternating_train_step if schedule == "alternating"
            else jsteps.make_train_step)
    with mesh:
        state = create_train_state(model, cfg, jax.random.PRNGKey(0), learning_rate=lr,
                                   base_net_trainable=trainable, schedule=schedule)
        state = shard_train_state(state.replace(params=params), mesh)
        with dropout_masks() as rec:
            new, metrics = make(model, cfg, trunk_trainable=trainable)(
                state, jax.device_put(batch, batch_sharding(mesh)), key)
            metrics = jax.device_get(metrics)
            jax.effects_barrier()
        new = jax.device_get(new)
    masks = rec.pair() if network == "vgg16" else None
    return cfg, model, params, bstats, batch, metrics, new, masks


def _port_single(cfg, params, bstats, batch, draws, trainable, lr):
    """The port's single-device step's Adam state_dict, each Adam's with
    its parameters' names under "names"."""
    tcfg = torch_config(cfg)
    ts = tstate.create_train_state(tcfg, torch.Generator(), "cpu", learning_rate=lr,
                                   base_net_trainable=trainable,
                                   model=port_model(cfg, params, bstats).train())
    tsteps.make_step(ts, tcfg, trunk_trainable=trainable)(
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, draws)
    names = {id(p): n for n, p in ts.model.named_parameters()}
    out = ts.optimizer.state_dict()
    for sd, adam in zip([out] if len(ts.adams()) == 1 else [out["rpn"], out["det"]], ts.adams()):
        sd["names"] = [names[id(p)] for p in adam.params]
    return out


# The witness: the case whose mesh runs with each rank dividing by its own
# tiles' denominators (tests/torch_mesh_ranks.py, "fault").
WITNESS = IDS[0]


@pytest.fixture(scope="module")
def cases():
    """Each case's JAX result, the port's single device's Adam state and the
    port's mesh result, from one spawn of the ranks; under "witness" the
    single device's Adam state of :data:`WITNESS` and its faulty mesh's
    result."""
    jax_out, single, jobs = [], [], []
    for i, (network, schedule, trainable, lr) in enumerate(CASES):
        key = jax.random.PRNGKey(KEYS[i])
        out = _jax_case(network, schedule, trainable, lr, key)
        cfg, _, params, bstats, batch, _, _, masks = out
        state = {k: v.numpy() for k, v in port_model(cfg, params, bstats).state_dict().items()}
        draws = _draws(cfg, key, batch, masks)
        jobs.append({"cfg": torch_config(cfg).to_dict(), "state": state, "batch": batch,
                     "draws": [draws_to_numpy(draws)], "lr": lr, "trainable": trainable})
        single.append(_port_single(cfg, params, bstats, batch, draws, trainable, lr))
        jax_out.append(out)
    jobs.append({**jobs[IDS.index(WITNESS)], "fault": "mean_of_ratios"})
    port_out = launch(train_steps, 4, device_type="cpu", args=(2, jobs))
    out = dict(zip(IDS, zip(jax_out, single, port_out)))
    out["witness"] = (single[IDS.index(WITNESS)], port_out[-1])
    return out


def _next_losses(jax_case, port_model_sd):
    """The next batch's eval losses of JAX's and of the port's updated
    parameters (the port's gathered whole, on one device)."""
    cfg, model, _, bstats, batch, _, new, _ = jax_case
    key = jax.random.PRNGKey(99)
    _, want = jax.jit(lambda p: jsteps.compute_losses(model, cfg, p, bstats, batch, key, True))(
        new.params)
    tcfg = torch_config(cfg)
    tmodel = build_model(tcfg)
    tmodel.load_state_dict({k: torch.from_numpy(v) for k, v in port_model_sd.items()})
    with torch.no_grad():
        _, got = tsteps.compute_losses(tmodel.eval(), tcfg,
                                       {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
                                       _draws(cfg, key, batch, train=False),
                                       tsteps.step_constants(tcfg, "cpu"), True)
    return got, jax.device_get(want)


@pytest.mark.parametrize("case", IDS)
def test_mesh_step_matches_jax_gspmd_step(cases, case):
    """The step's metrics and the updated parameters (through the next
    batch's losses) against JAX's GSPMD step."""
    jax_case, _, got = cases[case]
    cfg, _, params, bstats, _, want_m, _, _ = jax_case
    (got_m,) = got["metrics"]
    for k in tsteps.METRIC_KEYS:
        w, g = float(want_m[k]), got_m[k]
        if cfg.train_schedule == "alternating":
            assert abs(g - w) <= 5e-6 * max(1.0, abs(w)), (k, g, w)
        else:
            assert abs(g - w) <= 1e-4 * max(abs(w), 1e-6), (k, g, w)
    assert float(want_m["loss_detector_cls"]) > 0 and float(want_m["loss_rpn_regr"]) > 0
    assert len(got["shard_dims"]) == (13 if cfg.network == "resnet50" else 3)

    got_next, want_next = _next_losses(jax_case, got["model"])
    for k in tsteps.METRIC_KEYS:
        _close(float(got_next[k]), float(want_next[k]))
    before = state_dict_from_flax(params, bstats)
    moved = {n for n, v in got["model"].items() if (v != before[n].numpy()).any()}
    assert {"head.fc1.weight" if cfg.network == "vgg16" else "head.s5a.conv2a.weight",
            "rpn_head.rpn_conv1.weight"} <= moved
    assert any(n.startswith("trunk.") for n in moved) == CASES[IDS.index(case)][2]


@pytest.mark.parametrize("case", IDS)
def test_mesh_adam_moments_match_the_single_device(cases, case):
    """Adam's step counts and moments, the split ones gathered whole: the
    port's single device's on the same inputs, and the count JAX's."""
    jax_case, single, got = cases[case]
    new = jax_case[6]
    alternating = jax_case[0].train_schedule == "alternating"
    for phase in ("rpn", "det") if alternating else (None,):
        want = single if phase is None else single[phase]
        port = got["optimizer"] if phase is None else got["optimizer"][phase]
        count, _ = _jax_moments(new.opt_state if phase is None else new.opt_state[phase])
        assert int(port["count"]) == int(want["count"]) == count == 1
        assert port["n_params"] == want["n_params"]
        _moments_close(port, want)


def _moments_close(port, want):
    for key in ("exp_avg", "exp_avg_sq"):
        for name, m_got, m_want in zip(want["names"], port[key], want[key]):
            assert m_got.shape == tuple(m_want.shape), name
            _close_moment(m_got, to_np(m_want), f"{key} of {name}")


def test_mean_of_ratios_moments_fail_the_moment_limit(cases):
    """The witness: a mesh whose ranks each divide by their own tiles'
    denominators, then average the gradients, moves the moments beyond the
    limit the mesh is held to."""
    want, got = cases["witness"]
    with pytest.raises(AssertionError, match="exp_avg"):
        _moments_close(got["optimizer"], want)


@pytest.mark.parametrize("case", IDS)
def test_replicated_parameters_bit_equal_across_ranks(cases, case):
    assert cases[case][2]["equal"] == [{"data": True, "model": True}]
