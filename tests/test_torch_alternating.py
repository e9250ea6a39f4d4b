"""radnet_torch's alternating train step, its two Adam states and the VGG16
joint step against radnet_tpu's, at float32 on the tiny VGG16 config, with
JAX's random draws replayed into the port's StepDraws: the target and RoI
samples and the photometric draws (tests/torch_port_util.py), and the head's
dropout masks read out of flax's own Dropout layers during the JAX step
(tests/test_torch_vgg.py ``dropout_masks``).

Tolerances:
* the alternating step's losses within 5e-6 absolute (XLA's float32 sums
  sit up to 2.2e-6 from float64; ROADMAP Queue 3), 5e-6 relative above 1;
  the joint step's within 1e-4 relative, as tests/test_torch_train_step.py
  holds it;
* Adam's moments after the step within 1e-4 relative, with an absolute
  floor of 1e-4 times the tensor's largest magnitude: they are (1 - b1) g
  and (1 - b2) g^2, so they hold the two phases' gradients at the
  gradients' tolerance (tests/test_torch_train_step.py);
* parameters through the next batch's losses within 1e-4 relative: Adam's
  first update is lr * sign(g) for any gradient above eps, so an element
  whose gradient is float32 noise moves by up to 2 lr between the packages
  (the two-Adam-steps departure of ROADMAP Queue 3); the gated Adam itself
  is held against optax on identical gradients within 1e-7.

With a trainable trunk the detector phase reads the trunk after the RPN
phase's Adam update, so the sign noise above reaches its losses and
gradients in proportion to the learning rate (at 1e-3 the detector's class
loss differs by 6e-6 relative and a moment by 3.5%; at 1e-5 by 5e-8 and
1.2e-5).  That case steps at LR_TRAINABLE = 1e-5.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from radnet_torch.engine import checkpoint as tckpt
from radnet_torch.engine import steps as tsteps
from radnet_torch.engine import train_state as tstate
from radnet_torch.models.bridge import state_dict_from_flax
from radnet_tpu.engine import steps as jsteps
from radnet_tpu.engine.train_state import create_train_state, make_optimizer, make_phase_optimizer
from tests.test_torch_vgg import dropout_masks
from tests.torch_port_util import jax_step_draws, jax_vgg, port_model, to_np, torch_config
from tests.util import synthetic_batch

torch.set_num_threads(1)

LR = 1e-3
LR_TRAINABLE = 1e-5
PHASES = ("rpn", "det")


def _close(got, want, rtol=1e-4):
    atol = rtol * max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _batch(cfg, seed=3, empty=False):
    batch = synthetic_batch(cfg, batch=2, seed=seed)
    rng = np.random.default_rng(seed + 2)
    img = rng.integers(0, 255, batch["image"].shape).astype(np.uint8)
    img[:, 40:] = 0  # a zero band: background for the photometric ops
    batch["image"] = img
    if empty:  # no ground truth, so no RoI is valid
        batch["gt_mask"][:] = False
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_setup():
    cfg, model, params, bstats = jax_vgg(0)
    return dataclasses.replace(cfg, train_schedule="alternating"), model, params, bstats


_JAX_STATES = {}


def _jax_state(jax_setup, trainable, schedule="alternating", lr=LR):
    cfg, model, params, _ = jax_setup
    key = (trainable, schedule, lr)
    if key not in _JAX_STATES:
        state = create_train_state(model, cfg, jax.random.PRNGKey(0), learning_rate=lr,
                                   base_net_trainable=trainable, schedule=schedule)
        _JAX_STATES[key] = state.replace(params=params)
    return _JAX_STATES[key]


def _port_state(jax_setup, trainable, schedule="alternating", lr=LR):
    cfg, _, params, bstats = jax_setup
    tcfg = torch_config(cfg)
    tcfg.train_schedule = schedule
    state = tstate.create_train_state(tcfg, torch.Generator(), "cpu", learning_rate=lr,
                                      base_net_trainable=trainable,
                                      model=port_model(cfg, params, bstats).train())
    return tcfg, state


def _draws(cfg, key, batch, masks=None, train=True):
    """JAX's draws of step ``key``.  A train step's key must draw no Poisson
    noise: that sampler cannot be replayed (tests/test_torch_augment.py
    holds it by its invariants)."""
    draws = jax_step_draws(key, cfg, 2, batch["image"].shape, grey=True)
    d = draws.photometric
    assert not (train and ((d.noise_coin < 0.5) & (d.noise_pick == 2)).any()), key
    draws.head_masks = masks
    return draws


def _port_name(path) -> str:
    keys = [p.key for p in path if hasattr(p, "key")]
    leaf = {"kernel": "weight", "bias": "bias"}[keys[-1]]
    return ".".join([{"rpn": "rpn_head"}.get(keys[0], keys[0])] + keys[1:-1] + [leaf])


def _port_layout(a):
    a = np.asarray(a)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T if a.ndim == 2 else a


def _jax_adam(opt_state):
    """(count, {port name: (mu, nu)}) of the leaves a phase's Adam owns."""
    adam = opt_state.inner_states["train"].inner_state[0]
    out = {}
    for (path, mu), (_, nu) in zip(
            jax.tree_util.tree_flatten_with_path(adam.mu, is_leaf=lambda x: isinstance(x, optax.MaskedNode))[0],
            jax.tree_util.tree_flatten_with_path(adam.nu, is_leaf=lambda x: isinstance(x, optax.MaskedNode))[0]):
        if not isinstance(mu, optax.MaskedNode):
            out[_port_name(path)] = (_port_layout(mu), _port_layout(nu))
    return int(adam.count), out


def _port_adam(state, phase):
    opt = getattr(state.optimizer, phase)
    names = {id(p): n for n, p in state.model.named_parameters()}
    return int(opt.count), {names[id(p)]: (to_np(m), to_np(v))
                            for p, m, v in zip(opt.params, opt.exp_avg, opt.exp_avg_sq)}


def _jax_eval_losses(jax_setup, params, batch, key):
    cfg, model, _, bstats = jax_setup
    _, metrics = jax.jit(lambda p: jsteps.compute_losses(model, cfg, p, bstats, batch, key, True))(params)
    return jax.device_get(metrics)


def _port_eval_losses(tcfg, state, batch, key, cfg):
    with torch.no_grad():
        return tsteps.compute_losses(state.model, tcfg, _torch_batch(batch),
                                     _draws(cfg, key, batch, train=False),
                                     tsteps.step_constants(tcfg, "cpu"), True)[1]


@pytest.mark.parametrize("trainable", [False, True], ids=["trunk_frozen", "trunk_trainable"])
def test_alternating_step_matches_jax(jax_setup, trainable):
    cfg, model, params, bstats = jax_setup
    batch = _batch(cfg)
    key = jax.random.PRNGKey(11)
    lr = LR_TRAINABLE if trainable else LR
    jstate = _jax_state(jax_setup, trainable, lr=lr)
    step = jsteps.make_alternating_train_step(model, cfg, trunk_trainable=trainable)
    with dropout_masks() as rec:
        new_jstate, want_m = step(jstate, batch, key)
        want_m = jax.device_get(want_m)
        jax.effects_barrier()
    masks = rec.pair()
    assert masks[0].shape == (2 * cfg.n_rois, cfg.vgg_fc_dim)

    tcfg, ts = _port_state(jax_setup, trainable, lr=lr)
    got_m = tsteps.make_alternating_train_step(ts, tcfg, trunk_trainable=trainable)(
        _torch_batch(batch), _draws(cfg, key, batch, masks))
    assert ts.step == 1
    for k in tsteps.METRIC_KEYS:
        assert abs(float(got_m[k]) - float(want_m[k])) <= 5e-6 * max(1.0, abs(float(want_m[k]))), k
    assert float(want_m["loss_detector_cls"]) > 0 and float(want_m["loss_rpn_regr"]) > 0

    for phase in PHASES:
        want_count, want = _jax_adam(new_jstate.opt_state[phase])
        got_count, got = _port_adam(ts, phase)
        assert got_count == want_count == 1, phase
        assert got.keys() == want.keys(), phase  # each phase owns what JAX's owns
        for name, (m, v) in want.items():
            _close(got[name][0], m)
            _close(got[name][1], v)
    n_trunk = sum(n.startswith("trunk.") for n in _port_adam(ts, "det")[1])
    assert n_trunk == (18 if trainable else 0)  # blocks 3-5, weights and biases

    want_next = _jax_eval_losses(jax_setup, new_jstate.params, batch, jax.random.PRNGKey(12))
    got_next = _port_eval_losses(tcfg, ts, batch, jax.random.PRNGKey(12), cfg)
    for k in tsteps.METRIC_KEYS:
        _close(float(got_next[k]), float(want_next[k]))
    before = state_dict_from_flax(params, bstats)
    moved = {n for n, p in ts.model.named_parameters() if (to_np(p) != before[n].numpy()).any()}
    assert {"rpn_head.rpn_conv1.weight", "head.fc1.weight"} <= moved
    assert not any(n.startswith("trunk.block1") for n in moved)
    assert any(n.startswith("trunk.") for n in moved) == trainable


def test_phase_states_own_what_jax_owns(jax_setup):
    """Before any step: the RPN state holds no detector-head moments and the
    detector state no RPN-head moments, on the leaves JAX's masks keep."""
    for trainable in (False, True):
        jstate = _jax_state(jax_setup, trainable)
        _, ts = _port_state(jax_setup, trainable)
        for phase in PHASES:
            want = set(_jax_adam(jstate.opt_state[phase])[1])
            got = set(_port_adam(ts, phase)[1])
            assert got == want, (trainable, phase)
            other = "head." if phase == "rpn" else "rpn_head."
            assert not any(n.startswith(other) for n in got)
            assert any(n.startswith("rpn_head." if phase == "rpn" else "head.") for n in got)


def test_no_valid_roi_leaves_head_and_det_adam_unchanged(jax_setup):
    """A step on a batch without ground truth after one normal step: the RPN
    phase moves, the detector head and the detector Adam state (count,
    moments) stay bit for bit, in both packages."""
    cfg, model, _, _ = jax_setup
    full, empty = _batch(cfg), _batch(cfg, empty=True)
    k1, k2 = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    step = jsteps.make_alternating_train_step(model, cfg)
    with dropout_masks() as rec:
        js1, _ = step(_jax_state(jax_setup, False), full, k1)
        js2, jm2 = step(js1, empty, k2)
        jax.effects_barrier()
    masks1, masks2 = rec.pair(0), rec.pair(1)
    assert int(js2.opt_state["det"].inner_states["train"].inner_state[0].count) == 1
    assert int(js2.opt_state["rpn"].inner_states["train"].inner_state[0].count) == 2

    tcfg, ts = _port_state(jax_setup, False)
    tstep = tsteps.make_alternating_train_step(ts, tcfg)
    tstep(_torch_batch(full), _draws(cfg, k1, full, masks1))
    head = {n: p.detach().clone() for n, p in ts.model.named_parameters() if n.startswith("head.")}
    det = ts.optimizer.det
    det_state = [t.clone() for t in [det.count] + det.exp_avg + det.exp_avg_sq]
    rpn_before = ts.model.rpn_head.rpn_conv1.weight.detach().clone()
    got = tstep(_torch_batch(empty), _draws(cfg, k2, empty, masks2))
    assert float(got["loss_detector_cls"]) == float(jm2["loss_detector_cls"]) == 0.0
    assert ts.step == 2
    for n, p in ts.model.named_parameters():
        if n.startswith("head."):
            assert torch.equal(p, head[n]), n
    for a, b in zip([det.count] + det.exp_avg + det.exp_avg_sq, det_state):
        assert torch.equal(a, b)
    assert int(ts.optimizer.rpn.count) == 2 and int(det.count) == 1
    assert not torch.equal(ts.model.rpn_head.rpn_conv1.weight, rpn_before)


@pytest.mark.parametrize("gate", [True, False], ids=["open", "shut"])
def test_gated_adam_matches_optax(jax_setup, gate):
    """The detector phase's Adam against optax's masked adam on identical
    gradients, two updates (the second gated): parameters within 1e-7
    absolute, moments within 1e-5 relative; shut,
    the second update leaves parameters and state as the first left them."""
    cfg, _, params, bstats = jax_setup
    tx = make_phase_optimizer(params, cfg, LR, True, "det")
    opt_state = tx.init(params)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    _, ts = _port_state(jax_setup, True)
    det = ts.optimizer.det
    rng = np.random.default_rng(7)
    jparams = params
    for i in range(2):
        grads = jax.tree_util.tree_map(lambda p: rng.normal(0, 1e-3, np.shape(p)).astype(np.float32), params)
        g_sd = state_dict_from_flax(grads, bstats)
        for n, p in ts.model.named_parameters():
            p.grad = g_sd[n].clone()
        if i == 0 or gate:
            jparams, opt_state = jax.device_get(update(grads, opt_state, jparams))
        det.step(gate=torch.tensor(i == 0 or gate))
    want = state_dict_from_flax(jparams, bstats)
    owned = {id(p) for p in det.params}
    for n, p in ts.model.named_parameters():
        if id(p) in owned:
            np.testing.assert_allclose(to_np(p), want[n].numpy(), rtol=0, atol=1e-7, err_msg=n)
    count, moments = _jax_adam(opt_state)
    assert int(det.count) == count == (2 if gate else 1)
    got = _port_adam(ts, "det")[1]
    for n, (m, v) in moments.items():
        # XLA may fuse the moments' multiply-adds: a few float32 roundings,
        # relative to the tensor's largest where two terms cancel.
        _close(got[n][0], m, rtol=1e-5)
        _close(got[n][1], v, rtol=1e-5)


def test_joint_vgg16_step_matches_jax(jax_setup):
    """The joint step with the head's dropout: losses within 1e-4 relative
    (tests/test_torch_train_step.py's tolerance for the joint step), then
    parameters through the next batch's losses."""
    cfg, model, params, bstats = jax_setup
    batch = _batch(cfg, seed=4)
    key = jax.random.PRNGKey(32)
    jstate = _jax_state(jax_setup, False, schedule="joint")
    with dropout_masks() as rec:
        new_jstate, want_m = jsteps.make_train_step(model, cfg)(jstate, batch, key)
        want_m = jax.device_get(want_m)
        jax.effects_barrier()
    masks = rec.pair()

    tcfg, ts = _port_state(jax_setup, False, schedule="joint")
    assert isinstance(ts.optimizer, tstate.GatedAdam)
    got_m = tsteps.make_step(ts, tcfg)(_torch_batch(batch), _draws(cfg, key, batch, masks))
    for k in tsteps.METRIC_KEYS:
        _close(float(got_m[k]), float(want_m[k]))
    want_next = _jax_eval_losses(jax_setup, new_jstate.params, batch, jax.random.PRNGKey(33))
    got_next = _port_eval_losses(tcfg, ts, batch, jax.random.PRNGKey(33), cfg)
    for k in tsteps.METRIC_KEYS:
        _close(float(got_next[k]), float(want_next[k]))


def test_draw_step_draws_vgg16_masks(jax_setup):
    cfg = jax_setup[0]
    tcfg = torch_config(cfg)
    d = tsteps.draw_step(torch.Generator().manual_seed(0), tcfg, 2, "cpu")
    m1, m2 = d.head_masks
    assert m1.dtype == torch.bool and m1.shape == (2 * cfg.n_rois, cfg.vgg_fc_dim)
    assert 0.4 < float(m1.float().mean()) < 0.6 and not torch.equal(m1, m2)
    tcfg.network = "resnet50"
    assert tsteps.draw_step(torch.Generator().manual_seed(0), tcfg, 2, "cpu").head_masks is None


def test_checkpoint_round_trip_of_both_adam_states(jax_setup, tmp_path):
    cfg, _, _, _ = jax_setup
    batch = _batch(cfg)
    tcfg, ts = _port_state(jax_setup, True)
    step = tsteps.make_alternating_train_step(ts, tcfg, trunk_trainable=True)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        step(_torch_batch(batch), tsteps.draw_step(gen, tcfg, 2, "cpu"))
    tree = tckpt.snapshot(ts, 1.5)
    assert set(tree["optimizer"]) == {"rpn", "det"}
    tckpt.save_checkpoint_tree(str(tmp_path / "ckpt"), tree)

    _, fresh = _port_state(jax_setup, True)
    fresh.optimizer.rpn.lr = fresh.optimizer.det.lr = 2e-5
    fresh, best = tckpt.restore_checkpoint(str(tmp_path / "ckpt"), fresh)
    assert best == 1.5 and fresh.step == 2
    for phase in PHASES:
        a, b = getattr(ts.optimizer, phase), getattr(fresh.optimizer, phase)
        assert int(b.count) == int(a.count) == 2 and b.lr == 2e-5
        for x, y in zip(a.exp_avg + a.exp_avg_sq, b.exp_avg + b.exp_avg_sq):
            assert torch.equal(x, y)
    for (n, p), q in zip(ts.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(p, q), n

    _, frozen = _port_state(jax_setup, False)  # another partition
    with pytest.raises(ValueError):
        tckpt.restore_checkpoint(str(tmp_path / "ckpt"), frozen)
    _, joint = _port_state(jax_setup, True, schedule="joint")  # another schedule
    with pytest.raises(ValueError):
        tckpt.restore_checkpoint(str(tmp_path / "ckpt"), joint)
