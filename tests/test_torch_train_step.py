"""radnet_torch's joint train step against radnet_tpu's, at float32 on the
tiny ResNet50 config, with JAX's random draws replayed into the port's
StepDraws (tests/torch_port_util.py).

Tolerances: losses and every parameter gradient within 1e-4 relative (with
an absolute floor of 1e-4 times the tensor's largest magnitude), the
accumulation error of two frameworks summing convolutions in different
orders.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from radnet_torch.engine import steps as tsteps
from radnet_torch.engine import train_state as tstate
from radnet_torch.models.bridge import state_dict_from_flax
from radnet_tpu.engine import steps as jsteps
from radnet_tpu.engine.train_state import make_optimizer, trainability_labels
from tests.torch_port_util import jax_resnet, jax_step_draws, port_model, to_np, torch_config
from tests.util import synthetic_batch

torch.set_num_threads(1)

LR = 1e-3


def _close(got, want, rtol=1e-4):
    atol = rtol * max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def setup():
    cfg, model, params, bstats = jax_resnet(0)
    batch = synthetic_batch(cfg, batch=2, seed=3)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, batch["image"].shape).astype(np.uint8)
    img[:, 40:, :, :] = 0  # a zero band: background for the photometric ops
    batch["image"] = img
    return cfg, model, params, bstats, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


_JAX_LOSS_AND_GRADS = {}


def _jax_adam(tx):
    """One jitted optax update: (grads, opt_state, params) -> (params, opt_state)."""
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    return jax.jit(update)


def _jax_loss_and_grads(cfg, model, params, bstats, batch, key, frozen):
    fn = _JAX_LOSS_AND_GRADS.get(frozen)
    if fn is None:
        def loss_fn(p, k):
            return jsteps.compute_losses(model, cfg, p, bstats, batch, k, False,
                                         trunk_frozen=frozen)

        fn = _JAX_LOSS_AND_GRADS[frozen] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, metrics), grads = fn(params, key)
    return jax.device_get(metrics), jax.device_get(grads)


@pytest.mark.parametrize("frozen", [True, False], ids=["trunk_frozen", "trunk_trainable"])
def test_losses_and_gradients_match_jax(setup, frozen):
    cfg, model, params, bstats, batch = setup
    key = jax.random.PRNGKey(11)
    want_m, want_g = _jax_loss_and_grads(cfg, model, params, bstats, batch, key, frozen)

    tcfg = torch_config(cfg)
    tmodel = port_model(cfg, params, bstats)
    for p in tmodel.parameters():
        p.requires_grad_(True)
    draws = jax_step_draws(key, cfg, 2, batch["image"].shape, grey=True)
    consts = tsteps.step_constants(tcfg, "cpu")
    total, metrics = tsteps.compute_losses(tmodel, tcfg, _torch_batch(batch), draws, consts,
                                           False, trunk_frozen=frozen)
    total.backward()
    for k in tsteps.METRIC_KEYS:
        _close(float(metrics[k]), float(want_m[k]))
    assert float(want_m["loss_detector_cls"]) > 0 and float(want_m["loss_rpn_regr"]) > 0

    want_sd = state_dict_from_flax(want_g, jax.device_get(bstats))
    n_trunk_grads = 0
    for name, p in tmodel.named_parameters():
        want = want_sd[name].numpy()
        got = np.zeros_like(want) if p.grad is None else to_np(p.grad)
        if frozen and name.startswith("trunk."):
            assert p.grad is None or not got.any(), name
            assert not want.any(), name
            continue
        _close(got, want)
        n_trunk_grads += name.startswith("trunk.") and bool(np.abs(want).max() > 0)
    if not frozen:  # the detector loss reaches the trunk through the RoI pool
        assert n_trunk_grads > 50


def test_two_adam_steps_match_jax(setup):
    """Two joint steps (trunk frozen) in each package, then a third step's
    losses in each: within 1e-4 relative.  Parameters are compared through
    the losses because Adam's update, lr * m / sqrt(v), turns gradient
    elements that sit at float32 noise into moves of order lr; Adam itself
    is held on identical gradients below."""
    cfg, model, params, bstats, batch = setup
    tx = make_optimizer(params, cfg, LR, False)
    opt_state = tx.init(params)
    keys = [jax.random.PRNGKey(21), jax.random.PRNGKey(22), jax.random.PRNGKey(23)]
    jparams, adam = params, _jax_adam(tx)
    for k in keys[:2]:
        _, grads = _jax_loss_and_grads(cfg, model, jparams, bstats, batch, k, True)
        jparams, opt_state = jax.device_get(adam(grads, opt_state, jparams))
    want_m, _ = _jax_loss_and_grads(cfg, model, jparams, bstats, batch, keys[2], True)

    tcfg = torch_config(cfg)
    ts = tstate.create_train_state(tcfg, torch.Generator(), "cpu", learning_rate=LR,
                                   base_net_trainable=False,
                                   model=port_model(cfg, params, bstats).train())
    tstep = tsteps.make_train_step(ts, tcfg, trunk_trainable=False)
    for k in keys[:2]:
        tstep(_torch_batch(batch), jax_step_draws(k, cfg, 2, batch["image"].shape, grey=True))
    assert ts.step == 2
    before = state_dict_from_flax(params, bstats)
    moved = sum(bool((to_np(p) != before[n].numpy()).any()) for n, p in ts.model.named_parameters())
    assert moved > 20
    with torch.no_grad():
        _, got_m = tsteps.compute_losses(
            ts.model, tcfg, _torch_batch(batch),
            jax_step_draws(keys[2], cfg, 2, batch["image"].shape, grey=True),
            tsteps.step_constants(tcfg, "cpu"), False, trunk_frozen=True)
    for k in tsteps.METRIC_KEYS:
        _close(float(got_m[k]), float(want_m[k]))


def test_adam_update_matches_optax(setup):
    """GatedAdam over the trainable set against optax's masked adam,
    on identical gradients, two updates: within 1e-7 absolute."""
    cfg, model, params, bstats, batch = setup
    tx = make_optimizer(params, cfg, LR, True)
    opt_state = tx.init(params)
    tmodel = port_model(cfg, params, bstats)
    opt = tstate.GatedAdam(tstate.set_trainable(tmodel, "resnet50", True), LR)
    jparams, adam = params, _jax_adam(tx)
    for i in range(2):
        _, grads = _jax_loss_and_grads(cfg, model, params, bstats, batch,
                                       jax.random.PRNGKey(30 + i), False)
        jparams, opt_state = jax.device_get(adam(grads, opt_state, jparams))
        g_sd = state_dict_from_flax(grads, bstats)
        for n, p in tmodel.named_parameters():
            p.grad = g_sd[n].clone() if p.requires_grad else None
        opt.step()
    want = state_dict_from_flax(jparams, bstats)
    frozen = {n for n, lab in tstate.trainability_labels(tmodel, "resnet50", True).items()
              if lab == "frozen"}
    assert frozen and all(n.startswith(("trunk.conv1", "trunk.s2")) for n in frozen)
    for n, p in tmodel.named_parameters():
        np.testing.assert_allclose(to_np(p), want[n].numpy(), rtol=0, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("trainable", [False, True])
def test_trainability_partition_matches_jax(setup, trainable):
    cfg, _, params, bstats, _ = setup
    labels = trainability_labels(params, "resnet50", trainable)
    as_float = jax.tree_util.tree_map(lambda lab: np.float32(lab == "train"), labels)
    # The bridge maps the label tree's names and layouts like the weights'.
    want = {k: bool(v.reshape(-1)[0]) for k, v in
            state_dict_from_flax(jax.tree_util.tree_map(lambda p, f: np.full(np.shape(p), f, np.float32),
                                                        params, as_float), bstats).items()}
    tmodel = port_model(cfg, params, bstats)
    got = tstate.trainability_labels(tmodel, "resnet50", trainable)
    assert set(got) == {n for n, _ in tmodel.named_parameters()}
    for name, lab in got.items():
        assert (lab == "train") == want[name], name
    trained = tstate.set_trainable(tmodel, "resnet50", trainable)
    assert len(trained) == sum(want[n] for n in got)
    assert any(n.startswith("trunk.s3") for n in got if got[n] == "train") == trainable


def test_alternating_schedule_raises_naming_roadmap(setup):
    """The alternating schedule is ported (it raised, naming ROADMAP Queue 1
    item 12, before): its state holds the two phase Adam states; a schedule
    that does not exist raises, naming the two that do."""
    cfg = torch_config(setup[0])
    cfg.train_schedule = "alternating"
    state = tstate.create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    assert isinstance(state.optimizer, tstate.PhaseAdams)
    names = {id(p): n for n, p in state.model.named_parameters()}
    rpn = {names[id(p)] for p in state.optimizer.rpn.params}
    det = {names[id(p)] for p in state.optimizer.det.params}
    assert rpn == {n for n in names.values() if n.startswith("rpn_head.")}  # trunk frozen
    assert det == {n for n in names.values() if n.startswith("head.")}
    cfg.train_schedule = "cyclic"
    with pytest.raises(ValueError, match="alternating"):
        tstate.create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")


def test_eval_step_is_deterministic_and_updates_nothing(setup):
    cfg, _, params, bstats, batch = setup
    tcfg = torch_config(cfg)
    ts = tstate.create_train_state(tcfg, torch.Generator(), "cpu",
                                   model=port_model(cfg, params, bstats))
    before = {k: v.clone() for k, v in ts.model.state_dict().items()}
    ev = tsteps.make_eval_step(ts, tcfg)
    draws = tsteps.draw_step(torch.Generator().manual_seed(0), tcfg, 2, "cpu")
    m1 = ev(_torch_batch(batch), draws)
    m2 = ev(_torch_batch(batch), draws)
    assert all(float(m1[k]) == float(m2[k]) for k in tsteps.METRIC_KEYS)
    assert all(torch.equal(before[k], v) for k, v in ts.model.state_dict().items())
