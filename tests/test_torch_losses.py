"""radnet_torch's losses and detector accuracy against radnet_tpu's, on
packed targets of the training layout.

Each value is held twice: within 1e-6 relative of the port's own loss
evaluated in float64 (the port's float32 error), and within 5e-6 relative
of radnet_tpu's.  On these inputs XLA's float32 evaluation sits up to
2.2e-6 from the float64 value, where the port's sits within 2e-7, so 1e-6
against JAX would test JAX's rounding, not the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnet_torch import losses as tl
from radnet_tpu import losses as jl

torch.set_num_threads(1)

A, K, B, H, R = 6, 2, 3, 5, 7


def _close(fn, t_args, j_args):
    got = float(getattr(tl, fn)(*t_args))
    exact = float(getattr(tl, fn)(*[a.double() if isinstance(a, torch.Tensor) else a
                                    for a in t_args]))
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, float(getattr(jl, fn)(*j_args)), rtol=5e-6, atol=0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    valid = (rng.random((B, H, H, A)) < 0.4).astype(np.float32)
    overlap = (rng.random((B, H, H, A)) < 0.3).astype(np.float32)
    y_rpn_cls = np.concatenate([valid, overlap], -1)
    y_rpn_regr = np.concatenate([np.repeat(overlap, 4, -1),
                                 rng.normal(0, 2, (B, H, H, 4 * A)).astype(np.float32)], -1)
    rpn_cls = rng.random((B, H, H, A)).astype(np.float32)
    rpn_cls[0, 0, 0, :2] = (0.0, 1.0)  # the clip at 1e-7 and 1 - 1e-7
    rpn_regr = rng.normal(0, 2, (B, H, H, 4 * A)).astype(np.float32)
    cls_id = rng.integers(0, K + 1, (B, R))
    y_class = np.eye(K + 1, dtype=np.float32)[cls_id]
    labels = np.repeat(np.eye(K + 1, dtype=np.float32)[cls_id][..., :K], 4, -1)
    y_regr = np.concatenate([labels, labels * rng.normal(0, 3, (B, R, 4 * K))], -1).astype(np.float32)
    logits = rng.normal(0, 2, (B, R, K + 1))
    det_cls = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    det_regr = rng.normal(0, 3, (B, R, 4 * K)).astype(np.float32)
    roi_mask = np.ones((B, R), np.float32)
    roi_mask[1] = 0.0
    return dict(y_rpn_cls=y_rpn_cls, y_rpn_regr=y_rpn_regr, rpn_cls=rpn_cls, rpn_regr=rpn_regr,
                y_class=y_class, y_regr=y_regr, det_cls=det_cls, det_regr=det_regr,
                roi_mask=roi_mask)


def _both(d, *names):
    return [torch.from_numpy(d[n]) for n in names], [jnp.asarray(d[n]) for n in names]


def test_rpn_losses(data):
    t, j = _both(data, "y_rpn_cls", "rpn_cls")
    _close("rpn_loss_cls", t + [A], j + [A])
    t, j = _both(data, "y_rpn_regr", "rpn_regr")
    _close("rpn_loss_regr", t + [A], j + [A])


@pytest.mark.parametrize("masked", [True, False])
def test_detector_losses_and_accuracy(data, masked):
    t, j = _both(data, "y_class", "det_cls", "roi_mask")
    tm, jm = (t[2], j[2]) if masked else (None, None)
    _close("class_loss_cls", [t[0], t[1], tm], [j[0], j[1], jm])
    _close("detector_accuracy", [t[0], t[1], tm], [j[0], j[1], jm])
    t, j = _both(data, "y_regr", "det_regr")
    _close("class_loss_regr", [t[0], t[1], K, tm], [j[0], j[1], K, jm])


def test_losses_are_zero_without_targets(data):
    y = torch.zeros_like(torch.from_numpy(data["y_rpn_regr"]))
    assert float(tl.rpn_loss_regr(y, torch.from_numpy(data["rpn_regr"]), A)) == 0.0
    assert float(tl.rpn_loss_cls(torch.zeros(B, H, H, 2 * A), torch.from_numpy(data["rpn_cls"]), A)) == 0.0


@pytest.mark.parametrize("fn", ["rpn_loss_cls", "class_loss_cls"])
def test_gradient_at_the_clip_bounds_matches_jax(data, fn):
    """Probabilities exactly at a clip bound (a saturated sigmoid or softmax)
    pass half their gradient, as jnp.clip's do (Tensor.clamp passes all of
    it): within 1e-5 relative, as the gradient 1 / (1 - p) at p = 1 - 1e-7
    is 8e6 times float32's rounding of 1 - p."""
    import jax

    d = dict(data)
    if fn == "rpn_loss_cls":
        p = d["rpn_cls"].copy()
        p[0, 0, 0, :4] = (1e-7, np.float32(1.0 - 1e-7), 1.0, 0.0)
        p[1, 1, 1, :] = np.float32(1.0 - 1e-7)
        t_args, j_args = _both(dict(d, rpn_cls=p), "y_rpn_cls", "rpn_cls")
        extra = (A,)
    else:
        p = d["det_cls"].copy()
        p[0, :3] = np.eye(K + 1, dtype=np.float32)[:3]  # exactly 0 and 1
        p[2, 0] = (1e-7, 0.5, 0.5)
        t_args, j_args = _both(dict(d, det_cls=p), "y_class", "det_cls")
        extra = ()
    pred = t_args[1].clone().requires_grad_(True)
    getattr(tl, fn)(t_args[0], pred, *extra).backward()
    want = np.asarray(jax.grad(lambda x: getattr(jl, fn)(j_args[0], x, *extra))(j_args[1]))
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(pred.grad.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
