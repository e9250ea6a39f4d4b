"""radnet_torch's VGG16 trunk, dense RoI head and stride-1 RoI heads against
radnet_tpu's on the same weights (tiny VGG16 config: canvas 64, a 4 x 4
feature map, ``vgg_fc_dim`` 256), and the weight bridge's VGG16 keys.

Tolerances:
* float32: 1e-5 relative, with an absolute floor of 1e-5 times the
  tensor's largest magnitude: the two frameworks sum the 13 convolutions
  and the dense layers in different orders;
* bf16: the criterion of tests/test_pallas_stem.py: the port's bf16 output
  within max(0.02, 2x) of the distance between the JAX package's bf16 and
  float32 outputs, relative to magnitudes of at least 1/8 of the largest.

The head's dropout is an input of the port's head (the masks of a step's
StepDraws).  The masks are read out of flax's own ``Dropout`` in the JAX
run (``dropout_masks``): its random key is derived once, as flax does, and
the layer is applied to the activations and to ones with that key.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from radnet_torch.models import vgg
from radnet_torch.models.bridge import state_dict_from_flax
from radnet_torch.models.detector import build_model, init_weights
from radnet_tpu.models import vgg as jvgg
from radnet_tpu.models.detector import FasterRCNN
from tests.torch_port_util import jax_vgg, port_model, to_np, torch_config

torch.set_num_threads(1)


def _close(got, want, rtol=1e-5):
    atol = rtol * max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _bf16_close(got16, want16, want32):
    mag = np.maximum(np.abs(want32), np.abs(want32).max() / 8)
    rel_port = float((np.abs(got16 - want32) / mag).max())
    rel_jax = float((np.abs(want16 - want32) / mag).max())
    assert rel_port < max(0.02, 2.0 * rel_jax), (rel_port, rel_jax)


class dropout_masks:
    """A context in which every flax ``Dropout`` that is not deterministic
    records its keep mask under its module name (``Dropout_0``, ...), also
    from inside ``jax.jit`` (through ``jax.debug.callback``, so every later
    run of a program traced in the context records too, in call order)."""

    def __init__(self):
        self.masks = {}

    def _intercept(self, next_fun, args, kwargs, context):
        mod = context.module
        if not (isinstance(mod, nn.Dropout) and context.method_name == "__call__"
                and not mod.deterministic):
            return next_fun(*args, **kwargs)
        rng = mod.make_rng(mod.rng_collection)
        x = args[0]
        y = next_fun(x, rng=rng)
        keep = next_fun(jnp.ones_like(x), rng=rng) != 0

        def store(m, name=mod.name):
            self.masks.setdefault(name, []).append(np.asarray(m))

        jax.debug.callback(store, keep)
        return y

    def __enter__(self):
        self._ctx = nn.intercept_methods(self._intercept)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)

    def pair(self, call: int = 0):
        """The two masks of run ``call`` as the port's bool tensors, fc1's
        first."""
        assert sorted(self.masks) == ["Dropout_0", "Dropout_1"], sorted(self.masks)
        return tuple(torch.from_numpy(self.masks[k][call].copy()) for k in ("Dropout_0", "Dropout_1"))


def _models(dtype):
    cfg, model, params, bstats = jax_vgg(0, dtype=dtype)
    return cfg, model, {"params": params, "batch_stats": bstats}, port_model(cfg, params, bstats)


@pytest.fixture(scope="module")
def f32():
    return _models("float32")


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).normal(0.0, 60.0, (2, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def pooled():
    return np.random.default_rng(1).normal(0.0, 1.0, (6, 7, 7, 512)).astype(np.float32)


def test_bridge_roundtrip_names_and_layouts(f32):
    _, _, variables, tmodel = f32
    sd = tmodel.state_dict()
    params = variables["params"]
    assert not variables["batch_stats"]
    np.testing.assert_array_equal(sd["trunk.block5_conv3.weight"].numpy(),
                                  params["trunk"]["block5_conv3"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["head.fc1.weight"].numpy(), params["head"]["fc1"]["kernel"].T)
    np.testing.assert_array_equal(sd["head.fc2.bias"].numpy(), params["head"]["fc2"]["bias"])
    assert sd["head.fc1.weight"].shape == (256, 7 * 7 * 512)
    assert sum(k.startswith("trunk.") and k.endswith(".weight") for k in sd) == 13


@pytest.mark.parametrize("where", ["missing", "extra", "resnet_keys"])
def test_bridge_raises_on_a_key_mismatch(f32, where):
    _, _, variables, _ = f32
    params = copy.deepcopy(variables["params"])
    if where == "missing":
        del params["head"]["fc2"]["bias"]
    elif where == "extra":
        params["trunk"]["block5_conv4"] = {"bias": np.zeros(3, np.float32)}
    else:  # without block1_conv1 the trees read as a ResNet50's
        del params["trunk"]["block1_conv1"]
    with pytest.raises(KeyError):
        state_dict_from_flax(params, {})


def test_init_matches_the_jax_init_distribution():
    """lecun-normal fc1 / fc2 with zero bias, zero output layers: the JAX
    package's init, not the zero init of the ResNet50 head's dense layers."""
    cfg, _, params, _ = jax_vgg(0, decisive=False)
    tmodel = init_weights(build_model(torch_config(cfg)), torch.Generator().manual_seed(3))
    head = params["head"]
    for name in ("fc1", "fc2"):
        w = getattr(tmodel.head, name).weight.detach().numpy()
        np.testing.assert_allclose(w.std(), np.std(head[name]["kernel"]), rtol=0.05)
        assert np.abs(w).max() <= 2.0 * np.sqrt(1.0 / w.shape[1]) / 0.8796 + 1e-6
        assert not getattr(tmodel.head, name).bias.any()
    for name in ("dense_class", "dense_regress"):
        assert not getattr(tmodel.head, name).weight.any() and not np.any(head[name]["kernel"])


def _jax_features(model, variables, images):
    return np.asarray(model.apply(variables, jnp.asarray(images), method=FasterRCNN.features),
                      np.float32)


def test_trunk_and_rpn_match_float32(f32, images):
    _, model, variables, tmodel = f32
    fmap = model.apply(variables, jnp.asarray(images), method=FasterRCNN.features)
    want_cls, want_regr = model.apply(variables, fmap, method=FasterRCNN.rpn)
    with torch.no_grad():
        got = tmodel.features(torch.from_numpy(images))
        got_cls, got_regr = tmodel.rpn(got)
    assert got.shape == (2, 512, 4, 4) and got.is_contiguous(memory_format=torch.channels_last)
    _close(to_np(got.permute(0, 2, 3, 1)), np.asarray(fmap))
    _close(to_np(got_cls), np.asarray(want_cls))
    _close(to_np(got_regr), np.asarray(want_regr))


def test_trunk_matches_bf16(images):
    _, model16, variables, tmodel16 = _models("bfloat16")
    _, model32, _, _ = _models("float32")
    want16 = _jax_features(model16, variables, images)
    want32 = _jax_features(model32, variables, images)
    with torch.no_grad():
        got16 = to_np(tmodel16.features(torch.from_numpy(images)).permute(0, 2, 3, 1))
    _bf16_close(got16, want16, want32)


def _jax_head(variables, pooled, dtype, deterministic=True, rng=None):
    head = jvgg.VGG16RoIHead(n_classes=3, dtype=dtype, fc_dim=256)
    return head.apply({"params": variables["params"]["head"]}, jnp.asarray(pooled),
                      deterministic=deterministic, rngs=None if rng is None else {"dropout": rng})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_matches_deterministic(f32, pooled, dtype):
    _, _, variables, _ = f32
    tmodel = _models(dtype)[3]
    with torch.no_grad():
        got = [to_np(t) for t in tmodel.head(torch.from_numpy(pooled))]
    want = [np.asarray(t) for t in _jax_head(variables, pooled, jnp.dtype(dtype))]
    assert got[0].shape == (6, 3) and got[1].shape == (6, 8)
    if dtype == "float32":
        for g, w in zip(got, want):
            _close(g, w)
    else:
        want32 = [np.asarray(t) for t in _jax_head(variables, pooled, jnp.float32)]
        for g, w16, w32 in zip(got, want, want32):
            _bf16_close(g, w16, w32)


def test_head_with_dropout_matches_flax(f32, pooled):
    """The head with the masks flax drew (read out of its own Dropout layers):
    outputs and the gradient of a loss on them, float32."""
    _, _, variables, tmodel = f32
    hp = variables["params"]["head"]
    rng = jax.random.PRNGKey(4)

    def loss(p):
        cls, regr = jvgg.VGG16RoIHead(n_classes=3, fc_dim=256).apply(
            {"params": p}, jnp.asarray(pooled), deterministic=False, rngs={"dropout": rng})
        return jnp.sum(cls * jnp.arange(3.0)) + jnp.sum(regr ** 2), (cls, regr)

    with dropout_masks() as rec:
        (_, (want_cls, want_regr)), want_g = jax.value_and_grad(loss, has_aux=True)(hp)
    masks = rec.pair()
    assert masks[0].shape == (6, 256) and 0.4 < float(masks[0].float().mean()) < 0.6
    assert not torch.equal(masks[0], masks[1])
    plain = _jax_head(variables, pooled, jnp.float32)
    assert not np.allclose(np.asarray(plain[0]), np.asarray(want_cls))  # the masks matter

    cls, regr = tmodel.head(torch.from_numpy(pooled), masks)
    (cls * torch.arange(3.0)).sum().add((regr ** 2).sum()).backward()
    _close(to_np(cls), np.asarray(want_cls))
    _close(to_np(regr), np.asarray(want_regr))
    for name in ("fc1", "fc2", "dense_class"):
        _close(to_np(getattr(tmodel.head, name).weight.grad), np.asarray(want_g[name]["kernel"]).T,
               rtol=1e-4)
    tmodel.zero_grad(set_to_none=True)


def test_roi_heads_stride_1_match(f32, images):
    """Pooling at stride 1, P = 7, over the 512-channel map, then the head:
    the HWC flatten reaches fc1's columns in JAX's order."""
    _, model, variables, tmodel = f32
    fmap = model.apply(variables, jnp.asarray(images), method=FasterRCNN.features)
    rng = np.random.default_rng(1)
    xy = rng.integers(0, 4, (2, 5, 2)).astype(np.float32)
    wh = rng.integers(0, 4, (2, 5, 2)).astype(np.float32)  # w or h of 0 included
    rois = np.concatenate([xy, wh], -1)
    want_cls, want_regr = model.apply(variables, fmap, jnp.asarray(rois),
                                      method=FasterRCNN.roi_heads, deterministic=True)
    tfmap = torch.from_numpy(np.array(fmap)).permute(0, 3, 1, 2)
    assert (tmodel.pool_size, tmodel.pool_center_stride) == (vgg.POOL_SIZE, 1)
    with torch.no_grad():
        got_cls, got_regr = tmodel.roi_heads(tfmap, torch.from_numpy(rois))
    assert got_cls.shape == (2, 5, 3) and got_regr.shape == (2, 5, 8)
    _close(to_np(got_cls), np.asarray(want_cls))
    _close(to_np(got_regr), np.asarray(want_regr))
