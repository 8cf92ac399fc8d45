"""The in-repo layer library (models/layers.py): every layer against a plain
``jax.numpy``/``lax`` reference, the parameter scope's rules, and the
golden fixture — each preset at tiny widths must reproduce the logits
frozen in tests/fixtures/models.npz from the stored parameters."""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax

from chainer_speech_recognition.models.layers import (
    Conv, Dense, LayerNorm, Module)
from chainer_speech_recognition.models.presets import build_model

HERE = os.path.dirname(__file__)
sys.path.insert(0, os.path.join(HERE, "fixtures"))

from generate import MODEL_PRESETS, tiny_model_config  # noqa: E402

FIX = os.path.join(HERE, "fixtures", "models.npz")


def _x(*shape, seed=0):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                       jnp.float32)


def _tree(flat: dict) -> dict:
    out: dict = {}
    for key, val in flat.items():
        node = out
        *head, last = key.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = jnp.asarray(val)
    return out


@pytest.mark.parametrize("name", MODEL_PRESETS)
def test_preset_reproduces_golden_logits(name):
    fx = np.load(FIX)
    x, lens = jnp.asarray(fx["model_feats"]), jnp.asarray(fx["model_lens"])
    params = _tree({k[len(name) + 1:]: fx[k] for k in fx.files
                    if k.startswith(name + "/")})
    # the tree a fresh init makes has the stored paths and shapes
    fresh = build_model(tiny_model_config(name, "float32")).init(
        jax.random.key(0), x, lens)
    assert jax.tree.structure(fresh) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(fresh), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
    for dt in ("float32", "bfloat16"):
        model = build_model(tiny_model_config(name, dt))
        logits, olens = jax.jit(model.apply)(params, x, lens)
        np.testing.assert_array_equal(np.asarray(olens), fx[f"{name}#olens"])
        np.testing.assert_allclose(np.asarray(logits),
                                   fx[f"{name}#logits_{dt}"],
                                   atol=1e-5 if dt == "float32" else 1e-2,
                                   rtol=1e-5 if dt == "float32" else 1e-2,
                                   err_msg=dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_matches_matmul(dtype):
    x = _x(2, 5, 7)
    layer = Dense(4, dtype=jnp.dtype(dtype))
    p = layer.init(jax.random.key(1), x)
    k, b = p["params"]["kernel"], p["params"]["bias"]
    assert k.shape == (7, 4) and b.shape == (4,) and k.dtype == jnp.float32
    assert np.all(np.asarray(b) == 0)          # zeros init
    y = layer.apply(p, x)
    assert y.dtype == jnp.dtype(dtype)
    want = (x.astype(dtype) @ k.astype(dtype)) + b.astype(dtype)
    np.testing.assert_allclose(np.asarray(y, np.float32),
                               np.asarray(want, np.float32), rtol=1e-6)


@pytest.mark.parametrize("kind", ["strided2d", "depthwise_causal"])
def test_conv_matches_lax(kind):
    if kind == "strided2d":
        x = _x(2, 11, 9, 3)
        layer = Conv(5, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))
        dn, groups, pad, strides = ("NHWC", "HWIO", "NHWC"), 1, \
            ((1, 1), (1, 1)), (2, 2)
    else:
        x = _x(2, 10, 6)
        layer = Conv(6, (4,), padding=((3, 0),), feature_group_count=6)
        dn, groups, pad, strides = ("NWC", "WIO", "NWC"), 6, ((3, 0),), (1,)
    p = layer.init(jax.random.key(2), x)
    k = p["params"]["kernel"]
    assert k.shape[-2] == x.shape[-1] // groups
    p["params"]["bias"] = jnp.arange(k.shape[-1], dtype=jnp.float32)
    want = lax.conv_general_dilated(
        x, k, strides, pad, dimension_numbers=dn,
        feature_group_count=groups) + p["params"]["bias"]
    np.testing.assert_allclose(np.asarray(layer.apply(p, x)),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(in_dtype):
    x = (_x(3, 4, 16) * 3 + 1).astype(in_dtype)
    layer = LayerNorm(dtype=jnp.float32)
    p = layer.init(jax.random.key(3), x)
    p["params"]["scale"] = jnp.linspace(0.5, 2.0, 16)
    p["params"]["bias"] = jnp.linspace(-1.0, 1.0, 16)
    y = layer.apply(p, x)
    assert y.dtype == jnp.float32
    xf = np.asarray(x, np.float64)
    mu = xf.mean(-1, keepdims=True)
    var = xf.var(-1, keepdims=True)
    want = ((xf - mu) / np.sqrt(var + 1e-6) * np.asarray(p["params"]["scale"])
            + np.asarray(p["params"]["bias"]))
    np.testing.assert_allclose(np.asarray(y), want, atol=2e-5, rtol=1e-5)


class _Two(Module):
    """Two unnamed Dense calls, one named, and one parameter of its own."""

    def __call__(self, x):
        h = Dense(3)(x) + Dense(3)(x)
        w = self.param("w", jax.nn.initializers.ones, (3,))
        return Dense(2, name="head")(h * w)


def test_scope_names_and_tree():
    x = _x(2, 4)
    p = _Two().init(jax.random.key(0), x)["params"]
    assert sorted(p) == ["Dense_0", "Dense_1", "head", "w"]
    assert p["Dense_0"]["kernel"].shape == (4, 3)
    # per-path init keys: the two unnamed layers are not copies
    assert not np.allclose(p["Dense_0"]["kernel"], p["Dense_1"]["kernel"])


def test_init_is_deterministic_per_key():
    x = _x(2, 4)
    a = _Two().init(jax.random.key(7), x)
    b = _Two().init(jax.random.key(7), x)
    c = _Two().init(jax.random.key(8), x)
    for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    assert not np.allclose(a["params"]["head"]["kernel"],
                           c["params"]["head"]["kernel"])


def test_apply_missing_parameter_raises():
    x = _x(2, 4)
    p = _Two().init(jax.random.key(0), x)
    del p["params"]["head"]
    with pytest.raises(KeyError, match="head"):
        _Two().apply(p, x)
    del p["params"]["w"]
    with pytest.raises(KeyError, match="w"):
        _Two().apply(p, x)


def test_module_outside_init_or_apply_raises():
    with pytest.raises(RuntimeError, match="init"):
        Dense(3)(_x(2, 4))


def test_apply_is_jittable_and_differentiable():
    x = _x(2, 4)
    model = _Two()
    p = model.init(jax.random.key(0), x)
    loss = lambda q: jnp.sum(model.apply(q, x) ** 2)
    g = jax.jit(jax.grad(loss))(p)
    assert jax.tree.structure(g) == jax.tree.structure(p)
    assert float(jnp.abs(g["params"]["w"]).sum()) > 0
