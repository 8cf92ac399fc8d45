"""Acoustic model tests: preset registry, shapes, length bookkeeping,
batch-padding invariance (SURVEY.md §7 hard-part 6)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chainer_speech_recognition.config import preset_config
from chainer_speech_recognition.models.conv import conv_out_length
from chainer_speech_recognition.models.presets import build_model


def _model(name, **over):
    cfg = preset_config(name).model
    d = {**cfg.__dict__, "compute_dtype": "float32", "rnn_hidden": 16,
         "vocab_size": 10, **over}
    return build_model(type(cfg)(**d))


def _init_apply(model, x, lens):
    params = jax.jit(model.init)(jax.random.key(0), x, lens)
    return params, jax.jit(model.apply)


def test_conv_out_length():
    lens = jnp.asarray([37, 20, 9, 1])
    assert list(np.asarray(conv_out_length(lens, 2))) == [19, 10, 5, 1]


@pytest.mark.parametrize("name,subsample", [
    ("tiny_conv", 4),
    pytest.param("bigru", 4, marks=pytest.mark.slow),
    pytest.param("bilstm_deep", 4, marks=pytest.mark.slow),
    pytest.param("glu_conv", 4, marks=pytest.mark.slow)])
def test_preset_shapes(name, subsample):
    model = _model(name)
    B, T, F = 2, 37, 40
    x = jnp.asarray(np.random.default_rng(0).standard_normal((B, T, F, 3)),
                    jnp.float32)
    lens = jnp.asarray([37, 16])
    params, apply = _init_apply(model, x, lens)
    logits, olens = apply(params, x, lens)
    assert logits.shape == (B, -(-T // subsample), 10)
    assert list(np.asarray(olens)) == [-(-37 // subsample), -(-16 // subsample)]
    assert logits.dtype == jnp.float32
    assert model.subsample_factor() == subsample


@pytest.mark.parametrize("name", [
    "tiny_conv",
    pytest.param("bigru", marks=pytest.mark.slow),
    pytest.param("bilstm_deep", marks=pytest.mark.slow),
    pytest.param("glu_conv", marks=pytest.mark.slow)])
def test_padding_invariance(name):
    """Valid-frame logits must not depend on batch padding length."""
    model = _model(name)
    x = jnp.asarray(np.random.default_rng(1).standard_normal((3, 37, 40, 3)),
                    jnp.float32)
    lens = jnp.asarray([37, 20, 9])
    params, apply = _init_apply(model, x, lens)
    logits, olens = apply(params, x, lens)
    logits2, _ = apply(params, x[:, :20], jnp.asarray([20, 20, 9]))
    o = int(np.asarray(olens)[1])
    np.testing.assert_allclose(np.asarray(logits)[1, :o],
                               np.asarray(logits2)[1, :o], atol=1e-5)
    # padded output frames are zeroed
    assert np.all(np.asarray(logits)[2, int(np.asarray(olens)[2]):] == 0)


def test_remat_matches():
    # 1 layer: the remat wrapper wraps each layer scan identically, so one
    # layer proves equality at a third of the compile time
    m1 = _model("bigru", rnn_layers=1)
    m2 = _model("bigru", rnn_layers=1, remat_rnn=True)
    x = jnp.asarray(np.random.default_rng(2).standard_normal((2, 21, 40, 3)),
                    jnp.float32)
    lens = jnp.asarray([21, 13])
    params, apply1 = _init_apply(m1, x, lens)
    logits1, _ = apply1(params, x, lens)
    logits2, _ = jax.jit(m2.apply)(params, x, lens)
    np.testing.assert_allclose(np.asarray(logits1), np.asarray(logits2),
                               atol=1e-5)


def test_unidirectional_shapes_and_causality():
    """rnn_bidirectional=False: forward-only stack — output shapes hold,
    the padding-invariance contract holds, and the model is CAUSAL apart
    from the conv stack's finite lookahead: changing inputs after frame
    t+margin cannot change the logit at t."""
    model = _model("uni_gru")
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 64, 40, 3)), jnp.float32)
    lens = jnp.asarray([64, 64])
    params, apply = _init_apply(model, x, lens)
    logits, olens = apply(params, x, lens)
    assert logits.shape == (2, 16, 10)

    # causality: perturb the tail only; early outputs must be identical
    margin = model.conv_receptive_margin()            # input frames
    x2 = np.array(x)                                  # writable copy
    x2[:, 40:] += 1.0
    logits2, _ = apply(params, jnp.asarray(x2), lens)
    s = model.subsample_factor()
    safe = (40 - margin) // s
    np.testing.assert_array_equal(np.asarray(logits)[:, :safe],
                                  np.asarray(logits2)[:, :safe])
    # ...and the tail DID change (the test has teeth)
    assert not np.allclose(np.asarray(logits)[:, -1],
                           np.asarray(logits2)[:, -1])
