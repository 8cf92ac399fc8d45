"""CTC parity tests: device lax.scan CTC vs golden NumPy alpha/beta oracle
(SURVEY.md §4.1 — loss values AND input-gradients, including edge cases:
label longer than T, all-blank, repeated symbols)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chainer_speech_recognition.ops.ctc_numpy import (
    ctc_loss_np, ctc_loss_batch_np, extend_labels)
from chainer_speech_recognition.ops.ctc_jax import ctc_loss, mean_ctc_loss


def _case(seed=0, B=4, T=20, V=8, L=6):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 2
    tl = rng.integers(L + 2, T + 1, B)
    tl[0] = T
    ll = rng.integers(0, L + 1, B)
    labels = rng.integers(1, V, (B, L))
    return logits, tl, ll, labels


def test_extend_labels():
    ext = extend_labels(np.array([3, 1, 1]))
    assert list(ext) == [0, 3, 0, 1, 0, 1, 0]


def test_two_frame_analytic():
    """T=2, single label: P = p1(b)p2(l) + p1(l)p2(b) + p1(l)p2(l)."""
    logits = np.log(np.array([[[0.6, 0.3, 0.1]], [[0.2, 0.7, 0.1]]],
                             dtype=np.float64)).transpose(1, 0, 2)  # [1,2,3]
    p = np.exp(logits[0])
    expect = p[0, 0] * p[1, 1] + p[0, 1] * p[1, 0] + p[0, 1] * p[1, 1]
    loss, _ = ctc_loss_np(logits[0], np.array([1]))
    assert abs(loss - (-np.log(expect))) < 1e-9
    lj = np.asarray(ctc_loss(jnp.asarray(logits, jnp.float32),
                             jnp.asarray([2]), jnp.asarray([[1]]), jnp.asarray([1])))
    assert abs(lj[0] - loss) < 1e-4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_and_grad_parity(seed):
    logits, tl, ll, labels = _case(seed)
    loss_g, grad_g = ctc_loss_batch_np(logits, tl, labels, ll)
    loss_j = np.asarray(ctc_loss(jnp.asarray(logits), jnp.asarray(tl),
                                 jnp.asarray(labels), jnp.asarray(ll)))
    fin = np.isfinite(loss_g)
    np.testing.assert_allclose(loss_j[fin], loss_g[fin], atol=2e-4, rtol=1e-5)

    grad_j = np.asarray(jax.grad(
        lambda lg: jnp.sum(ctc_loss(lg, jnp.asarray(tl), jnp.asarray(labels),
                                    jnp.asarray(ll))))(jnp.asarray(logits)))
    assert not np.isnan(grad_j).any()
    np.testing.assert_allclose(grad_j, grad_g, atol=2e-4)


def test_repeated_symbols():
    logits = np.random.default_rng(3).standard_normal((1, 20, 6)).astype(np.float32)
    labels = np.array([[2, 2, 3, 3, 2, 2]])
    loss_g, grad_g = ctc_loss_batch_np(logits, [20], labels, [6])
    loss_j = np.asarray(ctc_loss(jnp.asarray(logits), jnp.asarray([20]),
                                 jnp.asarray(labels), jnp.asarray([6])))
    np.testing.assert_allclose(loss_j, loss_g, atol=2e-4)


def test_empty_label_is_all_blank_path():
    logits = np.random.default_rng(4).standard_normal((1, 10, 5)).astype(np.float32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)), np.float64)
    expect = -lp[0, :, 0].sum()  # only path: all blanks
    loss_j = np.asarray(ctc_loss(jnp.asarray(logits), jnp.asarray([10]),
                                 jnp.asarray([[0, 0]]), jnp.asarray([0])))
    assert abs(loss_j[0] - expect) < 1e-4


def test_impossible_alignment():
    logits = np.random.default_rng(5).standard_normal((2, 4, 6)).astype(np.float32)
    labels = np.array([[1, 2, 3, 4, 5], [1, 2, 0, 0, 0]])
    losses = np.asarray(ctc_loss(jnp.asarray(logits), jnp.asarray([4, 4]),
                                 jnp.asarray(labels), jnp.asarray([5, 2])))
    assert losses[0] > 1e29          # 5 labels in 4 frames: impossible
    assert losses[1] < 100           # possible
    m, vf = mean_ctc_loss(jnp.asarray(logits), jnp.asarray([4, 4]),
                          jnp.asarray(labels), jnp.asarray([5, 2]))
    assert float(vf) == 0.5 and float(m) < 100


def test_time_padding_invariance():
    """Loss must not depend on frames past logit_lengths."""
    logits, tl, ll, labels = _case(7)
    l1 = np.asarray(ctc_loss(jnp.asarray(logits), jnp.asarray(tl),
                             jnp.asarray(labels), jnp.asarray(ll)))
    wide = np.concatenate([logits, np.random.default_rng(8).standard_normal(
        (logits.shape[0], 13, logits.shape[2])).astype(np.float32)], axis=1)
    l2 = np.asarray(ctc_loss(jnp.asarray(wide), jnp.asarray(tl),
                             jnp.asarray(labels), jnp.asarray(ll)))
    np.testing.assert_allclose(l1, l2, atol=1e-5)


def test_optax_cross_check():
    """Independent implementation agreement (loose fp32 tolerance)."""
    import optax
    logits, tl, ll, labels = _case(9)
    B, T, V = logits.shape
    L = labels.shape[1]
    lpad = (np.arange(T)[None] >= tl[:, None]).astype(np.float32)
    labpad = (np.arange(L)[None] >= ll[:, None]).astype(np.float32)
    ours = np.asarray(ctc_loss(jnp.asarray(logits), jnp.asarray(tl),
                               jnp.asarray(labels), jnp.asarray(ll)))
    theirs = np.asarray(optax.ctc_loss(
        jnp.asarray(logits), jnp.asarray(lpad),
        jnp.asarray(np.where(labpad > 0, 0, labels)), jnp.asarray(labpad)))
    np.testing.assert_allclose(ours, theirs, atol=5e-2, rtol=1e-3)


@pytest.mark.slow
def test_fuzz_shapes_vs_optax_and_pallas():
    """Randomized shape/length fuzz: jnp scan vs optax vs Pallas (interpret)
    across 8 configurations — loss agreement at fp32 tolerances."""
    import optax
    from chainer_speech_recognition.ops.ctc_pallas import ctc_loss_pallas

    rng = np.random.default_rng(123)
    for trial in range(8):
        B = int(rng.integers(1, 7))
        T = int(rng.integers(6, 40))
        V = int(rng.integers(3, 50))
        L = int(rng.integers(1, max(2, T // 2)))
        logits = rng.standard_normal((B, T, V)).astype(np.float32) * 3
        tl = rng.integers(max(2 * L + 1, 1), T + 1, B)
        ll = rng.integers(0, L + 1, B)
        labels = rng.integers(1, V, (B, L))
        args = (jnp.asarray(tl), jnp.asarray(labels), jnp.asarray(ll))
        ours = np.asarray(ctc_loss(jnp.asarray(logits), *args))
        pall = np.asarray(ctc_loss_pallas(jnp.asarray(logits), *args,
                                          interpret=True))
        np.testing.assert_allclose(pall, ours, atol=3e-4, rtol=1e-4,
                                   err_msg=f"trial {trial}")
        lpad = (np.arange(T)[None] >= tl[:, None]).astype(np.float32)
        labpad = (np.arange(L)[None] >= ll[:, None]).astype(np.float32)
        theirs = np.asarray(optax.ctc_loss(
            jnp.asarray(logits), jnp.asarray(lpad),
            jnp.asarray(np.where(labpad > 0, 0, labels)), jnp.asarray(labpad)))
        np.testing.assert_allclose(ours, theirs, atol=5e-2, rtol=2e-3,
                                   err_msg=f"trial {trial}")
