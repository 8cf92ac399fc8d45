"""Pallas CTC kernel vs golden oracle + jnp scan — the forever differential
test (SURVEY.md §7 hard-part 1). Runs the Triton-route kernels in interpret
mode on CPU; the same code compiles for the GPU (tests/test_gpu.py and
chip_smoke.py run it there)."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chainer_speech_recognition.ops.ctc_jax import ctc_loss
from chainer_speech_recognition.ops.ctc_numpy import ctc_loss_batch_np
from chainer_speech_recognition.ops import ctc_pallas
from chainer_speech_recognition.ops.ctc_pallas import padded_states

ctc_loss_pallas = functools.partial(ctc_pallas.ctc_loss_pallas,
                                    interpret=True)
mean_ctc_loss_pallas = functools.partial(ctc_pallas.mean_ctc_loss_pallas,
                                         interpret=True)


def _case(seed=0, B=4, T=20, V=8, L=6):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 2
    tl = rng.integers(L + 2, T + 1, B)
    tl[0] = T
    ll = rng.integers(0, L + 1, B)
    labels = rng.integers(1, V, (B, L))
    return logits, tl, ll, labels


@pytest.mark.parametrize("seed", [0, 1])
def test_pallas_loss_and_grad_vs_golden(seed):
    logits, tl, ll, labels = _case(seed)
    loss_g, grad_g = ctc_loss_batch_np(logits, tl, labels, ll)
    loss_p = np.asarray(ctc_loss_pallas(
        jnp.asarray(logits), jnp.asarray(tl), jnp.asarray(labels),
        jnp.asarray(ll)))
    fin = np.isfinite(loss_g)
    np.testing.assert_allclose(loss_p[fin], loss_g[fin], atol=2e-4, rtol=1e-5)

    grad_p = np.asarray(jax.grad(
        lambda lg: jnp.sum(ctc_loss_pallas(
            lg, jnp.asarray(tl), jnp.asarray(labels), jnp.asarray(ll))))(
        jnp.asarray(logits)))
    assert not np.isnan(grad_p).any()
    np.testing.assert_allclose(grad_p, grad_g, atol=2e-4)


@pytest.mark.slow
def test_pallas_vs_jnp_scan_big():
    """Larger shapes (state padding exercised: S=49 → 64)."""
    logits, tl, ll, labels = _case(seed=3, B=11, T=50, V=30, L=24)
    args = (jnp.asarray(logits), jnp.asarray(tl), jnp.asarray(labels),
            jnp.asarray(ll))
    lp = np.asarray(ctc_loss_pallas(*args))
    lj = np.asarray(ctc_loss(*args))
    np.testing.assert_allclose(lp, lj, atol=2e-4, rtol=1e-5)
    gp = np.asarray(jax.grad(lambda lg: jnp.sum(
        ctc_loss_pallas(lg, *args[1:])))(args[0]))
    gj = np.asarray(jax.grad(lambda lg: jnp.sum(
        ctc_loss(lg, *args[1:])))(args[0]))
    np.testing.assert_allclose(gp, gj, atol=2e-4)


@pytest.mark.slow
def test_pallas_multi_lane_tile_S():
    """S > 128 (CSJ-scale labels): S=141 pads to a 256-state row."""
    logits, tl, ll, labels = _case(seed=11, B=4, T=120, V=40, L=70)  # S=141
    args = (jnp.asarray(tl), jnp.asarray(labels), jnp.asarray(ll))
    lp = np.asarray(ctc_loss_pallas(jnp.asarray(logits), *args))
    lj = np.asarray(ctc_loss(jnp.asarray(logits), *args))
    np.testing.assert_allclose(lp, lj, atol=2e-4, rtol=1e-5)
    gp = np.asarray(jax.grad(lambda lg: jnp.sum(
        ctc_loss_pallas(lg, *args)))(jnp.asarray(logits)))
    gj = np.asarray(jax.grad(lambda lg: jnp.sum(
        ctc_loss(lg, *args)))(jnp.asarray(logits)))
    np.testing.assert_allclose(gp, gj, atol=5e-4)


def test_pallas_impossible_and_empty():
    logits = np.random.default_rng(5).standard_normal((2, 4, 6)).astype(np.float32)
    labels = np.array([[1, 2, 3, 4, 5], [0, 0, 0, 0, 0]])
    losses = np.asarray(ctc_loss_pallas(
        jnp.asarray(logits), jnp.asarray([4, 4]), jnp.asarray(labels),
        jnp.asarray([5, 0])))
    assert losses[0] > 1e29                     # impossible alignment
    # empty label = all-blank path
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)), np.float64)
    assert abs(losses[1] - (-lp[1, :, 0].sum())) < 1e-4
    m, vf = mean_ctc_loss_pallas(
        jnp.asarray(logits), jnp.asarray([4, 4]), jnp.asarray(labels),
        jnp.asarray([5, 0]))
    assert float(vf) == 0.5
    # impossible sample must contribute EXACTLY zero gradient (matches the
    # jnp scan + golden oracle) even through bare ctc_loss_pallas
    grad = np.asarray(jax.grad(lambda lg: jnp.sum(ctc_loss_pallas(
        lg, jnp.asarray([4, 4]), jnp.asarray(labels), jnp.asarray([5, 0]))))(
        jnp.asarray(logits)))
    assert np.all(grad[0] == 0.0), np.abs(grad[0]).max()
    assert np.isfinite(grad[1]).all() and np.abs(grad[1]).max() > 0


def test_pallas_time_padding_invariance():
    logits, tl, ll, labels = _case(7)
    l1 = np.asarray(ctc_loss_pallas(jnp.asarray(logits), jnp.asarray(tl),
                                    jnp.asarray(labels), jnp.asarray(ll)))
    wide = np.concatenate([logits, np.random.default_rng(8).standard_normal(
        (logits.shape[0], 13, logits.shape[2])).astype(np.float32)], axis=1)
    l2 = np.asarray(ctc_loss_pallas(jnp.asarray(wide), jnp.asarray(tl),
                                    jnp.asarray(labels), jnp.asarray(ll)))
    np.testing.assert_allclose(l1, l2, atol=1e-5)


def test_pallas_overlong_lengths_match_jnp_grad():
    """logit_lengths > T (a caller's length-formula bug) must behave like
    the jnp path in BOTH loss and gradient — without the clamp the
    backward kernel's beta init (t == tlen-1) would never fire for
    tlen > T, silently zeroing those samples' grads while their loss
    stayed finite."""
    logits, tl, ll, labels = _case(seed=5)
    tl = tl.copy()
    tl[1] = logits.shape[1] + 3                 # past T
    ll[1] = max(int(ll[1]), 1)

    def f_pallas(lg):
        return mean_ctc_loss_pallas(lg, jnp.asarray(tl), jnp.asarray(labels),
                                    jnp.asarray(ll))[0]

    def f_jnp(lg):
        from chainer_speech_recognition.ops.ctc_jax import mean_ctc_loss
        return mean_ctc_loss(lg, jnp.asarray(jnp.minimum(tl, lg.shape[1])),
                             jnp.asarray(labels), jnp.asarray(ll))[0]

    x = jnp.asarray(logits)
    lp, gp = jax.value_and_grad(f_pallas)(x)
    lj, gj = jax.value_and_grad(f_jnp)(x)
    np.testing.assert_allclose(float(lp), float(lj), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gp), np.asarray(gj),
                               atol=1e-5, rtol=1e-4)
    assert float(jnp.abs(gp[1]).max()) > 0.0    # the overlong sample TRAINS


def _edge_case(name):
    """(logits, t_len, labels, lab_len) for one named edge case."""
    if name == "empty_labels":               # L=0 rows: all-blank path
        logits, tl, ll, labels = _case(seed=21, B=3, T=9, V=5, L=3)
        ll[:] = [0, 2, 0]
    elif name == "impossible_rows":          # 2L+repeats > T: no alignment
        logits, tl, ll, labels = _case(seed=22, B=3, T=8, V=6, L=6)
        tl[:], ll[:] = [8, 3, 8], [6, 6, 2]
        labels[0] = [1, 1, 1, 1, 1, 1]       # needs 11 frames, has 8
    elif name == "tlen_over_T":
        logits, tl, ll, labels = _case(seed=23, B=2, T=10, V=6, L=3)
        tl[:] = [10 + 7, 4]
    elif name == "tlen_zero":                # scan treats 0 like 1
        logits, tl, ll, labels = _case(seed=24, B=2, T=6, V=5, L=2)
        tl[:], ll[:] = [0, 6], [0, 2]
    elif name == "single_frame":
        logits, tl, ll, labels = _case(seed=25, B=2, T=4, V=4, L=1)
        logits, tl, ll = logits[:, :1], np.asarray([1, 1]), np.asarray([0, 1])
    elif name == "S_not_pow2_wide":          # S=67 → 128-state row
        logits, tl, ll, labels = _case(seed=26, B=2, T=80, V=12, L=33)
    elif name == "repeated_labels":          # allow2 off between repeats
        logits, tl, ll, labels = _case(seed=27, B=2, T=16, V=4, L=5)
        labels[:] = [[2, 2, 3, 3, 3], [1, 2, 1, 2, 1]]
        ll[:] = [5, 5]
    elif name == "ragged_B5":                # B not a power of two
        logits, tl, ll, labels = _case(seed=28, B=5, T=13, V=7, L=4)
    else:
        raise KeyError(name)
    return logits, tl, ll, labels


@pytest.mark.parametrize("name", [
    "empty_labels", "impossible_rows", "tlen_over_T", "tlen_zero",
    "single_frame", "S_not_pow2_wide", "repeated_labels", "ragged_B5"])
def test_kernel_edge_cases_vs_golden_and_scan(name):
    """Loss and gradient of the kernel against the golden oracle (where
    it defines the case) and the jnp scan's autodiff, per edge case."""
    logits, tl, ll, labels = _edge_case(name)
    T = logits.shape[1]
    args = (jnp.asarray(tl), jnp.asarray(labels), jnp.asarray(ll))
    x = jnp.asarray(logits)
    loss_k = np.asarray(ctc_loss_pallas(x, *args))
    tl_j = jnp.asarray(np.clip(tl, 1, T))    # the scan's own semantics
    loss_j = np.asarray(ctc_loss(x, tl_j, *args[1:]))
    fin = loss_j < 1e29
    np.testing.assert_allclose(loss_k[fin], loss_j[fin], atol=2e-4,
                               rtol=1e-5)
    assert np.all(loss_k[~fin] > 1e29)       # impossible stays impossible
    if name not in ("tlen_over_T", "tlen_zero"):
        loss_g, grad_g = ctc_loss_batch_np(logits, tl, labels, ll)
        np.testing.assert_allclose(loss_k[fin], loss_g[fin], atol=2e-4,
                                   rtol=1e-5)

    def total(f, t_len):
        def g(lg):
            losses = f(lg, t_len, *args[1:])
            return jnp.sum(jnp.where(losses < 1e29, losses, 0.0))
        return g

    gk = np.asarray(jax.grad(total(ctc_loss_pallas, args[0]))(x))
    gj = np.asarray(jax.grad(total(ctc_loss, tl_j))(x))
    assert np.isfinite(gk).all()
    np.testing.assert_allclose(gk, gj, atol=2e-4)
    assert np.all(gk[~fin] == 0.0)


def test_padded_states_power_of_two():
    """The kernel row is a power of two of at least 32 states."""
    assert [padded_states(s) for s in (1, 3, 31, 33, 129, 257)] == \
        [32, 32, 32, 64, 256, 512]
