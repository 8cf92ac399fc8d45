"""CTC α/β recursions as Pallas kernels on the Triton route, with a custom
VJP (BASELINE.json:5 "the CTC loss alpha-beta recursion implemented as a
Pallas scan kernel"; SURVEY.md §2.4, §7 Phase 3b / hard-part 1).

Decomposition:
* XLA keeps what it does well: log_softmax, the [B,T,V]→[B,T,S] extended-
  label emission gather and, in the backward, its scatter back to V.
  Autodiff flows through those natively.
* The kernels do the sequential part. ``lax.scan`` (ops/ctc_jax.py) runs
  every time step as a loop iteration with launches of its own; here one
  launch runs the whole recursion. The grid is one program per batch row.
  Each program walks time with a ``fori_loop`` and keeps its α (or β) row
  of ``Sp`` states (S padded to a power of two) in registers. The s−1 and
  s−2 (β: s+1, s+2) neighbours are read back from the row just stored,
  after a block barrier; the forward stores every α row anyway (the
  backward needs them), the backward ping-pongs β through a two-row
  buffer.
* All recursion math is fp32; -1e30 is "log zero"; per-utterance time and
  label lengths are handled by freeze/override masks — shapes stay static.

Numerical contract: identical to ops/ctc_jax.py and the golden oracle
(ops/ctc_numpy.py); tests/test_ctc_pallas.py runs the kernels in interpret
mode against both, for loss and gradient.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..constants import BLANK_ID
from .ctc_jax import (LOG_ZERO, _logsumexp3 as _lse3, extend_labels,
                      masked_mean_loss)

# one stage: the loops read back rows they stored one iteration earlier, so
# software pipelining must not hoist those loads above the stores
_PARAMS = plgpu.CompilerParams(num_warps=4, num_stages=1)


def padded_states(S: int) -> int:
    """Extended-label states padded to the kernel's power-of-two row."""
    return max(pl.next_power_of_2(S), 32)


def _shifted(ref, base, idx, ok):
    """ref[base + idx] where ``ok``, log-zero elsewhere (a masked gather
    of the row stored before the last barrier)."""
    return plgpu.load(ref.at[base + jnp.clip(idx, 0, idx.shape[0] - 1)],
                      mask=ok, other=LOG_ZERO)


def _barrier(interpret: bool):
    """Block-wide barrier; the interpreter runs one thread, needs none
    (and has no rule for it)."""
    if not interpret:
        plgpu.debug_barrier()


def _normalize(x):
    """(x − max x, max x); an all-log-zero row stays as it is (shift 0)."""
    top = jnp.max(x)
    top = jnp.where(top > LOG_ZERO / 2, top, 0.0)
    return x - top, top


def _fwd_kernel(lp_ref, allow2_ref, tlen_ref, lab_ref, alphas_ref, loss_ref,
                *, T: int, Sp: int, interpret: bool):
    """One batch row. lp/alphas: [T·Sp] (row-major over time).

    Each α row is stored shifted by its max (so its values stay small and
    keep fp32 precision); the shifts add up in ``norm``, and the loss is
    -(norm + log-prob mass of the final states)."""
    s = jnp.arange(Sp, dtype=jnp.int32)
    tlen, L = tlen_ref[()], lab_ref[()]
    s_valid = s < 2 * L + 1
    allow2 = allow2_ref[...] != 0
    start = ((s == 0) | ((s == 1) & (L > 0))) & s_valid
    a, norm = _normalize(jnp.where(start, lp_ref[pl.ds(0, Sp)], LOG_ZERO))
    alphas_ref[pl.ds(0, Sp)] = a

    def step(t, carry):
        a, norm = carry
        _barrier(interpret)                # row t-1 visible to every thread
        base = (t - 1) * Sp
        sh1 = _shifted(alphas_ref, base, s - 1, s >= 1)
        sh2 = _shifted(alphas_ref, base, s - 2, allow2)
        new = _lse3(a, sh1, sh2) + lp_ref[pl.ds(t * Sp, Sp)]
        new, shift = _normalize(jnp.where(s_valid, new, LOG_ZERO))
        alive = t < tlen                   # frozen past the last frame
        a = jnp.where(alive, new, a)
        norm = jnp.where(alive, norm + shift, norm)
        alphas_ref[pl.ds(t * Sp, Sp)] = a
        return a, norm

    a, norm = lax.fori_loop(1, T, step, (a, norm))
    last = jnp.max(jnp.where(s == 2 * L, a, LOG_ZERO))
    prev = jnp.max(jnp.where((s == 2 * L - 1) & (L > 0), a, LOG_ZERO))
    loss_ref[()] = -(norm + _lse3(last, prev, jnp.float32(LOG_ZERO)))


def _bwd_kernel(lp_ref, allow2_ref, alphas_ref, tlen_ref, lab_ref, g_ref,
                grad_ref, beta_ref, *, T: int, Sp: int, interpret: bool):
    """One batch row, t = T-1 .. 0. β is defined like α (it includes frame
    t's emission), so d loss / d lp[t,s] = -g·γ[t,s] with the posterior
    γ = exp(α+β-lp-logP). Like α, each β row is kept shifted by its max,
    and since Σ_s α·β/y = P holds at every t, each frame normalizes its
    own posterior with a logsumexp over s: no shift, norm or logP — sums
    of magnitude ~1e3 whose fp32 rounding would swamp γ — enters it.
    beta_ref: [2·Sp] ping-pong buffer (row i%2 written at iteration i)."""
    s = jnp.arange(Sp, dtype=jnp.int32)
    tlen, L = tlen_ref[()], lab_ref[()]
    g = g_ref[()]
    s_valid = s < 2 * L + 1
    end = ((s == 2 * L) | ((s == 2 * L - 1) & (L > 0))) & s_valid
    allow2_s2 = plgpu.load(allow2_ref.at[jnp.minimum(s + 2, Sp - 1)],
                           mask=s + 2 < Sp, other=0) != 0
    b = jnp.full((Sp,), LOG_ZERO, jnp.float32)
    beta_ref[pl.ds(Sp, Sp)] = b

    def step(i, b):
        t = T - 1 - i
        _barrier(interpret)                # β(t+1) visible; old slot free
        base = lax.rem(i + 1, 2) * Sp
        sh1 = _shifted(beta_ref, base, s + 1, s + 1 < Sp)
        sh2 = _shifted(beta_ref, base, s + 2, allow2_s2)
        lp_t = lp_ref[pl.ds(t * Sp, Sp)]
        new = _lse3(b, sh1, sh2) + lp_t
        b = jnp.where(t == tlen - 1, jnp.where(end, lp_t, LOG_ZERO),
                      jnp.where(t < tlen, new, b))
        b, _ = _normalize(jnp.where(s_valid, b, LOG_ZERO))
        beta_ref[pl.ds(lax.rem(i, 2) * Sp, Sp)] = b
        post = jnp.where(s_valid,
                         alphas_ref[pl.ds(t * Sp, Sp)] + b - lp_t, LOG_ZERO)
        top = jnp.max(post)
        post = post - (top + jnp.log(jnp.sum(jnp.exp(post - top))))
        grad = -jnp.exp(jnp.minimum(post, 0.0)) * g
        grad_ref[pl.ds(t * Sp, Sp)] = jnp.where((t < tlen) & s_valid,
                                                grad, 0.0)
        return b

    lax.fori_loop(0, T, step, b)


def _row(n):
    return pl.BlockSpec((None, n), lambda b: (b, 0))


_SCALAR = pl.BlockSpec((None,), lambda b: (b,))


def _run_fwd(lp, allow2, tlen, lab, interpret):
    B, T, Sp = lp.shape
    alphas, loss = pl.pallas_call(
        functools.partial(_fwd_kernel, T=T, Sp=Sp, interpret=interpret),
        grid=(B,),
        in_specs=[_row(T * Sp), _row(Sp), _SCALAR, _SCALAR],
        out_specs=[_row(T * Sp), _SCALAR],
        out_shape=[jax.ShapeDtypeStruct((B, T * Sp), jnp.float32),
                   jax.ShapeDtypeStruct((B,), jnp.float32)],
        compiler_params=_PARAMS, backend="triton", interpret=interpret,
        name="ctc_alpha",
    )(lp.reshape(B, T * Sp), allow2, tlen, lab)
    return alphas, loss


def _run_bwd(lp, allow2, alphas, tlen, lab, g, interpret):
    B, T, Sp = lp.shape
    grad, _ = pl.pallas_call(
        functools.partial(_bwd_kernel, T=T, Sp=Sp, interpret=interpret),
        grid=(B,),
        in_specs=[_row(T * Sp), _row(Sp), _row(T * Sp), _SCALAR, _SCALAR,
                  _SCALAR],
        out_specs=[_row(T * Sp), _row(2 * Sp)],
        out_shape=[jax.ShapeDtypeStruct((B, T * Sp), jnp.float32),
                   jax.ShapeDtypeStruct((B, 2 * Sp), jnp.float32)],
        compiler_params=_PARAMS, backend="triton", interpret=interpret,
        name="ctc_beta_grad",
    )(lp.reshape(B, T * Sp), allow2, alphas, tlen, lab, g)
    return grad.reshape(B, T, Sp)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def _ctc_ext_loss(lp, allow2, tlen, lab, interpret):
    """loss [B] from padded extended-label emissions lp [B, T, Sp]."""
    return _run_fwd(lp, allow2, tlen, lab, interpret)[1]


def _ctc_ext_fwd(lp, allow2, tlen, lab, interpret):
    alphas, loss = _run_fwd(lp, allow2, tlen, lab, interpret)
    return loss, (lp, allow2, tlen, lab, alphas, loss)


def _ctc_ext_bwd(interpret, res, g):
    lp, allow2, tlen, lab, alphas, loss = res
    # Impossible samples (no valid alignment: loss saturates at ~-LOG_ZERO)
    # get exactly zero gradient, matching the jnp scan and the golden
    # oracle — exp(alpha+beta-lp-logP) is numerically garbage there.
    g = jnp.where(loss < -LOG_ZERO / 2, g.astype(jnp.float32), 0.0)
    d_lp = _run_bwd(lp, allow2, alphas, tlen, lab, g, interpret)
    return d_lp, None, None, None


_ctc_ext_loss.defvjp(_ctc_ext_fwd, _ctc_ext_bwd)


@functools.partial(jax.jit, static_argnames=("interpret",))
def ctc_loss_pallas(
    logits: jnp.ndarray,         # [B, T, V]
    logit_lengths: jnp.ndarray,  # [B]
    labels: jnp.ndarray,         # [B, L]
    label_lengths: jnp.ndarray,  # [B]
    interpret: bool = False,     # Pallas interpreter (CPU tests only)
) -> jnp.ndarray:
    """Drop-in replacement for ops.ctc_jax.ctc_loss (same semantics)."""
    logits = logits.astype(jnp.float32)
    B, T, V = logits.shape
    # lengths clamp to [1, T]: the scan treats 0 like 1 (frame 0 always
    # seeds α) and freezes past T; the backward's β init (t == tlen-1)
    # must fire inside the window for the gradient to match
    tlen = jnp.clip(logit_lengths, 1, T).astype(jnp.int32)
    lp = jax.nn.log_softmax(logits, axis=-1)
    ext = extend_labels(labels)                              # [B, S]
    S = ext.shape[1]
    Sp = padded_states(S)
    lab = label_lengths.astype(jnp.int32)
    sidx = jnp.arange(S, dtype=jnp.int32)[None, :]
    prev2 = jnp.concatenate([jnp.zeros((B, 2), jnp.int32), ext[:, :-2]], axis=1)
    allow2 = (sidx >= 2) & (ext != BLANK_ID) & (ext != prev2)
    allow2 = jnp.pad(allow2.astype(jnp.int32), ((0, 0), (0, Sp - S)))
    lp_ext = jnp.take_along_axis(lp, ext[:, None, :], axis=2)  # [B, T, S]
    lp_ext = jnp.pad(lp_ext, ((0, 0), (0, 0), (0, Sp - S)),
                     constant_values=LOG_ZERO)
    return _ctc_ext_loss(lp_ext, allow2, tlen, lab, interpret)


def mean_ctc_loss_pallas(logits, logit_lengths, labels, label_lengths,
                         interpret: bool = False):
    losses = ctc_loss_pallas(logits, logit_lengths, labels, label_lengths,
                             interpret=interpret)
    return masked_mean_loss(losses)     # same policy object as ctc_jax
