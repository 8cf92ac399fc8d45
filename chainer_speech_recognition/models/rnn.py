"""Masked bidirectional GRU/LSTM layers as time-major ``lax.scan``
(SURVEY.md §2.3/§3.3 — the recurrent hot loop of the acoustic model).

Design decisions:
* The input projections for ALL timesteps and BOTH directions are hoisted
  out of the scan into large matmuls; the scan body performs only the
  recurrent gate matmul — the minimum sequential work (SURVEY.md §7
  hard-part 4: "single fused matmul per gate block per step").
* BOTH directions run in ONE scan: the reversed stream is stacked on a
  leading direction axis and the recurrent matmul is a 2-group batched
  einsum, so the layer serializes over T once, not twice.
* The reverse direction uses the same per-step validity mask (t < length)
  with a frozen carry, so it never pollutes its state with padded tail
  frames (hard-part 6); outputs at padded steps are zeroed.
* Matmuls run in ``dtype`` (bf16 by default), the carry and gate
  nonlinearities stay fp32 for recurrence stability.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .layers import Dense, Module, orthogonal

__all__ = ["BiRNNLayer", "time_mask"]


def time_mask(T: int, lengths: jnp.ndarray) -> jnp.ndarray:
    """[B, T] bool validity mask from per-utterance lengths."""
    return jnp.arange(T, dtype=jnp.int32)[None, :] < lengths[:, None]


def _gru_step(h, xp, hp):
    """h: [..., H] fp32; xp/hp: [..., 3H] pre-activations."""
    H = h.shape[-1]
    r = jax.nn.sigmoid(xp[..., :H] + hp[..., :H])
    z = jax.nn.sigmoid(xp[..., H:2*H] + hp[..., H:2*H])
    n = jnp.tanh(xp[..., 2*H:] + r * hp[..., 2*H:])
    return (1.0 - z) * n + z * h


def _lstm_step(hc, xp, hp):
    """hc: [..., 2H] fp32 (h‖c); xp/hp: [..., 4H] pre-activations."""
    H = hc.shape[-1] // 2
    h, c = hc[..., :H], hc[..., H:]
    g = xp + hp
    i = jax.nn.sigmoid(g[..., :H])
    f = jax.nn.sigmoid(g[..., H:2*H] + 1.0)   # forget bias +1
    o = jax.nn.sigmoid(g[..., 2*H:3*H])
    u = jnp.tanh(g[..., 3*H:])
    c_new = f * c + i * u
    h_new = o * jnp.tanh(c_new)
    return jnp.concatenate([h_new, c_new], axis=-1)


class BiRNNLayer(Module):
    """One bidirectional GRU/LSTM layer: [B, T, D] → [B, T, 2H] (masked)."""

    hidden: int
    cell: str = "gru"                  # "gru" | "lstm"
    dtype: jnp.dtype = jnp.bfloat16
    remat: bool = False
    bidirectional: bool = True         # False: forward-only — output [B,T,H],
                                       # the zero-lookahead online stack

    def __call__(self, x: jnp.ndarray, lengths: jnp.ndarray,
                 h0_fwd: jnp.ndarray | None = None,
                 emit_carry_at: int | None = None):
        """Full-utterance call: ``(x [B,T,D], lengths) → [B,T,2H]``.

        Streaming call (decode/streaming.py): pass ``h0_fwd`` ([B, H] for
        GRU / [B, 2H] h‖c for LSTM — the forward-direction state carried
        from the previous chunk) and a static ``emit_carry_at`` (chunk
        length in this layer's time base); returns ``(out, h_fwd)`` where
        ``h_fwd`` is the forward state after ``emit_carry_at`` frames
        (padding-frozen, so a final partial chunk carries the state at its
        true end). The backward direction always starts fresh at the
        window's right edge — that is the latency-controlled BiRNN
        approximation, exact when the window reaches the utterance end.
        Parameters are shared between both calls.
        """
        if (h0_fwd is None) != (emit_carry_at is None):
            raise ValueError("h0_fwd and emit_carry_at must be passed together")
        B, T, D = x.shape
        H = self.hidden
        ngates = {"gru": 3, "lstm": 4}[self.cell]
        step_fn = {"gru": _gru_step, "lstm": _lstm_step}[self.cell]
        carry_dim = H if self.cell == "gru" else 2 * H
        ndir = 2 if self.bidirectional else 1
        mask = time_mask(T, lengths)                     # [B, T]

        # hoisted input projections, one big matmul per direction
        xp_f = Dense(ngates * H, dtype=self.dtype, param_dtype=jnp.float32,
                     name="in_fwd")(x)                   # [B, T, G·H]
        w_h = self.param("rec", orthogonal,
                         (ndir, H, ngates * H), jnp.float32)

        # stack (fwd, time-reversed bwd) on a direction axis: ONE scan
        xf = jnp.swapaxes(xp_f, 0, 1).astype(jnp.float32)   # [T, B, G·H]
        m_t = jnp.swapaxes(mask, 0, 1)                      # [T, B]
        if self.bidirectional:
            xp_b = Dense(ngates * H, dtype=self.dtype,
                         param_dtype=jnp.float32, name="in_bwd")(x)
            xb = jnp.swapaxes(xp_b, 0, 1).astype(jnp.float32)[::-1]
            xs = jnp.stack([xf, xb], axis=1)                # [T, 2, B, G·H]
            ms = jnp.stack([m_t, m_t[::-1]], axis=1)        # [T, 2, B]
        else:
            xs = xf[:, None]                                # [T, 1, B, G·H]
            ms = m_t[:, None]

        stream = emit_carry_at is not None

        def step(h, inp, w_h=w_h, step_fn=step_fn, H=H):
            xpt, m = inp                                    # [2,B,G·H], [2,B]
            h_in = h[..., :H]                               # (h part for lstm)
            hp = jnp.einsum("dbh,dhg->dbg", h_in.astype(self.dtype),
                            w_h.astype(self.dtype),
                            preferred_element_type=jnp.float32)
            h_new = step_fn(h, xpt, hp)
            h_new = jnp.where(m[..., None], h_new, h)       # freeze at padding
            return h_new, (h_new if stream else h_new[..., :H])

        if self.remat:
            step = jax.checkpoint(step)
        h0 = jnp.zeros((ndir, B, carry_dim), jnp.float32)
        if h0_fwd is not None:
            # broadcast select instead of .at[0].set: a scatter of a
            # batch-sharded update into an unsharded operand is ambiguous
            # under GSPMD (sharded streaming, decode/streaming.py)
            d_iota = jnp.arange(ndir, dtype=jnp.int32)[:, None, None]
            h0 = jnp.where(d_iota == 0, h0_fwd.astype(jnp.float32)[None], h0)
        _, ys = jax.lax.scan(step, h0, (xs, ms))  # ys: [T, ndir, B, H|carry]
        fwd = jnp.swapaxes(ys[:, 0, :, :H], 0, 1)           # [B, T, H]
        if self.bidirectional:
            bwd = jnp.swapaxes(ys[::-1, 1, :, :H], 0, 1)
            out = jnp.concatenate([fwd, bwd], axis=-1)
        else:
            out = fwd
        out = out * mask[:, :, None].astype(out.dtype)
        if not stream:
            return out
        # forward state after emit_carry_at frames; padding-frozen ⇒ a
        # short final window carries the state at its true end
        h_carry = h0[0] if emit_carry_at == 0 else ys[emit_carry_at - 1, 0]
        return out, h_carry
