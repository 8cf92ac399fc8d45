"""Conformer-style self-attention encoder blocks — the attention model
family (capability beyond the reference: SURVEY.md §2.7 notes the reference
has "no attention anywhere in the model"; this preset exists because
attention's large batched matmuls have far higher arithmetic intensity
than the sequential BiRNN recurrence, SURVEY.md §3.3).

Design decisions:

* Every FLOP-carrying op is a large static-shape matmul (QKV/out
  projections, macaron feed-forward pairs, the [B,h,T,T] score/value
  einsums), fused by XLA; there is NO sequential-in-time
  dependency, so a block costs O(1) compile-side latency vs the BiRNN's
  T-step scan chain.
* bf16 matmuls, fp32 residual stream: LayerNorm, softmax, and the
  residual adds run in fp32 (`preferred_element_type` on the score
  einsum), matching the repo-wide "bf16 compute / fp32 numerics-critical"
  convention (models/rnn.py).
* Relative position via RoPE (rotary embedding on q/k): zero parameters,
  zero extra matmuls, exact at any offset — translation-invariant like
  the Transformer-XL encoding the Conformer paper uses, but with no
  [T,T] position-score tensor to materialize.
* Exact padding invariance (the repo's batched == per-utterance
  contract, models/conv.py): attention scores are masked at PADDED KEYS
  before softmax, the depthwise conv sees zeroed padded frames and uses
  explicit (k-1)//2,k//2 padding, and every block re-zeroes padded
  frames on exit — valid-frame outputs are independent of batch padding.
* The conv module normalizes with LayerNorm, not the paper's BatchNorm:
  batch statistics would couple utterances (breaking padding invariance
  and the streaming/batching equality contracts).

Chunk-causal mode (``chunk > 0`` — the STREAMING attention family,
`conformer_stream` preset): frames are partitioned into chunks of
``chunk`` subsampled frames; a query in chunk i attends to keys in chunks
``[i - left_chunks, i]`` (full own chunk — intra-chunk lookahead — plus a
bounded left context), and the depthwise conv is causal (left-padded
only). The receptive field is then finite and strictly chunk-aligned, so
the block can stream EXACTLY with three small carries per block
(decode/streaming.py): rolled K/V caches of the last ``left_chunks``
chunks (keys are cached POST-RoPE at their absolute positions — RoPE
scores depend only on the relative offset, so cached rotations stay
valid forever) and the last ``conv_kernel − 1`` post-GLU frames for the
causal conv. The offline forward applies the identical chunk mask, so a
chunk-causally TRAINED checkpoint serves online with zero train/serve
mismatch — the same contract the forward-only RNN preset (`uni_gru`)
makes, now for the attention family.

No dropout: regularization comes from SpecAugment (ops/specaugment.py),
as everywhere else in this build; the blocks take no RNG.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .layers import Conv, Dense, LayerNorm, Module
from .rnn import time_mask

__all__ = ["ConformerBlock", "rope"]


def rope(x: jnp.ndarray, base: float = 10_000.0,
         pos0: jnp.ndarray | None = None) -> jnp.ndarray:
    """Rotary position embedding over the last (head) dim of [B, T, h, dh].

    Pairs channel i with i+dh/2 (rotate-half layout). Offline
    (``pos0=None``): angles are a static [T, dh/2] table folded into the
    jit as a constant. Streaming: ``pos0`` is the per-row GLOBAL index of
    frame 0 ([B] int32, traced), so cached keys rotated in earlier chunks
    compose exactly with current queries — the angle math is the same
    fp32 ``position · freq`` product in both paths.
    """
    B, T, h, dh = x.shape
    half = dh // 2
    freq = base ** (-np.arange(half, dtype=np.float32) / half)   # [dh/2]
    if pos0 is None:
        ang = jnp.asarray(np.arange(T, dtype=np.float32)[:, None] * freq)
        cos = jnp.cos(ang)[None, :, None, :]                     # [1,T,1,dh/2]
        sin = jnp.sin(ang)[None, :, None, :]
    else:
        pos = (pos0.astype(jnp.float32)[:, None]
               + jnp.arange(T, dtype=jnp.float32)[None, :])      # [B, T]
        ang = pos[:, :, None, None] * jnp.asarray(freq)          # [B,T,1,dh/2]
        cos, sin = jnp.cos(ang), jnp.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return jnp.concatenate(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1).astype(x.dtype)


def chunk_causal_mask(T: int, chunk: int, left_chunks: int) -> np.ndarray:
    """Static [T, T] bool: query t may attend key s iff s's chunk is within
    ``[t's chunk − left_chunks, t's chunk]`` — full own chunk (intra-chunk
    lookahead) plus a bounded left context."""
    tc = np.arange(T) // chunk
    return (tc[None, :] <= tc[:, None]) & \
           (tc[None, :] >= tc[:, None] - left_chunks)


class _MHSA(Module):
    """Multi-head self-attention with RoPE and key-side padding mask.

    ``chunk > 0`` restricts attention to the chunk-causal pattern; with
    ``kv_cache`` the call is a STREAMING step over one chunk: queries are
    the current chunk, keys/values are [cache ++ current], and the
    returned rolled caches carry the last ``left_chunks`` chunks forward.
    The allowed key set is identical to the offline chunk mask, and
    masked probabilities are exactly 0.0, so streaming == offline.
    """

    heads: int
    dtype: jnp.dtype
    chunk: int = 0
    left_chunks: int = 0

    def __call__(self, x: jnp.ndarray, mask: jnp.ndarray, kv_cache=None,
                 cache_mask: jnp.ndarray | None = None,
                 pos0: jnp.ndarray | None = None):
        B, T, d = x.shape
        h = self.heads
        dh = d // h
        dense = lambda name: Dense(d, dtype=self.dtype,
                                   param_dtype=jnp.float32, name=name)
        # one fused [B,T,d]@[d,3d] GEMM instead of three d×d dispatches —
        # same math, fewer/larger matmuls (XLA does not merge separate
        # dots over distinct parameters)
        qkv = Dense(3 * d, dtype=self.dtype, param_dtype=jnp.float32,
                       name="qkv")(x)
        q = qkv[..., :d].reshape(B, T, h, dh)
        k = qkv[..., d:2 * d].reshape(B, T, h, dh)
        v = qkv[..., 2 * d:].reshape(B, T, h, dh)
        q, k = rope(q, pos0=pos0), rope(k, pos0=pos0)
        if kv_cache is not None:
            k_cache, v_cache = kv_cache                  # [B, P, h, dh] ×2
            P = k_cache.shape[1]
            k_all = jnp.concatenate([k_cache, k.astype(self.dtype)], axis=1)
            v_all = jnp.concatenate([v_cache, v.astype(self.dtype)], axis=1)
            key_ok = jnp.concatenate([cache_mask, mask], axis=1)  # [B, P+T]
        else:
            k_all, v_all, key_ok = k, v, mask
        # scores in fp32: bf16 accumulation over dh then fp32 softmax
        scores = jnp.einsum("bthd,bshd->bhts", q, k_all,
                            preferred_element_type=jnp.float32)
        scores = scores * (1.0 / np.sqrt(dh))
        # mask padded KEYS; padded queries produce garbage rows that the
        # block's exit mask zeroes (they never reach valid frames)
        allowed = key_ok[:, None, None, :]
        if self.chunk and kv_cache is None:
            # offline chunk-causal pattern (static [T, T] table); the
            # streaming step's key extent IS the allowed window, so no
            # extra pattern mask is needed there
            allowed = allowed & jnp.asarray(
                chunk_causal_mask(T, self.chunk, self.left_chunks)
            )[None, None]
        scores = jnp.where(allowed, scores, -1e30)
        probs = jax.nn.softmax(scores, axis=-1).astype(self.dtype)
        out = jnp.einsum("bhts,bshd->bthd", probs, v_all.astype(self.dtype))
        out = dense("out")(out.reshape(B, T, d))
        if kv_cache is None:
            return out
        new_k = jnp.concatenate([k_cache, k.astype(self.dtype)], axis=1)[:, -P:]
        new_v = jnp.concatenate([v_cache, v.astype(self.dtype)], axis=1)[:, -P:]
        return out, (new_k, new_v)


class _ConvModule(Module):
    """Conformer conv module: GLU pointwise → masked depthwise → LN →
    swish → pointwise. The depthwise conv is elementwise work (negligible
    FLOPs); the two pointwise convs are matmuls. ``causal=True`` left-pads
    only (k−1 frames) — the chunk-causal/streaming variant; with
    ``h_tail`` ([B, k−1, d], the previous chunk's post-GLU tail) the
    depthwise conv runs VALID over [tail ++ chunk], which equals the
    offline causal computation exactly (a zero tail == the left pad at
    stream start)."""

    kernel: int
    dtype: jnp.dtype
    causal: bool = False

    def __call__(self, x: jnp.ndarray, mask: jnp.ndarray, h_tail=None):
        d = x.shape[-1]
        gates = Dense(2 * d, dtype=self.dtype, param_dtype=jnp.float32,
                         name="pw_in")(x)
        hcurr = gates[..., :d] * jax.nn.sigmoid(gates[..., d:])
        # zero padded frames BEFORE the depthwise conv so padding cannot
        # leak through its receptive field (models/conv.py convention)
        hcurr = hcurr * mask[:, :, None].astype(hcurr.dtype)
        kt = self.kernel
        if h_tail is not None:
            cat = jnp.concatenate([h_tail, hcurr], axis=1)  # [B, k−1+T, d]
            new_tail = cat[:, -(kt - 1):]
            hcurr = Conv(d, (kt,), padding="VALID", feature_group_count=d,
                         dtype=self.dtype, param_dtype=jnp.float32,
                         name="dw")(cat)
        else:
            pad = ((kt - 1, 0),) if self.causal else (((kt - 1) // 2, kt // 2),)
            hcurr = Conv(d, (kt,), padding=pad, feature_group_count=d,
                         dtype=self.dtype, param_dtype=jnp.float32,
                         name="dw")(hcurr)
        hcurr = LayerNorm(dtype=jnp.float32, name="ln")(
            hcurr.astype(jnp.float32))
        hcurr = jax.nn.swish(hcurr).astype(self.dtype)
        out = Dense(d, dtype=self.dtype, param_dtype=jnp.float32,
                       name="pw_out")(hcurr)
        if h_tail is not None:
            return out, new_tail
        return out


class _FFN(Module):
    """Position-wise feed-forward (swish), the macaron half-step."""

    mult: int
    dtype: jnp.dtype

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        d = x.shape[-1]
        hcurr = Dense(self.mult * d, dtype=self.dtype,
                      param_dtype=jnp.float32, name="in")(x)
        hcurr = jax.nn.swish(hcurr)
        return Dense(d, dtype=self.dtype, param_dtype=jnp.float32,
                     name="out")(hcurr)


class ConformerBlock(Module):
    """One macaron block: ½FFN → MHSA → conv module → ½FFN → final LN.

    [B, T, d] fp32 residual stream in, same out (padded frames zeroed).

    ``chunk > 0``: chunk-causal attention + causal depthwise conv (the
    streaming attention family). A streaming step passes ``carries``
    ``(k_cache, v_cache, h_tail)`` + ``cache_mask`` [B, P] (which cached
    keys are valid — computed by the model from global positions) +
    ``pos0`` [B] (global index of frame 0) and receives
    ``(out, new_carries)``; parameters are identical to the offline
    call, so a chunk-causally trained checkpoint serves online directly.
    """

    heads: int = 4
    ff_mult: int = 4
    conv_kernel: int = 15
    dtype: jnp.dtype = jnp.bfloat16
    chunk: int = 0
    left_chunks: int = 0
    residual_dtype: jnp.dtype = jnp.float32
                                       # bf16 halves the residual stream's
                                       # memory traffic (the 4 LN reads + 4
                                       # adds per block are bandwidth-
                                       # bound); LN statistics ALWAYS
                                       # compute fp32 (LayerNorm
                                       # dtype=fp32 upcasts its input)

    def __call__(self, x: jnp.ndarray, lengths: jnp.ndarray, carries=None,
                 cache_mask: jnp.ndarray | None = None,
                 pos0: jnp.ndarray | None = None):
        stream = carries is not None
        mask = time_mask(x.shape[1], lengths)                    # [B, T]
        rdt = self.residual_dtype
        x = x.astype(rdt)
        ln = lambda name: LayerNorm(dtype=jnp.float32, name=name)

        def pre(name, xx):                  # pre-norm, bf16 for the matmuls
            return ln(name)(xx).astype(self.dtype)

        x = x + (0.5 * _FFN(self.ff_mult, self.dtype, name="ffn1")(
            pre("ln_ffn1", x)).astype(jnp.float32)).astype(rdt)
        mhsa = _MHSA(self.heads, self.dtype, chunk=self.chunk,
                     left_chunks=self.left_chunks, name="mhsa")
        if stream:
            att, new_kv = mhsa(pre("ln_mhsa", x), mask,
                               kv_cache=(carries[0], carries[1]),
                               cache_mask=cache_mask, pos0=pos0)
        else:
            att = mhsa(pre("ln_mhsa", x), mask, pos0=pos0)
        x = x + att.astype(rdt)
        conv = _ConvModule(self.conv_kernel, self.dtype,
                           causal=self.chunk > 0, name="conv")
        if stream:
            cv, new_tail = conv(pre("ln_conv", x), mask, h_tail=carries[2])
        else:
            cv = conv(pre("ln_conv", x), mask)
        x = x + cv.astype(rdt)
        x = x + (0.5 * _FFN(self.ff_mult, self.dtype, name="ffn2")(
            pre("ln_ffn2", x)).astype(jnp.float32)).astype(rdt)
        x = ln("ln_out")(x).astype(rdt)     # inter-block tensor stays rdt
        x = x * mask[:, :, None].astype(x.dtype)
        if stream:
            return x, (new_kv[0], new_kv[1], new_tail)
        return x
