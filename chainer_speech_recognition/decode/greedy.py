"""On-device greedy (best-path) CTC decoding — argmax → collapse repeats →
drop blanks, with lengths masked in-kernel (BASELINE.json:5; SURVEY.md §2.5).

Everything is static-shape: the decoded batch comes back as a dense
[B, max_len] id matrix (PAD_LABEL_ID-filled) plus per-utterance lengths, so
the whole decode step stays inside one jit with no host round-trip until
detokenization.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import BLANK_ID, PAD_LABEL_ID


@functools.partial(jax.jit, static_argnames=("max_len",))
def greedy_decode(
    logits: jnp.ndarray,        # [B, T, V]
    lengths: jnp.ndarray,       # [B] valid frame counts
    max_len: int | None = None, # output capacity (default T)
):
    """Returns (ids [B, max_len] int32 padded with PAD_LABEL_ID, out_lens [B])."""
    B, T, V = logits.shape
    max_len = max_len or T
    best = jnp.argmax(logits, axis=-1).astype(jnp.int32)          # [B, T]
    prev = jnp.concatenate(
        [jnp.full((B, 1), BLANK_ID, jnp.int32), best[:, :-1]], axis=1)
    valid = jnp.arange(T, dtype=jnp.int32)[None, :] < lengths[:, None]
    keep = (best != BLANK_ID) & (best != prev) & valid            # [B, T]
    # compact kept symbols to the front: out[b, cumsum(keep)-1] = best.
    # out_lens is CLAMPED to max_len — callers slice ids[b, :out_lens[b]],
    # so a length exceeding the matrix width would walk into pads.
    pos = jnp.cumsum(keep.astype(jnp.int32), axis=1) - 1          # [B, T]
    out_lens = jnp.minimum(pos[:, -1] + 1, max_len)
    # scatter via one-hot matmul-free approach: dump non-kept AND
    # overflow (pos >= max_len) symbols to the trash slot explicitly —
    # correctness must not lean on default out-of-bounds scatter modes
    slot = jnp.where(keep, jnp.minimum(pos, max_len), max_len)    # [B, T]
    out = jnp.full((B, max_len + 1), PAD_LABEL_ID, jnp.int32)
    out = out.at[jnp.arange(B)[:, None], slot].set(
        jnp.where(keep, best, PAD_LABEL_ID))
    return out[:, :max_len], out_lens


def greedy_decode_np(logits, length):
    """Host reference: single utterance, for oracle tests."""
    import numpy as np
    best = np.argmax(np.asarray(logits)[:length], axis=-1)
    out, prev = [], BLANK_ID
    for b in best:
        if b != BLANK_ID and b != prev:
            out.append(int(b))
        prev = b
    return out
