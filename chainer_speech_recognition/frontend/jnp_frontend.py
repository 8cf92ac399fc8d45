"""Device (JAX/XLA) audio front-end, batched + length-masked.

Computes exactly the golden pipeline (``golden_np.py``) on padded batches:
for every utterance ``b`` with ``num_samples[b] = L >= N_FFT//2 + 1``
(257 samples = 16 ms), the first ``1 + L // HOP`` frames of the output are
bit-comparable (fp32-allclose) to ``golden_np.features(signal[:L])``;
frames beyond that are zeros. Sub-257-sample utterances — shorter than
one reflection pad, i.e. below any real speech — still produce finite,
masked features, but their start/end reflections read zero padding where
the golden oracle multi-reflects inside the utterance, so they are NOT
bit-golden (documented limitation, also in README; an exact fix needs a
per-utterance mirror gather that would tax the hot path ~15% for inputs
that do not occur in practice).

Design notes (written gather-free on the hot path; whether a gather
version is faster on a GPU is not measured):
* Framing + centered reflect padding use NO gather: the padded signal is
  reshaped to hop-sized rows and overlapping frames are assembled from FOUR
  static shifted slices (HOP=160, N_FFT=512 ⇒ 512 = 3·160 + 32). The only
  dynamic work is writing each utterance's 256 end-reflection samples —
  one tiny [B, pad] gather + per-row dynamic_update_slice.
* The mel projection is a single fp32 matmul at HIGHEST precision; STFT
  is ``jnp.fft.rfft`` (cuFFT on the GPU); elementwise stages fuse.
* Δ/ΔΔ use shift-by-concat over time plus a [B, T, 1]-index gather (slice
  size n_mels) only to realize per-utterance edge replication — index count
  is B·T, not B·T·n_mels.

Reference parity anchor: BASELINE.json:5 ("framing, STFT, mel filterbank,
log-compression, delta/delta-delta features, utterance-level CMVN ... fused
JAX/Pallas kernels feeding a device-resident padded-batch").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from .golden_np import hann_periodic, mel_filterbank

__all__ = ["batch_features", "frame_lengths", "extend_signal", "frame_signal"]

_PAD = C.N_FFT // 2                      # 256: centered-STFT reflect pad
_K = C.N_FFT // C.HOP_LENGTH             # full hop rows per frame (3)


def frame_lengths(num_samples: jnp.ndarray) -> jnp.ndarray:
    """Per-utterance valid frame counts: 1 + L // HOP."""
    return 1 + num_samples // C.HOP_LENGTH


@functools.lru_cache(maxsize=None)
def _tables():
    win = hann_periodic(C.WIN_LENGTH)
    lpad = (C.N_FFT - C.WIN_LENGTH) // 2
    win_full = np.zeros(C.N_FFT, dtype=np.float32)
    win_full[lpad : lpad + C.WIN_LENGTH] = win.astype(np.float32)
    mel = mel_filterbank().T                               # [n_bins, n_mels]
    return win_full, mel


def extend_signal(signals: jnp.ndarray, lengths: jnp.ndarray,
                  n_rows: int) -> jnp.ndarray:
    """[B, N] → [B, n_rows·HOP] centered-reflect-extended signal.

    Position p of the result corresponds to original sample ``p - _PAD``:
    the first _PAD samples are the static start reflection, and each
    utterance's end reflection (samples L..L+_PAD-1 ≘ x[L-2]..x[L-1-_PAD])
    is written at its dynamic offset. Samples between the end reflection
    and the next utterance's padding stay zero (they only feed frames that
    are masked out).

    (A gather-free one-hot-einsum ADD placement of the tail was measured
    0.5 ms SLOWER than this batched dynamic_update_slice at B64×1024
    frames — tiny-contraction batched matmuls lower poorly — so the
    scatter stays.)
    """
    B, N = signals.shape
    total = n_rows * C.HOP_LENGTH
    x = signals.astype(jnp.float32)
    head = x[:, 1 : _PAD + 1][:, ::-1]                     # reflect at start
    body_len = total - _PAD
    if body_len <= N:
        body = x[:, :body_len]
    else:
        body = jnp.pad(x, ((0, 0), (0, body_len - N)))
    ext = jnp.concatenate([head, body], axis=1)            # [B, total]

    # end reflection: tail[k] = x[L - 2 - k], k = 0.._PAD-1 (tiny gather)
    k = jnp.arange(_PAD, dtype=jnp.int32)[None, :]
    src = jnp.clip(lengths[:, None] - 2 - k, 0, N - 1)
    tail = jnp.take_along_axis(x, src, axis=1)             # [B, _PAD]

    def put(row, t, off):
        return jax.lax.dynamic_update_slice(row, t, (off,))

    off = jnp.clip(lengths + _PAD, 0, total - _PAD).astype(jnp.int32)
    return jax.vmap(put)(ext, tail, off)


def frame_signal(ext: jnp.ndarray, n_frames: int) -> jnp.ndarray:
    """Extended signal [B, rows·HOP] → frames [B, n_frames, N_FFT] with NO
    gather: hop-rows + _K+1 static shifted slices concatenated."""
    B, total = ext.shape
    rows = total // C.HOP_LENGTH
    A = ext.reshape(B, rows, C.HOP_LENGTH)
    parts = [A[:, s : s + n_frames] for s in range(_K)]
    rem = C.N_FFT - _K * C.HOP_LENGTH                      # 32
    if rem > 0:
        parts.append(A[:, _K : _K + n_frames, :rem])
    return jnp.concatenate(parts, axis=2)                  # [B, T, N_FFT]


def _delta(x: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """Regression deltas over time with per-utterance edge replication:
    out[t] = Σₙ n·(x[min(t+n, L-1)] − x[max(t−n, 0)]) / denom.

    ONE edge-padded array + static slices (XLA fuses slices into the add
    chain — the per-shift concat formulation materialized ~4 full [B,T,F]
    intermediates per delta order); the per-utterance end edge (clip at
    L−1, not T−1) is a single [B,1,F] gather + one where per positive
    shift. Start edges (clip at 0) are static and exact by construction.
    """
    K = C.DELTA_WINDOW
    denom = 2.0 * sum(n * n for n in range(1, K + 1))
    T = x.shape[1]
    xp = jnp.concatenate(
        [x[:, :1]] * K + [x] + [x[:, -1:]] * K, axis=1)    # [B, T+2K, F]
    t = jnp.arange(T, dtype=jnp.int32)[None, :]
    last = jnp.take_along_axis(
        x, (jnp.maximum(lengths - 1, 0))[:, None, None], axis=1)  # [B,1,F]
    out = jnp.zeros_like(x)
    for n in range(1, K + 1):
        plus = xp[:, K + n : K + n + T]
        over = (t + n) >= lengths[:, None]                 # [B, T]
        plus = jnp.where(over[:, :, None], last, plus)
        minus = xp[:, K - n : K - n + T]
        out = out + n * (plus - minus)
    return out / denom


def logmel_from_extended(ext: jnp.ndarray, t_max: int) -> jnp.ndarray:
    """Extended signal rows → [B, t_max, n_mels] log-mel. THE shared
    spectral pipeline (frame → window → rfft power → mel → log) of the
    offline path below and the streaming window path
    (decode/streaming.py) — one definition, so the streaming == offline
    exactness contract cannot drift."""
    win_full, mel = _tables()
    frames = frame_signal(ext, t_max) * jnp.asarray(win_full)[None, None, :]
    spec = jnp.fft.rfft(frames, n=C.N_FFT, axis=-1)
    power = (spec.real.astype(jnp.float32) ** 2
             + spec.imag.astype(jnp.float32) ** 2)
    # HIGHEST precision: the parity gate is fp32-allclose vs the golden
    # oracle, and default precision may take reduced-precision fast paths
    # (TF32 on the GPU) that cost ~4e-3 relative error in the log-mel output.
    melspec = jnp.einsum("btf,fm->btm", power, jnp.asarray(mel),
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
    return jnp.log(jnp.maximum(melspec, C.LOG_EPS))         # [B, T, n_mels]


@functools.partial(jax.jit, static_argnames=("apply_cmvn",))
def batch_features(
    signals: jnp.ndarray,       # [B, N_max] float32 PCM (padded)
    num_samples: jnp.ndarray,   # [B] int32 valid sample counts
    apply_cmvn: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Padded batch of signals → ([B, T_max, n_mels, 3] fp32, [B] frame lens)."""
    B, n_max = signals.shape
    t_max = C.num_frames(n_max)
    lengths = num_samples.astype(jnp.int32)

    # --- framing (no gather: reflect-extend + static shifted slices) -----
    n_rows = t_max + _K + 1
    ext = extend_signal(signals, lengths, n_rows)
    logmel = logmel_from_extended(ext, t_max)

    return postprocess_logmel(logmel, lengths, t_max, apply_cmvn)


def cmvn_causal_jnp(logmel: jnp.ndarray, tmask: jnp.ndarray,
                    carry=None, carry_index: int | None = None):
    """Causal CMVN (frame ``t`` normalized by running stats of frames
    ``0..t``): the streamable alternative to utterance CMVN — see
    ``golden_np.cmvn_causal`` for semantics and the chunk-invariance
    contract. ``carry`` (cnt [B,1,1], Σx, Σx² [B,1,F]) holds the stats of
    frames BEFORE this window (streaming chunks); returns the normalized
    window plus the stats through frame ``carry_index`` (exclusive; default:
    the final VALID frame of the window) so a caller can chain chunks
    exactly — a streaming step whose next window re-reads some margin
    frames passes the margin start as ``carry_index``."""
    m = tmask[..., None].astype(jnp.float32)
    if carry is None:
        # fp32 one-pass E[x²]−E[x]² cancels catastrophically at log-mel
        # magnitudes (x ≈ −23, var ≈ 1 ⇒ ~3 digits lost); running the
        # moments on the variance-invariant shifted stream x − x[0]
        # keeps them at deviation scale. The offset rides in the carry so
        # chunked computation stays exactly equivalent.
        off = logmel[:, :1]                     # first frame (always valid)
        c0 = s0 = q0 = 0.0
    else:
        c0, s0, q0, off = carry
    x = (logmel - off) * m
    cnt_true = jnp.cumsum(m, axis=1) + c0        # unfloored, for the carry
    cnt = jnp.maximum(cnt_true, 1.0)
    s1 = jnp.cumsum(x, axis=1) + s0
    s2 = jnp.cumsum(x * x, axis=1) + q0
    mean = s1 / cnt
    var = jnp.maximum(s2 / cnt - mean * mean, 0.0)
    out = (x - mean) * jax.lax.rsqrt(var + C.CMVN_VAR_EPS) * m
    j = -1 if carry_index is None else carry_index - 1
    if carry_index == 0:       # carry stats through frame -1 = the input carry
        z = jnp.zeros_like(s1[:, :1])
        new_carry = ((jnp.zeros_like(cnt_true[:, :1]) + c0, z + s0, z + q0, off)
                     if carry is not None else
                     (jnp.zeros_like(cnt_true[:, :1]), z, z, off))
    else:
        new_carry = (cnt_true[:, j:][:, :1], s1[:, j:][:, :1],
                     s2[:, j:][:, :1], off)
    return out, new_carry


def postprocess_logmel(logmel, lengths, t_max: int, apply_cmvn):
    """Tail of the front-end: padding mask →
    CMVN over valid frames → Δ/ΔΔ with edge replication → channel stack.
    One implementation so the two cannot silently diverge on these
    semantics.

    ``apply_cmvn``: False (off) | True / "utterance" (per-utterance stats,
    the reference's convention) | "causal" (running stats up to each frame
    — the streamable mode, features.cmvn_mode="causal")."""
    flens = frame_lengths(lengths)                          # [B]
    tmask = (jnp.arange(t_max)[None, :] < flens[:, None])   # [B, T]
    logmel = logmel * tmask[..., None]                      # zero padded frames

    if apply_cmvn == "causal":
        logmel, _ = cmvn_causal_jnp(logmel, tmask)
    elif apply_cmvn:
        # --- per-utterance CMVN over valid frames -------------------------
        m = tmask[..., None].astype(jnp.float32)
        cnt = jnp.maximum(jnp.sum(m, axis=1, keepdims=True), 1.0)
        mean = jnp.sum(logmel * m, axis=1, keepdims=True) / cnt
        var = jnp.sum(jnp.square(logmel - mean) * m, axis=1, keepdims=True) / cnt
        logmel = (logmel - mean) * jax.lax.rsqrt(var + C.CMVN_VAR_EPS)
        logmel = logmel * m                                 # re-zero padding

    # --- Δ / ΔΔ with edge replication at each utterance's true edge -------
    d1 = _delta(logmel, flens)
    d2 = _delta(d1, flens)
    feats = jnp.stack([logmel, d1, d2], axis=-1)            # [B, T, n_mels, 3]
    feats = feats * tmask[..., None, None].astype(feats.dtype)
    return feats.astype(jnp.float32), flens
