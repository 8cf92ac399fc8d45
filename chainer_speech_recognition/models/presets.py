"""Acoustic model assembly + the model registry (SURVEY.md §2.3).

One config-driven builder covers the three contract presets
(BASELINE.json:7-9): ``tiny_conv`` (config 1), ``bigru`` (config 2),
``bilstm_deep`` (config 3). The forward contract mirrors the reference:
``forward(features [B,T,F,3], frame_lengths) → (logits [B,T',V], out_lengths)``
with V including the CTC blank at index 0.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import ModelConfig
from .attention import ConformerBlock
from .conv import ConvSubsampler, GLUConvBlock
from .layers import Dense, Module
from .rnn import BiRNNLayer, time_mask


class AcousticModel(Module):
    cfg: ModelConfig

    def __call__(self, feats: jnp.ndarray, lengths: jnp.ndarray,
                 rnn_carries=None, carry_at: int | None = None,
                 drop_left: int = 0):
        """Full-utterance call: ``(feats [B,T,F,3], lengths) → (logits, lens)``.

        Streaming call (decode/streaming.py): ``rnn_carries`` is the list
        of per-layer forward-direction states carried from the previous
        chunk ([] for conv-only models), ``carry_at`` the static chunk
        length in SUBSAMPLED frames, and ``drop_left`` the number of
        subsampled left-margin frames to discard after the conv stack
        (they only exist to give the convs a real receptive field at the
        window edge). Returns ``(logits, lens, new_carries)``; parameters
        are identical to the full-utterance call, so any trained
        checkpoint can be served streaming.
        """
        cfg = self.cfg
        stream = rnn_carries is not None
        if stream and carry_at is None:
            raise ValueError("streaming call needs carry_at")
        dtype = jnp.dtype(cfg.compute_dtype)
        x, lens = ConvSubsampler(
            channels=tuple(cfg.conv_channels),
            kernel=tuple(cfg.conv_kernel),
            stride_time=tuple(cfg.conv_stride_time),
            stride_freq=tuple(cfg.conv_stride_freq),
            dtype=dtype,
        )(feats.astype(dtype), lengths)

        for i in range(cfg.glu_blocks):
            x = GLUConvBlock(channels=cfg.glu_channels, dtype=dtype,
                             name=f"glu{i}")(x, lens)

        if drop_left:
            x = x[:, drop_left:]
            lens = jnp.maximum(lens - drop_left, 0)

        new_carries = []
        rnn_off = 0
        if cfg.attn_blocks:
            if stream and not cfg.attn_chunk:
                # full self-attention has a GLOBAL receptive field: a
                # chunked call cannot reproduce the offline computation,
                # so streaming refuses loudly instead of silently
                # degrading (decode/streaming.py guards on this too).
                # Chunk-causal presets (attn_chunk > 0) DO stream — the
                # offline forward applies the identical chunk mask.
                raise ValueError(
                    "global-attention presets do not support streaming "
                    "calls; train a chunk-causal preset (attn_chunk > 0, "
                    "e.g. conformer_stream) to serve attention online")
            if x.shape[-1] != cfg.attn_dim:
                x = Dense(cfg.attn_dim, dtype=dtype,
                          param_dtype=jnp.float32, name="attn_in")(x)
            cache_mask = pos0 = None
            if stream:
                # model-level stream carries (init_stream_carries layout):
                # [pos0, total_valid, seg_start] + 3 per block. pos0 is
                # each row's global subsampled index of window frame 0;
                # a cached key slot is valid iff its global position has
                # been fed real audio (< total_valid) and is not behind
                # an endpoint boundary (>= seg_start) — garbage k/v from
                # padded frames enter the rolled cache positionally but
                # can never be attended (exact offline equality).
                P = cfg.attn_chunk * cfg.attn_left_chunks
                pos0, total_valid, seg_start = rnn_carries[:3]
                kpos = (pos0[:, None] - P
                        + jnp.arange(P, dtype=jnp.int32)[None, :])  # [B, P]
                cache_mask = ((kpos >= 0)
                              & (kpos >= seg_start[:, None])
                              & (kpos < total_valid[:, None]))
                new_carries += [
                    pos0 + cfg.attn_chunk,
                    total_valid + lens.astype(jnp.int32),
                    seg_start,
                ]
                rnn_off = 3 + 3 * cfg.attn_blocks
            for i in range(cfg.attn_blocks):
                block = ConformerBlock(
                    heads=cfg.attn_heads, ff_mult=cfg.attn_ff_mult,
                    conv_kernel=cfg.attn_conv_kernel, dtype=dtype,
                    chunk=cfg.attn_chunk, left_chunks=cfg.attn_left_chunks,
                    residual_dtype=jnp.dtype(cfg.attn_residual_dtype),
                    name=f"conformer{i}")
                if stream:
                    x, blk_carries = block(
                        x, lens, carries=rnn_carries[3 + 3 * i : 6 + 3 * i],
                        cache_mask=cache_mask, pos0=pos0)
                    new_carries += list(blk_carries)
                else:
                    x = block(x, lens)

        if cfg.rnn_type != "none":
            for i in range(cfg.rnn_layers):
                layer = BiRNNLayer(
                    hidden=cfg.rnn_hidden, cell=cfg.rnn_type, dtype=dtype,
                    remat=cfg.remat_rnn,
                    bidirectional=cfg.rnn_bidirectional, name=f"birnn{i}",
                )
                if stream:
                    x, h = layer(x, lens, h0_fwd=rnn_carries[rnn_off + i],
                                 emit_carry_at=carry_at)
                    new_carries.append(h)
                else:
                    x = layer(x, lens)

        if cfg.proj_dim:
            x = jnp.tanh(Dense(cfg.proj_dim, dtype=dtype,
                               param_dtype=jnp.float32, name="proj")(x))
        # fp32 logits: CTC math is fp32 (BASELINE.json:5)
        logits = Dense(cfg.vocab_size, dtype=jnp.float32,
                       param_dtype=jnp.float32,
                       name="output")(x.astype(jnp.float32))
        mask = time_mask(logits.shape[1], lens)
        logits = logits * mask[:, :, None]
        if stream:
            return logits, lens, new_carries
        return logits, lens

    def subsample_factor(self) -> int:
        f = 1
        for s in self.cfg.conv_stride_time:
            f *= s
        return f

    def init_stream_carries(self, batch: int) -> list:
        """Zero stream state for a fresh stream — a FLAT list of arrays
        (decode/streaming.py reshards and endpoint-resets them
        uniformly). Layout: chunk-causal attention carries first
        (``[pos0, total_valid, seg_start]`` + per block
        ``[k_cache, v_cache, conv_tail]``), then one forward-direction
        state per BiRNN layer; [] for conv-only models."""
        cfg = self.cfg
        carries: list = []
        if cfg.attn_blocks and cfg.attn_chunk:
            if cfg.attn_left_chunks < 1:
                raise ValueError("attn_chunk > 0 needs attn_left_chunks >= 1")
            P = cfg.attn_chunk * cfg.attn_left_chunks
            dh = cfg.attn_dim // cfg.attn_heads
            cdt = jnp.dtype(cfg.compute_dtype)
            carries += [jnp.zeros((batch,), jnp.int32) for _ in range(3)]
            for _ in range(cfg.attn_blocks):
                carries += [
                    jnp.zeros((batch, P, cfg.attn_heads, dh), cdt),  # k
                    jnp.zeros((batch, P, cfg.attn_heads, dh), cdt),  # v
                    jnp.zeros((batch, cfg.attn_conv_kernel - 1,
                               cfg.attn_dim), cdt),                  # conv
                ]
        if cfg.rnn_type != "none":
            dim = cfg.rnn_hidden * (2 if cfg.rnn_type == "lstm" else 1)
            carries += [jnp.zeros((batch, dim), jnp.float32)
                        for _ in range(cfg.rnn_layers)]
        return carries

    def reset_stream_rows(self, carries: list, rows) -> list:
        """Endpoint reset (decode/streaming.py): start a fresh utterance on
        ``rows`` without touching other lockstep streams. RNN states and
        the causal-conv tails zero (== the offline left edge); the
        attention KV caches stay — ``seg_start`` advances to the frames
        already seen, so pre-boundary keys simply become unattendable
        (cheaper than zeroing, and keeps per-row position bookkeeping
        exact). ``pos0``/``total_valid`` keep counting: RoPE scores
        depend only on relative offsets, so the absolute origin is free."""
        cfg = self.cfg
        out = list(carries)
        off = 0
        if cfg.attn_blocks and cfg.attn_chunk:
            pos0, total_valid, seg_start = carries[:3]
            out[2] = seg_start.at[rows].set(total_valid[rows])
            for i in range(cfg.attn_blocks):
                j = 3 + 3 * i + 2                       # conv_tail
                out[j] = carries[j].at[rows].set(0.0)
            off = 3 + 3 * cfg.attn_blocks
        for i in range(off, len(carries)):
            out[i] = carries[i].at[rows].set(0.0)
        return out

    def conv_receptive_margin(self) -> int:
        """Input-frame margin that fully covers the conv (+GLU) stack's
        one-sided receptive field: window-edge conv outputs farther than
        this many INPUT frames from the edge are identical to the
        full-utterance computation (decode/streaming.py uses it as the
        left-margin floor)."""
        cfg = self.cfg
        kt = cfg.conv_kernel[0]
        rf, jump = 1, 1                    # receptive field, input stride
        for st in cfg.conv_stride_time:
            rf += (kt - 1) * jump
            jump *= st
        # GLU blocks run at the subsampled rate; extent derives from the
        # module's actual kernel_time so the two cannot drift apart
        rf += cfg.glu_blocks * (GLUConvBlock.kernel_time - 1) * jump
        return (rf - 1) // 2 + 1

    def conv_right_margin(self) -> int:
        """INPUT frames of real future context past a chunk's emit region
        needed for the emitted conv outputs to equal the full-utterance
        computation — the streaming ``right_frames`` floor for conv
        exactness (decode/streaming.py ``stream_geometry``).

        With the stack's explicit ((k−1)//2, k//2) padding, the rightmost
        input of output ``p`` is ``p·S + O`` where ``O = Σᵢ (kᵢ//2)·Jᵢ``
        (Jᵢ = input jump at layer i, S = total stride); the last emitted
        output therefore reaches ``max(0, O − S + 1)`` frames past the
        emit region. 0 for the plain subsampling stacks (their per-layer
        reach k//2 < stride), 48 for ``glu_conv`` (6 stride-1 GLU blocks
        of time-kernel 5 at jump 4)."""
        cfg = self.cfg
        kt = cfg.conv_kernel[0]
        off, jump = 0, 1
        for st in cfg.conv_stride_time:
            off += (kt // 2) * jump
            jump *= st
        off += cfg.glu_blocks * (GLUConvBlock.kernel_time // 2) * jump
        return max(0, off - jump + 1)


def build_model(cfg: ModelConfig) -> AcousticModel:
    """Registry entry point: every preset is expressed as a ModelConfig."""
    return AcousticModel(cfg)
