"""Analytic model-FLOPs accounting for MFU reporting.

Counts matmul/conv MACs×2 of the acoustic model forward pass at a bucket's
PADDED shapes (what the device actually executes); the train step is taken
as 3× forward (backward ≈ 2× forward for matmul-dominated graphs). The
DFT/mel front-end and the CTC recursion are excluded — they are a small
share of model FLOPs at contract shapes and not matmuls; MFU here therefore
slightly UNDER-counts true device work (conservative).
"""

from __future__ import annotations

import math

from .. import constants as C
from ..config import ModelConfig

# Published dense peaks per device, keyed by ``jax.devices()[i].device_kind``.
# Source: NVIDIA H100 Tensor Core GPU data sheet (SXM part, without
# sparsity), at the card's full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "hbm_tbps": 3.35},
}


def device_peaks(device_kind: str) -> dict:
    """Peak rates of ``device_kind``; an unknown device is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       f"known: {sorted(PEAKS)}") from None


def forward_flops_per_utt(cfg: ModelConfig, frames: int,
                          n_mels: int = C.N_MELS,
                          channels: int = C.N_FEATURE_CHANNELS) -> float:
    """Matmul FLOPs of one forward pass on one padded utterance."""
    t, f = frames, n_mels
    cin = channels
    kt, kf = cfg.conv_kernel
    total = 0.0
    for i, ch in enumerate(cfg.conv_channels):
        t = -(-t // cfg.conv_stride_time[i])
        f = -(-f // cfg.conv_stride_freq[i])
        total += 2.0 * t * f * ch * (cin * kt * kf)
        cin = ch
    d = f * cin                                   # flattened conv output dim

    for i in range(cfg.glu_blocks):
        ch = cfg.glu_channels
        total += 2.0 * t * (2 * ch) * (d * 5)     # GLU gate conv (kt=5)
        if d != ch:
            total += 2.0 * t * ch * d             # residual projection
        d = ch

    if cfg.attn_blocks:
        dm = cfg.attn_dim
        if d != dm:
            total += 2.0 * t * d * dm             # attn_in projection
        per_block = 4 * 2.0 * t * dm * dm         # q,k,v,out projections
        # chunk-causal attention bounds each query's key extent to its own
        # chunk + attn_left_chunks cached chunks; global attention sees t
        keys = (min(t, cfg.attn_chunk * (cfg.attn_left_chunks + 1))
                if cfg.attn_chunk else t)
        per_block += 2 * 2.0 * t * keys * dm      # scores + value einsums
        per_block += 2 * 2 * 2.0 * t * dm * (cfg.attn_ff_mult * dm)  # 2 FFNs
        per_block += 2.0 * t * dm * 2 * dm        # conv module pw_in (GLU)
        per_block += 2.0 * t * dm * dm            # conv module pw_out
        total += cfg.attn_blocks * per_block      # (depthwise conv ~0)
        d = dm

    if cfg.rnn_type != "none":
        gates = {"gru": 3, "lstm": 4}[cfg.rnn_type]
        h = cfg.rnn_hidden
        for i in range(cfg.rnn_layers):
            per_dir = 2.0 * t * (d * gates * h)   # hoisted input projection
            per_dir += 2.0 * t * (h * gates * h)  # recurrent matmul
            total += 2 * per_dir                  # both directions
            d = 2 * h

    if cfg.proj_dim:
        total += 2.0 * t * d * cfg.proj_dim
        d = cfg.proj_dim
    total += 2.0 * t * d * cfg.vocab_size
    return total


def train_flops_per_utt(cfg: ModelConfig, frames: int) -> float:
    return 3.0 * forward_flops_per_utt(cfg, frames)


def mfu(flops_per_sec_per_device: float, device_kind: str) -> float | None:
    """Achieved over peak bf16 FLOP/s; None for a non-finite rate."""
    peak = device_peaks(device_kind)["bf16_tflops"]
    if not math.isfinite(flops_per_sec_per_device):
        return None
    return flops_per_sec_per_device / (peak * 1e12)
