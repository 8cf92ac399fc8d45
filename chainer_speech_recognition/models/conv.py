"""Strided 2-D conv subsampling stack (SURVEY.md §2.3, BASELINE.json:5).

Reduces time (and mel) resolution before the recurrent stack — the reference's
conv front of the acoustic model. Details:

* explicit (k-1)//2 / k//2 padding instead of SAME so each output frame's
  receptive field is independent of the padded batch length — per-utterance
  and batched computation agree exactly on valid frames;
* time-masking after EVERY conv layer so batch padding can never leak into
  valid frames through overlapping receptive fields;
* bf16 compute dtype / fp32 params by default (tensor-core friendly).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .layers import Conv, Dense, Module


def conv_out_length(lengths: jnp.ndarray, stride: int) -> jnp.ndarray:
    """ceil(len / stride) — matches explicit-pad strided conv output size."""
    return -(-lengths // stride)


class GLUConvBlock(Module):
    """GLU-gated residual 1-D conv block over time (SURVEY.md §2.3 notes the
    reference author's models featured GLU-gated residual conv stacks —
    musyoku's conv-only CTC architectures). Operates on [B, T, D]:
    ``y = x + (conv_a(x) * sigmoid(conv_b(x))) @ proj`` with time masking.
    """

    channels: int
    kernel_time: int = 5
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, x: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
        kt = self.kernel_time
        pad = ((kt - 1) // 2, kt // 2)
        gates = Conv(2 * self.channels, (kt,), padding=(pad,),
                        dtype=self.dtype, param_dtype=jnp.float32,
                        name="glu_conv")(x)
        a, b = gates[..., : self.channels], gates[..., self.channels:]
        h = a * jax.nn.sigmoid(b)
        if x.shape[-1] != self.channels:
            x = Dense(self.channels, dtype=self.dtype,
                         param_dtype=jnp.float32, name="res_proj")(x)
        y = x + h
        tmask = (jnp.arange(y.shape[1])[None, :] < lengths[:, None])
        return y * tmask[:, :, None].astype(y.dtype)


class ConvSubsampler(Module):
    channels: tuple[int, ...]
    kernel: tuple[int, int]
    stride_time: tuple[int, ...]
    stride_freq: tuple[int, ...]
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, x: jnp.ndarray, lengths: jnp.ndarray):
        """[B, T, F, C], [B] → ([B, T', F'·C'], [B] subsampled lengths)."""
        kt, kf = self.kernel
        pad = ((kt - 1) // 2, kt // 2), ((kf - 1) // 2, kf // 2)
        for i, ch in enumerate(self.channels):
            st, sf = self.stride_time[i], self.stride_freq[i]
            x = Conv(
                ch, self.kernel, strides=(st, sf), padding=pad,
                dtype=self.dtype, param_dtype=jnp.float32, name=f"conv{i}",
            )(x)
            x = jax.nn.relu(x)
            lengths = conv_out_length(lengths, st)
            tmask = (jnp.arange(x.shape[1])[None, :] < lengths[:, None])
            x = x * tmask[:, :, None, None].astype(x.dtype)
        B, T, F, C = x.shape
        return x.reshape(B, T, F * C), lengths
