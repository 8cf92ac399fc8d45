"""Attention (Conformer-style) model family tests: shapes, exact
batch-padding invariance (SURVEY.md §7 hard-part 6 applies to every model
family), RoPE relative-position property, DP equality on the fake-device
mesh, toy learnability, and the streaming guard (global receptive field
⇒ streaming must refuse loudly)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chainer_speech_recognition.config import preset_config
from chainer_speech_recognition.decode.greedy import greedy_decode
from chainer_speech_recognition.decode.streaming import stream_geometry
from chainer_speech_recognition.models.attention import rope
from chainer_speech_recognition.models.presets import build_model
from chainer_speech_recognition.parallel.mesh import make_mesh, shard_batch
from chainer_speech_recognition.train.step import (make_eval_step,
                                                       make_train_step)

from test_train import _fixed_batch, _init


def _cfg(**over):
    return preset_config("conformer").override({
        "model.vocab_size": 9, "model.compute_dtype": "float32",
        "model.attn_blocks": 1, "model.attn_dim": 32, "model.attn_heads": 4,
        "specaugment.enabled": False,
        "optim.learning_rate": 3e-3, "optim.warmup_steps": 20,
        "optim.decay_steps": 400, **over})


def _tiny_model(**over):
    cfg = _cfg().model
    return build_model(type(cfg)(**{**cfg.__dict__, **over}))


def test_conformer_shapes():
    model = _tiny_model(attn_blocks=2)
    B, T, F = 2, 37, 40
    x = jnp.asarray(np.random.default_rng(0).standard_normal((B, T, F, 3)),
                    jnp.float32)
    lens = jnp.asarray([37, 16])
    params = jax.jit(model.init)(jax.random.key(0), x, lens)
    logits, olens = jax.jit(model.apply)(params, x, lens)
    assert logits.shape == (B, -(-T // 4), 9)
    assert list(np.asarray(olens)) == [-(-37 // 4), -(-16 // 4)]
    assert logits.dtype == jnp.float32
    assert model.subsample_factor() == 4


def test_conformer_padding_invariance():
    """Valid-frame logits independent of batch padding — attention must
    mask padded keys exactly, the conv module must not leak through its
    receptive field, and LayerNorm is per-frame."""
    model = _tiny_model()
    x = jnp.asarray(np.random.default_rng(1).standard_normal((3, 37, 40, 3)),
                    jnp.float32)
    lens = jnp.asarray([37, 20, 9])
    params = jax.jit(model.init)(jax.random.key(0), x, lens)
    apply = jax.jit(model.apply)
    logits, olens = apply(params, x, lens)
    logits2, _ = apply(params, x[:, :20], jnp.asarray([20, 20, 9]))
    o = int(np.asarray(olens)[1])
    np.testing.assert_allclose(np.asarray(logits)[1, :o],
                               np.asarray(logits2)[1, :o], atol=1e-5)
    assert np.all(np.asarray(logits)[2, int(np.asarray(olens)[2]):] == 0)


def test_bf16_residual_close_to_fp32():
    """attn_residual_dtype=bfloat16 (the round-5 HBM-traffic lever,
    VERDICT r4 next #2) must track the fp32 residual stream within bf16
    rounding on the SAME params, and keep the padding-invariance
    contract (padded frames zeroed on exit)."""
    cfg32 = _cfg().model
    cfg16 = type(cfg32)(**{**cfg32.__dict__,
                           "attn_residual_dtype": "bfloat16"})
    m32, m16 = build_model(cfg32), build_model(cfg16)
    B, T, F = 2, 40, 40
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((B, T, F, 3)), jnp.float32)
    lens = jnp.asarray([40, 23])
    params = jax.jit(m32.init)(jax.random.key(0), x, lens)
    y32, ol = jax.jit(m32.apply)(params, x, lens)
    y16, _ = jax.jit(m16.apply)(params, x, lens)
    assert y16.dtype == jnp.float32              # logits stay fp32
    scale = float(jnp.max(jnp.abs(y32)))
    np.testing.assert_allclose(np.asarray(y16) / scale,
                               np.asarray(y32) / scale,
                               rtol=0.05, atol=0.05)


def test_rope_is_relative():
    """RoPE's defining property: the q·k score between positions t and s
    depends only on the offset t−s (for fixed content vectors)."""
    rng = np.random.default_rng(2)
    qv = rng.standard_normal(8).astype(np.float32)
    kv = rng.standard_normal(8).astype(np.float32)
    T = 16
    q = jnp.asarray(np.tile(qv, (1, T, 1, 1)))      # [1, T, 1, 8]
    k = jnp.asarray(np.tile(kv, (1, T, 1, 1)))
    qr, kr = np.asarray(rope(q))[0, :, 0], np.asarray(rope(k))[0, :, 0]
    scores = qr @ kr.T                               # [T, T]
    for off in (0, 1, 5):
        diag = np.diagonal(scores, offset=off)
        np.testing.assert_allclose(diag, diag[0], rtol=1e-5)
    # ...and different offsets genuinely differ (the test has teeth)
    assert abs(np.diagonal(scores, 1)[0] - np.diagonal(scores, 5)[0]) > 1e-3


def test_streaming_rejects_attention():
    model = _tiny_model()
    with pytest.raises(ValueError, match="global receptive field"):
        stream_geometry(model, chunk_frames=32, right_frames=0)


@pytest.mark.slow
def test_conformer_dp_equals_single_device():
    cfg = _cfg()
    batch = _fixed_batch(np.random.default_rng(3))
    model, state = _init(cfg, batch)
    mesh8 = make_mesh(cfg.parallel)
    mesh1 = make_mesh(type(cfg.parallel)(num_devices=1))
    step8 = make_train_step(model, cfg, mesh8)
    step1 = make_train_step(model, cfg, mesh1)
    state2 = jax.tree.map(jnp.copy, state)
    s8, m8 = step8(state, shard_batch(mesh8, batch))
    s1, m1 = step1(state2, shard_batch(mesh1, batch))
    assert abs(float(m8["loss"]) - float(m1["loss"])) < 1e-5
    for p8, p1 in zip(jax.tree.leaves(s8.params), jax.tree.leaves(s1.params)):
        np.testing.assert_allclose(np.asarray(p8), np.asarray(p1), atol=2e-6)


@pytest.mark.slow
def test_conformer_toy_training_learns():
    cfg = _cfg()
    rng = np.random.default_rng(4)
    batch0 = _fixed_batch(rng)
    model, state = _init(cfg, batch0)
    mesh = make_mesh(cfg.parallel)
    train_step = make_train_step(model, cfg, mesh)
    losses = []
    for _ in range(120):
        b = shard_batch(mesh, _fixed_batch(rng))
        state, m = train_step(state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.2, (losses[0], losses[-1])

    eval_step = make_eval_step(model, cfg)
    b = _fixed_batch(np.random.default_rng(321))
    _, logits, olens = eval_step(state.params,
                                 {k: jnp.asarray(v) for k, v in b.items()})
    ids, out_lens = greedy_decode(logits, olens, max_len=8)
    ids, out_lens = np.asarray(ids), np.asarray(out_lens)
    exact = sum(
        list(ids[i, : out_lens[i]]) ==
        list(b["labels"][i][: b["label_lengths"][i]])
        for i in range(16))
    assert exact >= 12, f"greedy recovered only {exact}/16"


def test_conformer_preset_bakes_gentle_optimizer():
    # The attention family plateaus on all-blank CTC at the base optimizer
    # defaults (measured: 8+ epochs stuck at CER 0.98 at lr 1e-3 / clip 5);
    # the preset must carry the recipe that exits the plateau.
    cfg = preset_config("conformer")
    assert cfg.optim.learning_rate == 3e-4
    assert cfg.optim.warmup_steps == 1000
    assert cfg.optim.clip_norm == 1.0


@pytest.mark.slow   # compile-heavy on 1-core CI; fast rep of this contract stays unmarked
def test_chunk_causal_offline_prefix_property():
    """Chunk-causal attention (attn_chunk > 0) bounds the receptive field:
    logits up to a chunk boundary are identical whether or not audio
    exists beyond it (the property that makes exact streaming possible).
    A GLOBAL-attention model must fail this (the mask has teeth)."""
    def prefix_gap(model):
        x = jnp.asarray(
            np.random.default_rng(5).standard_normal((1, 128, 40, 3)),
            jnp.float32)
        params = jax.jit(model.init)(jax.random.key(1), x,
                                     jnp.asarray([128]))
        apply = jax.jit(model.apply,
                        static_argnames=())  # two shapes, two compiles
        full, _ = apply(params, x, jnp.asarray([128]))
        # 64 input frames = 16 subsampled = 4 chunks of 4
        head, _ = apply(params, x[:, :64], jnp.asarray([64]))
        return float(np.max(np.abs(np.asarray(full)[0, :16]
                                   - np.asarray(head)[0, :16])))

    chunked = _tiny_model(attn_blocks=2, attn_chunk=4, attn_left_chunks=2,
                          attn_conv_kernel=7)
    assert prefix_gap(chunked) < 1e-5
    global_attn = _tiny_model(attn_blocks=2, attn_conv_kernel=7)
    assert prefix_gap(global_attn) > 1e-4


@pytest.mark.slow   # compile-heavy on 1-core CI; fast rep of this contract stays unmarked
def test_chunk_causal_padding_invariance():
    """The chunk-causal variant keeps the exact batched == per-utterance
    contract (padded keys masked, causal conv sees zeroed frames)."""
    model = _tiny_model(attn_chunk=4, attn_left_chunks=2, attn_conv_kernel=7)
    x = jnp.asarray(np.random.default_rng(6).standard_normal((3, 37, 40, 3)),
                    jnp.float32)
    lens = jnp.asarray([37, 20, 9])
    params = jax.jit(model.init)(jax.random.key(0), x, lens)
    apply = jax.jit(model.apply)
    logits, olens = apply(params, x, lens)
    logits2, _ = apply(params, x[:, :20], jnp.asarray([20, 20, 9]))
    o = int(np.asarray(olens)[1])
    np.testing.assert_allclose(np.asarray(logits)[1, :o],
                               np.asarray(logits2)[1, :o], atol=1e-5)
    assert np.all(np.asarray(logits)[2, int(np.asarray(olens)[2]):] == 0)


def test_conformer_stream_preset():
    cfg = preset_config("conformer_stream")
    assert cfg.model.attn_chunk == 16 and cfg.model.attn_left_chunks == 4
    assert cfg.features.cmvn_mode == "causal"
    assert cfg.optim.learning_rate == 3e-4      # same plateau recipe
    model = build_model(cfg.model)
    g = stream_geometry(model, chunk_frames=64, right_frames=0)
    assert g["C"] == 64 and g["R"] == 0 and g["conv_exact"]
    with pytest.raises(ValueError, match="right_frames must be 0"):
        stream_geometry(model, chunk_frames=64, right_frames=16)
