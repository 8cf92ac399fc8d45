"""Online (streaming) recognition tests — decode/streaming.py.

The streaming recognizer is NEW capability beyond the offline reference
(SURVEY.md §3.4 decode always sees the whole wav); its correctness contract
is equivalence with the offline recognizer in the regimes where chunked
computation is mathematically exact:

* conv-only models (finite receptive field, covered by the window margins);
* BiRNN models when every window's lookahead reaches the true utterance end
  (forward state carried exactly; backward scan then starts at the real end);
* invariance to how the PCM is split across ``accept`` calls.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from chainer_speech_recognition.config import preset_config
from chainer_speech_recognition.decode.greedy import greedy_decode
from chainer_speech_recognition.decode.streaming import (
    StreamingRecognizer, stream_geometry)
from chainer_speech_recognition.frontend.jnp_frontend import batch_features
from chainer_speech_recognition.models.presets import build_model


def _setup(name, *, seed=0, cmvn_mode="causal", cmvn=True, **model_over):
    over = {"features.cmvn_mode": cmvn_mode, "features.cmvn": cmvn,
            "model.vocab_size": 8, "model.compute_dtype": "float32"}
    for k, v in model_over.items():
        over[f"model.{k}"] = v
    cfg = preset_config(name).override(over)
    model = build_model(cfg.model)
    import jax

    x = jnp.zeros((1, 32, 40, 3), jnp.float32)
    params = jax.jit(model.init)(jax.random.key(seed), x, jnp.asarray([32]))
    return cfg, model, params


def _pcm(shape, seed=0):
    return np.asarray(
        np.random.default_rng(seed).uniform(-0.5, 0.5, shape), np.float32)


def _offline_ids(model, cfg, params, pcm, ns):
    feats, flens = batch_features(
        jnp.asarray(pcm), jnp.asarray(np.asarray(ns, np.int32)),
        apply_cmvn=cfg.features.cmvn_arg)
    logits, olens = model.apply(params, feats, flens)
    ids, lens = greedy_decode(logits, olens)
    ids, lens = np.asarray(ids), np.asarray(lens)
    return [ids[b, : lens[b]].tolist() for b in range(len(lens))]


def test_conv_only_streaming_exact_multistream():
    """Conv-only model, two streams of different true lengths decoded in
    one lockstep batch: streaming == offline exactly (buffer + flush)."""
    cfg, model, params = _setup("tiny_conv")
    ns = [8000, 6496]
    pcm = _pcm((2, max(ns)), seed=1)
    pcm[1, ns[1]:] = 0.0

    rec = StreamingRecognizer(model, params, cfg, batch=2,
                              chunk_frames=16, right_frames=8)
    rec.accept(pcm, drain=False)
    rec.flush(num_samples=ns)
    assert rec.emitted == _offline_ids(model, cfg, params, pcm, ns)


@pytest.mark.slow   # compile-heavy on 1-core CI; fast rep of this contract stays unmarked
def test_conv_only_incremental_blocks_match_offline():
    """Single stream fed in ragged real-time blocks through ``accept``
    (eager draining) ends at exactly the offline transcription, and
    ``accept``'s incremental returns concatenate to ``emitted``."""
    cfg, model, params = _setup("tiny_conv", seed=3)
    n = 9600
    pcm = _pcm((n,), seed=2)

    rec = StreamingRecognizer(model, params, cfg, batch=1,
                              chunk_frames=16, right_frames=8)
    seen: list[int] = []
    cuts = [0, 700, 701, 4000, 4161, 8000, n]
    for a, b in zip(cuts[:-1], cuts[1:]):
        seen += rec.accept(pcm[a:b])[0]
    assert seen, "eager draining should have emitted mid-stream"
    seen += rec.flush()[0]
    assert seen == rec.emitted[0]
    assert seen == _offline_ids(model, cfg, params, pcm[None], [n])[0]


@pytest.mark.slow
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_birnn_full_lookahead_exact(cell):
    """BiRNN streaming with lookahead past the utterance end == offline:
    proves the forward-state carry across chunks is exact (multiple windows
    are emitted) and the backward scan sees the true end."""
    cfg, model, params = _setup(
        "bigru" if cell == "gru" else "bilstm_deep",
        rnn_type=cell, rnn_layers=2, rnn_hidden=16)
    ns = [8000, 7040]
    pcm = _pcm((2, max(ns)), seed=4)
    pcm[1, ns[1]:] = 0.0

    # 51 frames total; chunk 16 → 4 windows ⇒ 3 boundary carries exercised
    rec = StreamingRecognizer(model, params, cfg, batch=2,
                              chunk_frames=16, right_frames=64)
    rec.accept(pcm, drain=False)
    rec.flush(num_samples=ns)
    assert rec.emitted == _offline_ids(model, cfg, params, pcm, ns)


def test_block_split_invariance():
    """The transcription must not depend on how the same audio is split
    across ``accept`` calls (chunk-invariance of every carried state)."""
    cfg, model, params = _setup("tiny_conv", seed=5)
    n = 8320
    pcm = _pcm((n,), seed=6)

    def run(blocks):
        rec = StreamingRecognizer(model, params, cfg, batch=1,
                                  chunk_frames=16, right_frames=8)
        out: list[int] = []
        for blk in blocks:
            out += rec.accept(blk)[0]
        out += rec.flush()[0]
        return out

    one = run([pcm])
    many = run([pcm[:37], pcm[37:3000], pcm[3000:3001], pcm[3001:]])
    assert one == many


@pytest.mark.slow   # compile-heavy on 1-core CI; fast rep of this contract stays unmarked
def test_cmvn_off_streaming_exact():
    """CMVN disabled entirely is also a streamable configuration."""
    cfg, model, params = _setup("tiny_conv", cmvn=False, seed=7)
    n = 8000
    pcm = _pcm((1, n), seed=8)
    rec = StreamingRecognizer(model, params, cfg, batch=1,
                              chunk_frames=16, right_frames=8)
    rec.accept(pcm, drain=False)
    rec.flush(num_samples=[n])
    assert rec.emitted == _offline_ids(model, cfg, params, pcm, [n])


def test_utterance_cmvn_rejected():
    """Utterance CMVN needs the whole utterance — streaming must refuse it
    loudly rather than silently decode with mismatched normalization."""
    cfg, model, params = _setup("tiny_conv", cmvn_mode="utterance")
    with pytest.raises(ValueError, match="causal"):
        StreamingRecognizer(model, params, cfg)


def test_geometry_rounds_to_subsample_factor():
    cfg, model, params = _setup("tiny_conv")
    g = stream_geometry(model, chunk_frames=13, right_frames=3)
    s = model.subsample_factor()
    assert g["C"] % s == 0 and g["R"] % s == 0 and g["La"] % s == 0
    assert g["C"] >= 13 and g["R"] >= 3
    assert g["La"] >= model.conv_receptive_margin()


def test_geometry_conv_exactness_flag():
    """``conv_exact`` tracks the conv stack's RIGHT receptive reach past
    the emit region: 0 for the plain subsampling stacks (per-layer reach
    k//2 < stride, so zero-lookahead streaming is conv-exact), 48 for
    glu_conv's six stride-1 kernel-5 GLU blocks at jump 4 — below that
    lookahead, boundary frames see zero-padded conv context (the
    empirically measured logits error at R=0 is ~0.6 absolute and
    decays to CMVN fp noise once R >= 48)."""
    cfg, model, params = _setup("tiny_conv")
    assert model.conv_right_margin() == 0
    assert stream_geometry(model, 16, 0)["conv_exact"]

    over = {"features.cmvn_mode": "causal", "features.cmvn": True,
            "model.vocab_size": 8, "model.compute_dtype": "float32",
            "model.rnn_type": "none"}
    gcfg = preset_config("glu_conv").override(over)
    gmodel = build_model(gcfg.model)
    assert gmodel.conv_right_margin() == 48
    assert not stream_geometry(gmodel, 16, 16)["conv_exact"]
    assert stream_geometry(gmodel, 16, 48)["conv_exact"]


def test_decode_lockstep_partial_batch_order():
    """The shared bulk feeder (cli/stream.py wav mode + evaluate
    --streaming): a final partial batch pads with row 0's signal, reads
    each unique item exactly once, and yields results keyed by the
    caller's (length-sorted) order — equal to per-item offline decode."""
    from chainer_speech_recognition.decode.streaming import (
        decode_lockstep)

    cfg, model, params = _setup("tiny_conv")
    ns = [8000, 6496, 9600]                      # 3 items, batch 2 →
    sigs = [_pcm((n,), seed=40 + i) for i, n in enumerate(ns)]
    reads: list[int] = []

    def read_signal(i):
        reads.append(i)
        return sigs[i]

    rec = StreamingRecognizer(model, params, cfg, batch=2,
                              chunk_frames=16, right_frames=8)
    order = sorted(range(3), key=lambda i: ns[i])
    got: dict[int, list[int]] = {}
    for grp, ids in decode_lockstep(rec, order, read_signal):
        got.update(zip(grp, ids))
    assert sorted(reads) == [0, 1, 2]            # padding row not re-read
    for i in range(3):
        off = _offline_ids(model, cfg, params, sigs[i][None], [ns[i]])[0]
        assert got[i] == off, f"item {i}"


@pytest.mark.slow   # compile-heavy on 1-core CI; fast rep of this contract stays unmarked
def test_flush_shorter_than_drained_rejected():
    """Eager draining emits tokens from frames [0, t0); a later
    flush(num_samples) declaring FEWER frames than already emitted must
    fail loudly instead of silently disowning the audio those tokens
    came from (unequal true lengths belong on the drain=False path)."""
    cfg, model, params = _setup("tiny_conv")
    rec = StreamingRecognizer(model, params, cfg, batch=1,
                              chunk_frames=16, right_frames=8)
    rec.accept(_pcm((1, 48000), seed=5))          # eager: drains windows
    assert rec._t0 > 10                           # tokens already emitted
    with pytest.raises(ValueError, match="already emitted"):
        rec.flush(num_samples=[1600])             # declares ~11 frames
    # a consistent flush still works after the rejected call
    out = rec.flush(num_samples=[48000])
    assert isinstance(out, list) and len(out) == 1


def _offline_beam_ids(model, cfg, params, pcm, ns, **kw):
    from chainer_speech_recognition.decode.beam import beam_decode
    from chainer_speech_recognition.frontend.jnp_frontend import (
        batch_features)
    import jax.numpy as jnp

    feats, flens = batch_features(
        jnp.asarray(pcm), jnp.asarray(np.asarray(ns, np.int32)),
        apply_cmvn=cfg.features.cmvn_arg)
    logits, olens = model.apply(params, feats, flens)
    return beam_decode(logits, olens, **kw)


def test_streaming_beam_equals_offline_beam():
    """decoder='beam': the prefix-beam recursion is strictly causal, so
    the chunk-carried state reproduces the OFFLINE beam exactly wherever
    the logits are exact (conv-only model) — including across multiple
    window boundaries and two streams of different true lengths."""
    cfg, model, params = _setup("tiny_conv", seed=11)
    ns = [9600, 7040]
    pcm = _pcm((2, max(ns)), seed=12)
    pcm[1, ns[1]:] = 0.0

    rec = StreamingRecognizer(model, params, cfg, batch=2,
                              chunk_frames=16, right_frames=8,
                              decoder="beam", beam=4)
    rec.accept(pcm, drain=False)
    rec.flush(num_samples=ns)
    off = _offline_beam_ids(model, cfg, params, pcm, ns, beam=4)
    assert rec.emitted == off


def test_streaming_beam_lm_fusion_matches_offline():
    """Streaming beam with dense n-gram LM fusion == offline beam+LM:
    the rolled LM context ids carry across chunks exactly."""
    from chainer_speech_recognition.decode.lm import NGramLM

    cfg, model, params = _setup("tiny_conv", seed=13)
    n = 9600
    pcm = _pcm((1, n), seed=14)

    rng = np.random.default_rng(15)
    V = cfg.model.vocab_size
    lm = NGramLM(2, V)
    lm.logp[0][()] = {c: float(np.log(0.5 / V)) for c in range(1, V)}
    for c0 in range(1, V):
        succ = rng.integers(1, V, size=3)
        lp = np.log(rng.dirichlet(np.ones(3)) * 0.6)
        lm.logp[1][(int(c0),)] = {int(c): float(p)
                                  for c, p in zip(succ, lp)}
        lm.backoff[1][(int(c0),)] = float(np.log(0.4))

    rec = StreamingRecognizer(model, params, cfg, batch=1,
                              chunk_frames=16, right_frames=8,
                              decoder="beam", beam=4, lm=lm,
                              lm_alpha=0.7, lm_beta=0.8)
    rec.accept(pcm, drain=False)
    rec.flush(num_samples=[n])
    off = _offline_beam_ids(model, cfg, params, pcm, [n],
                            beam=4, lm=lm, alpha=0.7, beta=0.8)
    assert rec.emitted == off


@pytest.mark.slow   # compile-heavy on 1-core CI; fast rep of this contract stays unmarked
def test_streaming_beam_finalized_is_stable_prefix():
    """Eagerly-drained beam streaming: every `accept` return extends the
    previous ones (finalized tokens are never retracted), their
    concatenation plus the flush tail equals `emitted`, and the result
    matches the buffered run."""
    cfg, model, params = _setup("tiny_conv", seed=16)
    n = 12800
    pcm = _pcm((n,), seed=17)

    def mk():
        return StreamingRecognizer(model, params, cfg, batch=1,
                                   chunk_frames=16, right_frames=8,
                                   decoder="beam", beam=4)

    rec = mk()
    seen: list[int] = []
    for a in range(0, n, 1600):
        seen += rec.accept(pcm[a : a + 1600])[0]
        # everything reported so far is a prefix of the running state
        assert rec.emitted[0][: len(seen)] == seen
    seen += rec.flush()[0]
    assert seen == rec.emitted[0]

    buf = mk()
    buf.accept(pcm, drain=False)
    buf.flush(num_samples=[n])
    assert rec.emitted == buf.emitted


def test_endpointing_segments_and_invariance():
    """CTC endpointing (trailing-blank utterance boundaries): two tone
    bursts separated by 2 s of silence split into two segments, the
    segment ids concatenate to `emitted`, and — conv-only, CMVN off, so
    the endpoint state resets are no-ops — `emitted` matches the
    non-endpointing run exactly. (Init seed 15 maps silence → blank.)"""
    from chainer_speech_recognition.data.synthetic import make_utterance

    cfg, model, params = _setup("tiny_conv", seed=15, cmvn=False)
    rng = np.random.default_rng(0)
    sig1, _ = make_utterance(rng, [1, 2, 3], tone_len=1600)
    sig2, _ = make_utterance(rng, [3, 1], tone_len=1600)
    sil = np.zeros(32000, np.float32)
    pcm = np.concatenate([sig1, sil, sig2, sil]).astype(np.float32)

    def run(**kw):
        rec = StreamingRecognizer(model, params, cfg, batch=1,
                                  chunk_frames=16, right_frames=8, **kw)
        for a in range(0, len(pcm), 1600):
            rec.accept(pcm[a : a + 1600])
        rec.flush()
        return rec

    plain = run()
    ep = run(endpoint_ms=600)
    assert ep.emitted == plain.emitted          # resets were no-ops here
    segs = ep.segments[0]
    assert len(segs) == 2, segs
    assert sum((s for s, _ in segs), []) == ep.emitted[0]
    ends = [e for _, e in segs]
    assert ends == sorted(ends) and ends[-1] <= 1 + len(pcm) // 160
    # the first boundary fired inside the first silence, not at flush
    assert ends[0] < (len(sig1) + len(sil)) // 160


@pytest.mark.slow   # compile-heavy on 1-core CI; fast rep of this contract stays unmarked
def test_endpointing_beam_segments():
    """Endpointing composes with the streaming beam: per-row beam-state
    resets at boundaries, unfinalized 1-best tails land in the closing
    segment, and segments still concatenate to `emitted`."""
    from chainer_speech_recognition.data.synthetic import make_utterance

    cfg, model, params = _setup("tiny_conv", seed=15, cmvn=False)
    rng = np.random.default_rng(1)
    sig1, _ = make_utterance(rng, [2, 3], tone_len=1600)
    sig2, _ = make_utterance(rng, [1, 3, 2], tone_len=1600)
    sil = np.zeros(32000, np.float32)
    pcm = np.concatenate([sig1, sil, sig2, sil]).astype(np.float32)

    rec = StreamingRecognizer(model, params, cfg, batch=1,
                              chunk_frames=16, right_frames=8,
                              decoder="beam", beam=4, endpoint_ms=600)
    for a in range(0, len(pcm), 1600):
        rec.accept(pcm[a : a + 1600])
    rec.flush()
    segs = rec.segments[0]
    # a RANDOM model's beam legitimately finds non-blank hypotheses inside
    # argmax-blank silence, so the silences may add segments beyond the
    # two tone bursts — the invariants are structural:
    assert len(segs) >= 2, segs
    assert sum((s for s, _ in segs), []) == rec.emitted[0]
    assert all(s for s, _ in segs)
    ends = [e for _, e in segs]
    assert ends == sorted(ends)


@pytest.mark.slow
def test_long_form_buffer_trim_invariance():
    """Long-form eager streaming trims consumed PCM off the host buffer
    (bounded memory) without changing the transcription: a 40 s stream
    decoded eagerly (trim active) equals the buffered untrimmed run."""
    cfg, model, params = _setup("tiny_conv", seed=13, cmvn=False)
    n = 16000 * 40
    pcm = _pcm((n,), seed=20)

    rec = StreamingRecognizer(model, params, cfg, batch=1,
                              chunk_frames=16, right_frames=8)
    for a in range(0, n, 16000):
        rec.accept(pcm[a : a + 16000])
    assert rec._base > 0, "40 s of eager draining should have trimmed"
    assert rec._buf.shape[1] < 16000 * 20
    rec.flush()

    buf = StreamingRecognizer(model, params, cfg, batch=1,
                              chunk_frames=16, right_frames=8)
    buf.accept(pcm, drain=False)
    assert buf._base == 0
    buf.flush(num_samples=[n])
    assert rec.emitted == buf.emitted


def test_unidirectional_zero_lookahead_exact():
    """Forward-only model (uni_gru preset): streaming with ZERO lookahead
    equals offline exactly at any chunk size — no backward direction, so
    the only context needed is the conv margin the window already
    carries. The zero-latency online configuration."""
    cfg, model, params = _setup("uni_gru", seed=30, rnn_hidden=16)
    ns = [9600, 7040]
    pcm = _pcm((2, max(ns)), seed=31)
    pcm[1, ns[1]:] = 0.0

    rec = StreamingRecognizer(model, params, cfg, batch=2,
                              chunk_frames=16, right_frames=0)
    rec.accept(pcm, drain=False)
    rec.flush(num_samples=ns)
    assert rec.emitted == _offline_ids(model, cfg, params, pcm, ns)

    # eager single-stream feed, still exact
    rec1 = StreamingRecognizer(model, params, cfg, batch=1,
                               chunk_frames=16, right_frames=0)
    out: list[int] = []
    for a in range(0, ns[0], 1111):
        out += rec1.accept(pcm[0, a : a + 1111][None])[0]
    out += rec1.flush()[0]
    assert out == _offline_ids(model, cfg, params, pcm[:1, :ns[0]],
                               [ns[0]])[0]


@pytest.mark.slow   # compile-heavy on 1-core CI; fast rep of this contract stays unmarked
def test_unidirectional_streaming_beam_exact():
    """Zero-lookahead streaming BEAM on a forward-only model == offline
    beam: the full online stack (causal front-end, forward RNN carries,
    chunk-carried beam state) is exact end to end."""
    cfg, model, params = _setup("uni_gru", seed=32, rnn_hidden=16)
    n = 9600
    pcm = _pcm((1, n), seed=33)
    rec = StreamingRecognizer(model, params, cfg, batch=1,
                              chunk_frames=16, right_frames=0,
                              decoder="beam", beam=4)
    rec.accept(pcm, drain=False)
    rec.flush(num_samples=[n])
    assert rec.emitted == _offline_beam_ids(model, cfg, params, pcm, [n],
                                            beam=4)


@pytest.mark.slow
def test_streaming_fuzz_differential():
    """Randomized differential campaign: random conv-only models ×
    random chunk geometries × ragged random streams — chunked streaming
    (greedy AND beam) must equal offline bit-exactly in every trial.
    Catches window-geometry edge cases (margins, reflections, final
    partial chunks) that hand-picked shapes miss."""
    rng = np.random.default_rng(99)
    for trial in range(6):
        seed = int(rng.integers(0, 1000))
        cfg, model, params = _setup("tiny_conv", seed=seed,
                                    cmvn=bool(trial % 2))
        chunk = int(rng.integers(8, 48))
        right = int(rng.integers(0, 24))
        B = int(rng.integers(1, 4))
        ns = [int(rng.integers(2000, 14000)) for _ in range(B)]
        pcm = _pcm((B, max(ns)), seed=seed + 1)
        for b, nb in enumerate(ns):
            pcm[b, nb:] = 0.0

        rec = StreamingRecognizer(model, params, cfg, batch=B,
                                  chunk_frames=chunk, right_frames=right)
        rec.accept(pcm, drain=False)
        rec.flush(num_samples=ns)
        off = _offline_ids(model, cfg, params, pcm, ns)
        assert rec.emitted == off, (trial, seed, chunk, right, ns)

        recb = StreamingRecognizer(model, params, cfg, batch=B,
                                   chunk_frames=chunk, right_frames=right,
                                   decoder="beam", beam=4)
        recb.accept(pcm, drain=False)
        recb.flush(num_samples=ns)
        offb = _offline_beam_ids(model, cfg, params, pcm, ns, beam=4)
        assert recb.emitted == offb, (trial, seed, chunk, right, ns)


def _setup_attn(seed=40):
    return _setup("conformer_stream", seed=seed, attn_blocks=2, attn_dim=16,
                  attn_heads=2, attn_chunk=4, attn_left_chunks=2,
                  attn_conv_kernel=7)


def test_chunk_causal_attention_streaming_exact():
    """STREAMING ATTENTION: a chunk-causally trained conformer streams
    exactly — per-block KV caches carry the left context, the causal-conv
    tails carry the depthwise receptive field, and the offline forward
    applies the identical chunk mask. Two lockstep streams of different
    true lengths: streaming == offline."""
    cfg, model, params = _setup_attn()
    ns = [9600, 7040]
    pcm = _pcm((2, max(ns)), seed=41)
    pcm[1, ns[1]:] = 0.0

    # attn_chunk=4, s=4 -> geometry forces C=16; 61 frames -> 4 windows,
    # so the KV cache (2 chunks) rolls past its capacity (older context
    # correctly discarded, matching the offline mask)
    rec = StreamingRecognizer(model, params, cfg, batch=2,
                              chunk_frames=16, right_frames=0)
    rec.accept(pcm, drain=False)
    rec.flush(num_samples=ns)
    assert rec.emitted == _offline_ids(model, cfg, params, pcm, ns)


@pytest.mark.slow   # compile-heavy on 1-core CI; fast rep of this contract stays unmarked
def test_chunk_causal_attention_block_split_invariance():
    """Eager ragged feeding reaches the same transcription — every
    attention carry (positions, validity counters, KV caches, conv
    tails) is invariant to how the PCM arrives."""
    cfg, model, params = _setup_attn(seed=42)
    n = 9600
    pcm = _pcm((n,), seed=43)

    def run(blocks):
        rec = StreamingRecognizer(model, params, cfg, batch=1,
                                  chunk_frames=16, right_frames=0)
        out: list[int] = []
        for blk in blocks:
            out += rec.accept(blk)[0]
        out += rec.flush()[0]
        return out

    one = run([pcm])
    many = run([pcm[:37], pcm[37:3000], pcm[3000:3001], pcm[3001:]])
    assert one == many
    assert one == _offline_ids(model, cfg, params, pcm[None], [n])[0]


@pytest.mark.slow   # compile-heavy on 1-core CI; fast rep of this contract stays unmarked
def test_chunk_causal_attention_streaming_beam_exact():
    """Streaming BEAM on the chunk-causal conformer == offline beam (the
    online attention stack composes with the carried beam state)."""
    cfg, model, params = _setup_attn(seed=44)
    n = 9600
    pcm = _pcm((1, n), seed=45)
    rec = StreamingRecognizer(model, params, cfg, batch=1,
                              chunk_frames=16, right_frames=0,
                              decoder="beam", beam=4)
    rec.accept(pcm, drain=False)
    rec.flush(num_samples=[n])
    assert rec.emitted == _offline_beam_ids(model, cfg, params, pcm, [n],
                                            beam=4)


@pytest.mark.slow   # compile-heavy on 1-core CI; fast rep of this contract stays unmarked
def test_chunk_causal_attention_endpointing():
    """Endpointing on the attention family: the reset advances the
    per-row attention segment boundary (pre-boundary KV cache becomes
    unattendable) instead of zeroing it — segments still concatenate to
    `emitted` and the run completes."""
    from chainer_speech_recognition.data.synthetic import make_utterance

    cfg, model, params = _setup_attn(seed=46)
    rng = np.random.default_rng(2)
    sig1, _ = make_utterance(rng, [1, 2], tone_len=1600)
    sig2, _ = make_utterance(rng, [3, 1], tone_len=1600)
    sil = np.zeros(32000, np.float32)
    pcm = np.concatenate([sig1, sil, sig2, sil]).astype(np.float32)

    rec = StreamingRecognizer(model, params, cfg, batch=1,
                              chunk_frames=16, right_frames=0,
                              endpoint_ms=600)
    for a in range(0, len(pcm), 1600):
        rec.accept(pcm[a : a + 1600])
    rec.flush()
    segs = rec.segments[0]
    assert sum((s for s, _ in segs), []) == rec.emitted[0]
    ends = [e for _, e in segs]
    assert ends == sorted(ends)
