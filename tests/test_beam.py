"""Prefix-beam-search tests (SURVEY.md §4.1 "decoders vs slow pure-Python
references" + §7 hard-part 3):

* exactness: with a beam wide enough to hold every prefix, both the host
  reference and the on-device beam must reproduce EXHAUSTIVE path-sum
  enumeration (total-probability ranking, not just argmax);
* device == host on peaked (realistic) posteriors;
* LM shallow fusion steers both decoders the same way.
"""

import itertools
from collections import defaultdict

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chainer_speech_recognition.decode.beam import (
    beam_decode, beam_decode_nbest, beam_decode_reference)
from chainer_speech_recognition.decode.lm import NGramLM
from chainer_speech_recognition.vocab import Vocab


def _exhaustive(lp):
    """All collapsed prefixes with exact log total probability."""
    T, V = lp.shape
    probs = defaultdict(float)
    for path in itertools.product(range(V), repeat=T):
        p = np.exp(sum(lp[t, c] for t, c in enumerate(path)))
        out, prev = [], -1
        for c in path:
            if c != 0 and c != prev:
                out.append(c)
            prev = c
        probs[tuple(out)] += p
    return sorted(probs.items(), key=lambda kv: -kv[1])


def _logits(seed, B, T, V, scale=2.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T, V)).astype(np.float32) * scale


def test_beam_exact_vs_enumeration():
    logits = _logits(0, 1, 4, 3)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))[0]
    exact = _exhaustive(lp)
    assert beam_decode_reference(lp, 4, beam=32) == list(exact[0][0])
    pfx, plen, final = beam_decode_nbest(logits, np.asarray([4]), beam=16,
                                         max_len=4)
    for k in range(4):   # top-4 prefixes AND their scores match enumeration
        assert list(pfx[0, k, : plen[0, k]]) == list(exact[k][0])
        assert abs(final[0, k] - np.log(exact[k][1])) < 1e-3


def test_device_matches_reference_on_peaked_logits():
    """On realistic (peaked) posteriors pruning paths coincide."""
    B, T, V = 5, 18, 7
    rng = np.random.default_rng(3)
    # build peaked logits around a random path
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    for b in range(B):
        path = rng.integers(0, V, T)
        logits[b, np.arange(T), path] += 6.0
    lens = rng.integers(8, T + 1, B)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    hyps = beam_decode(logits, lens, beam=8)
    for b in range(B):
        ref = beam_decode_reference(lp[b], lens[b], beam=8)
        assert [int(x) for x in hyps[b]] == ref, b


def test_beam_respects_lengths():
    logits = np.full((1, 6, 3), -5.0, np.float32)
    logits[0, :, 1] = 5.0          # always symbol 1
    logits[0, 3:, 2] = 10.0        # symbol 2 after t=3 (outside length)
    hyps = beam_decode(logits, np.asarray([3]), beam=4)
    assert [int(x) for x in hyps[0]] == [1]


def _toy_lm_vocab():
    vocab = Vocab.build(["あいう", "ういあ", "あいあ"], add_unk=False)
    lm = NGramLM.train(["あいう"] * 50 + ["あいあ"] * 5, vocab, order=2)
    return vocab, lm


def test_lm_scores_are_sane():
    vocab, lm = _toy_lm_vocab()
    a, i, u = vocab.encode("あ")[0], vocab.encode("い")[0], vocab.encode("う")[0]
    # after "あい", "う" much likelier than "あ" per training counts
    assert lm.score((a, i), u) > lm.score((a, i), a)
    dense, order = lm.to_dense()
    assert order == 2 and dense.shape == (len(vocab), len(vocab))
    ctx = i  # bigram context id = last char id
    assert dense[ctx, u] > dense[ctx, a]
    np.testing.assert_allclose(dense[ctx, u], lm.score((a, i), u), atol=1e-5)


def test_lm_fusion_changes_decode_consistently():
    """Ambiguous AM + LM that prefers 'う' after 'い': both decoders must
    flip the third symbol when fusion is on."""
    vocab, lm = _toy_lm_vocab()
    a, i, u = vocab.encode("あ")[0], vocab.encode("い")[0], vocab.encode("う")[0]
    V = len(vocab)
    T = 6
    logits = np.full((1, T, V), -8.0, np.float32)
    for t, c in [(0, a), (1, 0), (2, i), (3, 0)]:
        logits[0, t, c] = 8.0
    # frames 4-5: nearly tied between あ and う, あ slightly ahead
    logits[0, 4:, a] = 2.10
    logits[0, 4:, u] = 2.00

    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))[0]
    no_lm_ref = beam_decode_reference(lp, T, beam=8)
    lm_ref = beam_decode_reference(lp, T, beam=8, lm=lm, alpha=0.8, beta=0.0)
    assert no_lm_ref == [a, i, a]
    assert lm_ref == [a, i, u]

    no_lm_dev = beam_decode(logits, np.asarray([T]), beam=8)
    lm_dev = beam_decode(logits, np.asarray([T]), beam=8, lm=lm,
                         alpha=0.8, beta=0.0)
    assert [int(x) for x in no_lm_dev[0]] == no_lm_ref
    assert [int(x) for x in lm_dev[0]] == lm_ref


def test_large_vocab_beam_matches_reference():
    """Structural (sort-free) merge at production-like vocab width must
    reproduce the host reference exactly."""
    B, T, V = 4, 24, 60
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    for b in range(B):
        path = rng.integers(0, V, T)
        logits[b, np.arange(T), path] += 6.0
    lens = rng.integers(12, T + 1, B)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    hyps = beam_decode(logits, lens, beam=8)
    for b in range(B):
        ref = beam_decode_reference(lp[b], lens[b], beam=8)
        assert [int(x) for x in hyps[b]] == ref, b


def test_bpe_scale_vocab_beam_matches_reference():
    """V=512 (BPE-scale) exactness for the O(K²) parent-hash merge
    (VERDICT r4 next #1): device beam == host reference with and without
    trigram LM fusion, on peaked and on flat (merge-heavy) posteriors."""
    B, T, V = 3, 20, 512
    rng = np.random.default_rng(17)
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    # row 0/1 peaked around a path, row 2 stays flat (maximum merging)
    for b in range(2):
        path = rng.integers(0, V, T)
        logits[b, np.arange(T), path] += 6.0
    lens = np.asarray([20, 14, 9])
    lm = NGramLM(3, V)
    lm.logp[0][()] = {c: float(np.log(0.5 / (V - 1))) for c in range(1, V)}
    for k in (1, 2):
        for ctx in {tuple(int(x) for x in rng.integers(1, V, k))
                    for _ in range(300)}:
            succ = rng.integers(1, V, size=6)
            lp = np.log(rng.dirichlet(np.ones(6)) * 0.6)
            lm.logp[k][ctx] = {int(c): float(p) for c, p in zip(succ, lp)}
            lm.backoff[k][ctx] = float(np.log(0.4))
    lp_all = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    for kw in (dict(), dict(lm=lm.to_hashed(), alpha=0.5, beta=0.8)):
        dev = beam_decode(logits, lens, beam=8, **kw)
        rkw = dict(lm=lm, alpha=0.5, beta=0.8) if kw else {}
        for b in range(B):
            ref = beam_decode_reference(lp_all[b], lens[b], beam=8, **rkw)
            assert [int(x) for x in dev[b]] == ref, (bool(kw), b)


def test_unigram_lm_beta_only_matches_reference():
    """order-1 LM with alpha=0 but beta!=0: the insertion bonus must still
    apply on device (regression: fusion was gated on order>1 or alpha!=0)."""
    vocab, _ = _toy_lm_vocab()
    lm = NGramLM.train(["あいう"] * 10, vocab, order=1)
    logits = _logits(9, 3, 12, len(vocab), scale=1.5)
    lens = np.asarray([12, 9, 7])
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    dev = beam_decode(logits, lens, beam=8, lm=lm, alpha=0.0, beta=1.5)
    for b in range(3):
        ref = beam_decode_reference(lp[b], lens[b], beam=8, lm=lm,
                                    alpha=0.0, beta=1.5)
        assert [int(x) for x in dev[b]] == ref, b


def test_alpha_beta_sweep_single_compile():
    """α/β are traced operands: a fusion-weight grid sweep (the standard
    config-4 tuning loop) must reuse ONE compiled beam per (shape, K,
    lm_order) instead of compiling per grid point (VERDICT r1 Weak #3) —
    and every grid point must still match the host reference exactly."""
    from chainer_speech_recognition.decode.beam import _beam_decode_jit

    vocab, lm = _toy_lm_vocab()
    logits = _logits(21, 2, 10, len(vocab), scale=1.5)
    lens = np.asarray([10, 8])
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    _beam_decode_jit._clear_cache()
    grid = [(a, b) for a in (0.0, 0.4, 0.8) for b in (0.0, 0.7, 1.4)]
    for alpha, beta in grid:
        dev = beam_decode(logits, lens, beam=8, lm=lm, alpha=alpha, beta=beta)
        for b in range(2):
            ref = beam_decode_reference(lp[b], lens[b], beam=8, lm=lm,
                                        alpha=alpha, beta=beta)
            assert [int(x) for x in dev[b]] == ref, (alpha, beta, b)
    assert _beam_decode_jit._cache_size() == 1, _beam_decode_jit._cache_size()


def test_arpa_roundtrip(tmp_path):
    vocab, lm = _toy_lm_vocab()
    path = str(tmp_path / "lm.arpa")
    lm.to_arpa(path, vocab)
    lm2 = NGramLM.from_arpa(path, vocab)
    a, i, u = vocab.encode("あ")[0], vocab.encode("い")[0], vocab.encode("う")[0]
    # ((i,), i) is unseen after a context with NONZERO backoff weight:
    # regression for from_arpa storing backoff at the wrong level, which
    # silently dropped every backoff weight (over-scored continuations).
    assert lm.backoff[1].get((i,), 0.0) != 0.0
    for ctx, c in [((a,), i), ((a, i), u), ((), a), ((u,), i), ((i,), i)]:
        assert abs(lm.score(ctx, c) - lm2.score(ctx, c)) < 1e-4
    np.testing.assert_allclose(lm2.to_dense()[0], lm.to_dense()[0], atol=1e-4)


def test_to_dense_matches_score_recursion():
    """Vectorized to_dense must equal per-entry score() evaluation,
    including blank-padded (BOS) context rows, for a trigram LM."""
    vocab = Vocab.build(["あいう", "ういあ", "あいあ"], add_unk=False)
    lm = NGramLM.train(["あいう"] * 9 + ["ういあ"] * 4 + ["あいあ"] * 2,
                       vocab, order=3)
    dense, order = lm.to_dense()
    V = len(vocab)
    assert order == 3 and dense.shape == (V * V, V)
    for cid in range(V * V):
        raw = (cid // V, cid % V)            # oldest first
        ctx = tuple(c for c in raw if c != 0)
        for ch in range(1, V):
            np.testing.assert_allclose(dense[cid, ch], lm.score(ctx, ch),
                                       atol=1e-5, err_msg=f"{raw} {ch}")
    assert (dense[:, 0] == 0.0).all()


def test_hashed_lm_matches_score_recursion():
    """HashedLM resolved rows + longest-suffix probe must equal score()
    for every (context, char), including unknown and BOS-partial contexts
    — the exactness claim of NGramLM.to_hashed, at order 4."""
    vocab = Vocab.build(["あいう", "ういあ", "あいあ", "うあい"], add_unk=False)
    lm = NGramLM.train(["あいう"] * 9 + ["ういあ"] * 4 + ["あいあ"] * 2
                       + ["うあい"] * 3, vocab, order=4)
    h = lm.to_hashed()
    V = len(vocab)
    assert h.order == 4 and h.rows.shape[1] == V
    assert h.bytes < 64 * 1024          # vs dense V^3·V·4 = 16 KB at V=4...
    # host replica of the device probe (same double window-hash keys,
    # same longest-suffix-first level order — decode/lm.py ctx_keys)
    from chainer_speech_recognition.decode.lm import ctx_keys
    cap = h.table.shape[0]

    def probe_row(ctx_tuple):
        window = tuple(ctx_tuple[-(h.order - 1):])
        for k in range(h.order - 1, 0, -1):
            k1, k2 = ctx_keys(window[-k:], V)
            if (k1, k2) == (0, 0):
                continue
            slot = (k1 & 0xFFFFFFFF) * 2654435761 % cap
            for p in range(h.max_probes):
                s = (slot + p) % cap
                if (h.table[s, 0] == k1 and h.table[s, 1] == k2
                        and h.table[s, 2] != -1):
                    return h.rows[h.table[s, 2]]
        return h.rows[0]

    rng = np.random.default_rng(5)
    ctxs = [(), (1,), (2, 1), (1, 2, 3), (3, 3, 3), (2, 2), (3, 1, 2)]
    ctxs += [tuple(int(x) for x in rng.integers(1, V, rng.integers(0, 4)))
             for _ in range(40)]
    for ctx in ctxs:
        row = probe_row(ctx)
        for ch in range(1, V):
            np.testing.assert_allclose(
                row[ch], lm.score(ctx, ch), atol=1e-5,
                err_msg=f"ctx={ctx} ch={ch}")
        assert row[0] == 0.0


def test_hashed_beam_matches_dense_and_reference():
    """Device beam with the sparse HashedLM == dense-table beam == host
    reference, at order 4 (beyond the dense table's practical range at
    production V — checked here at small V where dense is still buildable)."""
    vocab = Vocab.build(["あいう", "ういあ", "あいあ", "うあい"], add_unk=False)
    lm = NGramLM.train(["あいう"] * 9 + ["ういあ"] * 4 + ["あいあ"] * 2
                       + ["うあい"] * 3, vocab, order=4)
    h = lm.to_hashed()
    V = len(vocab)
    B, T = 4, 16
    logits = _logits(31, B, T, V, scale=1.5)
    lens = np.asarray([16, 13, 10, 7])
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    dev_h = beam_decode(logits, lens, beam=8, lm=h, alpha=0.6, beta=0.4)
    dev_d = beam_decode(logits, lens, beam=8, lm=lm, alpha=0.6, beta=0.4)
    assert dev_h == dev_d
    for b in range(B):
        ref = beam_decode_reference(lp[b], lens[b], beam=8, lm=lm,
                                    alpha=0.6, beta=0.4)
        assert [int(x) for x in dev_h[b]] == ref, b


def test_hashed_fp16_rows_match_fp32():
    """fp16 score-row storage (the CSJ/BPE vocab-scale residency lever,
    VERDICT r4 next #1) must keep beam results identical to fp32 rows on
    a real backoff LM — the ~2⁻¹¹ relative log-prob quantization is far
    below the score gaps the beam resolves — and device_lm's auto policy
    must pick fp16 exactly when the fp32 rows exceed the budget."""
    from chainer_speech_recognition.decode.lm import device_lm

    vocab = Vocab.build(["あいう", "ういあ", "あいあ", "うあい"], add_unk=False)
    lm = NGramLM.train(["あいう"] * 9 + ["ういあ"] * 4 + ["あいあ"] * 2
                       + ["うあい"] * 3, vocab, order=4)
    h32 = lm.to_hashed()
    h16 = lm.to_hashed(rows_dtype=np.float16)
    assert h16.rows.dtype == np.float16
    assert h16.bytes < h32.bytes
    np.testing.assert_allclose(h16.rows.astype(np.float32), h32.rows,
                               rtol=1e-3, atol=1e-3)
    V = len(vocab)
    B, T = 4, 16
    logits = _logits(31, B, T, V, scale=1.5)
    lens = np.asarray([16, 13, 10, 7])
    got16 = beam_decode(logits, lens, beam=8, lm=h16, alpha=0.6, beta=0.4)
    got32 = beam_decode(logits, lens, beam=8, lm=h32, alpha=0.6, beta=0.4)
    assert got16 == got32
    # auto policy: dense budget forces hashed; rows budget 0 forces fp16
    auto16 = device_lm(lm, dense_budget_bytes=0, hashed_rows_budget_bytes=0)
    assert auto16.rows.dtype == np.float16
    auto32 = device_lm(lm, dense_budget_bytes=0)
    assert auto32.rows.dtype == np.float32


def test_hashed_order4_bpe_vocab_matches_reference():
    """Order-4 fusion at BPE vocab scale (V=3000 — far beyond the old
    V^order < 2^31 rolled-id bound: 3000⁴ ≈ 2⁴⁶): the double window-hash
    context keys must reproduce the host reference exactly. This is the
    configuration the round-5 large-vocab bench first caught as a hard
    ValueError (VERDICT r4 next #1 'fix what cliffs')."""
    V, B, T = 3000, 2, 10
    rng = np.random.default_rng(23)
    lm = NGramLM(4, V)
    lm.logp[0][()] = {c: float(np.log(0.8 / (V - 1)))
                      for c in range(1, V, 7)}
    for k in (1, 2, 3):
        for ctx in {tuple(int(x) for x in rng.integers(1, V, k))
                    for _ in range(200)}:
            succ = rng.integers(1, V, size=5)
            lp = np.log(rng.dirichlet(np.ones(5)) * 0.7)
            lm.logp[k][ctx] = {int(c): float(p) for c, p in zip(succ, lp)}
            lm.backoff[k][ctx] = float(np.log(0.3))
    h = lm.to_hashed()
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    path = rng.integers(0, V, (B, T))
    for b in range(B):
        logits[b, np.arange(T), path[b]] += 5.0
    lens = np.asarray([10, 7])
    lp_all = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    dev = beam_decode(logits, lens, beam=8, lm=h, alpha=0.6, beta=0.5)
    for b in range(B):
        ref = beam_decode_reference(lp_all[b], lens[b], beam=8, lm=lm,
                                    alpha=0.6, beta=0.5)
        assert [int(x) for x in dev[b]] == ref, b


@pytest.mark.slow
def test_hashed_beam_sharded_matches_single_device():
    """HashedLM under the DP mesh (tables replicated, rows split) must
    equal the single-device hashed decode."""
    from chainer_speech_recognition.config import ParallelConfig
    from chainer_speech_recognition.parallel.mesh import make_mesh

    vocab = Vocab.build(["あいう", "ういあ", "あいあ"], add_unk=False)
    lm = NGramLM.train(["あいう"] * 9 + ["ういあ"] * 4, vocab, order=3)
    h = lm.to_hashed()
    V = len(vocab)
    B, T = 8, 12
    logits = _logits(77, B, T, V, scale=1.5)
    lens = np.full(B, T, np.int32)
    lens[::3] = T - 4
    mesh = make_mesh(ParallelConfig(num_devices=8))
    got = beam_decode(logits, lens, beam=4, lm=h, alpha=0.5, beta=0.3,
                      mesh=mesh)
    want = beam_decode(logits, lens, beam=4, lm=h, alpha=0.5, beta=0.3)
    assert got == want


def test_beam_stream_matches_per_batch():
    """beam_decode_stream (grouped-pull bulk path) must yield exactly the
    per-batch beam_decode results, across shape changes (flush-on-shape)
    and a trailing partial group."""
    from chainer_speech_recognition.decode.beam import beam_decode_stream

    lm = (np.log(np.full((6, 6), 1.0 / 6, np.float32)), 2)
    shapes = [(4, 12, 6)] * 3 + [(2, 9, 6)] * 2 + [(4, 12, 6)] * 2
    batches = []
    for i, (B, T, V) in enumerate(shapes):
        lg = _logits(100 + i, B, T, V)
        lens = np.full(B, T, np.int32)
        lens[0] = T - 3
        batches.append((jnp.asarray(lg), jnp.asarray(lens)))
    want = [beam_decode(lg, ln, beam=4, lm=lm, alpha=0.3, beta=0.5)
            for lg, ln in batches]
    got = list(beam_decode_stream(iter(batches), beam=4, lm=lm,
                                  alpha=0.3, beta=0.5, flush_every=2))
    assert got == want


def test_beam_rejects_int16_overflow_shapes():
    """Results travel as ONE packed int16 array — V or T beyond int16
    range must fail loudly at trace time, not wrap silently."""
    lg = jnp.zeros((1, 4, 40000), jnp.float32)
    with pytest.raises(ValueError, match="int16"):
        beam_decode(lg, np.array([4], np.int32), beam=2)


def test_from_arpa_drops_oov_symbols(tmp_path):
    """ARPA grams on symbols outside the vocab must be DROPPED: no crash
    without <unk>, and no silent pile-up of distinct OOV grams onto the
    <unk> id with it."""
    arpa = tmp_path / "oov.arpa"
    arpa.write_text(
        "\\data\\\nngram 1=4\n\n\\1-grams:\n"
        "-0.30\tあ\n-0.40\tい\n-0.10\tz\n-0.20\tq\n\n\\end\\\n",
        encoding="utf-8")
    v_nounk = Vocab.build(["あい"], add_unk=False)
    lm = NGramLM.from_arpa(str(arpa), v_nounk)      # must not raise
    assert set(lm.logp[0].get((), {})) == {v_nounk.encode("あ")[0],
                                           v_nounk.encode("い")[0]}
    v_unk = Vocab.build(["あい"], add_unk=True)
    lm2 = NGramLM.from_arpa(str(arpa), v_unk)
    assert v_unk.unk_id not in lm2.logp[0].get((), {})   # z/q not on <unk>


def test_order1_lm_routes_to_dense():
    """HashedLM has no contexts to hash at order 1 — to_hashed refuses,
    and device_lm returns the [1, V] dense row whatever repr was asked."""
    from chainer_speech_recognition.decode.lm import device_lm

    vocab = Vocab.build(["あいう"], add_unk=False)
    lm = NGramLM.train(["あいう"] * 5, vocab, order=1)
    with pytest.raises(ValueError, match="order"):
        lm.to_hashed()
    for repr_ in ("auto", "dense", "hashed"):
        table, order = device_lm(lm, repr_)
        assert table.shape == (1, len(vocab)) and order == 1


@pytest.mark.slow
def test_beam_randomized_differential_fuzz():
    """Randomized campaign: device beam (dense AND hashed LM, orders 1-3,
    random alpha/beta/shapes/lengths) must equal the host reference on
    peaked posteriors. A 298-utterance run of this generator passed with
    zero mismatches (2026-08-18); CI keeps a 25-config slice."""
    from chainer_speech_recognition.decode.lm import device_lm  # noqa: F401

    rng = np.random.default_rng(42)
    for trial in range(25):
        B = int(rng.integers(1, 5))
        T = int(rng.integers(4, 22))
        V = int(rng.integers(3, 13))
        K = int(rng.choice([4, 8]))
        logits = rng.standard_normal((B, T, V)).astype(np.float32)
        for b in range(B):
            path = rng.integers(0, V, T)
            logits[b, np.arange(T), path] += float(rng.uniform(4.0, 8.0))
        lens = rng.integers(2, T + 1, B).astype(np.int32)
        lm = lm_dev = None
        alpha = beta = 0.0
        if rng.random() < 0.6:
            syms = [chr(0x3042 + i) for i in range(V - 1)]
            vocab = Vocab.build(["".join(syms)], add_unk=False)
            texts = ["".join(rng.choice(syms, size=rng.integers(3, 10)))
                     for _ in range(30)]
            order = int(rng.integers(1, 4))
            lm = NGramLM.train(texts, vocab, order=order)
            alpha = float(rng.uniform(0.0, 1.0))
            beta = float(rng.uniform(0.0, 2.0))
            lm_dev = (lm.to_hashed()
                      if rng.random() < 0.3 and order >= 2 else lm)
        lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
        dev = beam_decode(logits, lens, beam=K, lm=lm_dev,
                          alpha=alpha, beta=beta)
        for b in range(B):
            ref = beam_decode_reference(lp[b], lens[b], beam=K, lm=lm,
                                        alpha=alpha, beta=beta)
            assert [int(x) for x in dev[b]] == ref, (trial, b, B, T, V, K)


def test_lm_fusion_matches_exhaustive_oracle():
    """INDEPENDENT fusion oracle: with a beam wide enough to hold every
    prefix, the fused ranking must equal exhaustive path-sum enumeration
    re-scored as log P_ctc(prefix) + alpha*sequence_logp + beta*len —
    built directly from NGramLM.score, not from beam_decode_reference
    (which every other fusion test uses as its own spec)."""
    vocab = Vocab.build(["あい"], add_unk=False)      # V = 3 (blank, あ, い)
    lm = NGramLM.train(["あいあい", "いあい"], vocab, order=2)
    rng = np.random.default_rng(17)
    for alpha, beta in ((0.7, 0.0), (0.4, 1.1)):
        logits = rng.standard_normal((1, 4, 3)).astype(np.float32) * 1.5
        lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))[0]
        fused = [(np.log(p) + alpha * lm.sequence_logp(pfx)
                  + beta * len(pfx), pfx)
                 for pfx, p in ((k, v) for k, v in _exhaustive(lp))]
        want = list(max(fused)[1])
        ref = beam_decode_reference(lp, 4, beam=64, lm=lm,
                                    alpha=alpha, beta=beta)
        dev = beam_decode(logits, np.asarray([4]), beam=16, lm=lm,
                          alpha=alpha, beta=beta)
        assert ref == want, (alpha, beta, ref, want)
        assert [int(x) for x in dev[0]] == want, (alpha, beta)
