"""Decoder + scoring tests: on-device greedy vs host oracle; CER metric
(SURVEY.md §4.1 "decoders vs slow pure-Python references")."""

import numpy as np

import jax.numpy as jnp

from chainer_speech_recognition.constants import PAD_LABEL_ID
from chainer_speech_recognition.decode.greedy import greedy_decode, greedy_decode_np
from chainer_speech_recognition.decode.metrics import CERAccumulator, edit_distance


def test_greedy_matches_host_oracle():
    rng = np.random.default_rng(0)
    B, T, V = 8, 30, 6
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    ids, out_lens = greedy_decode(jnp.asarray(logits), jnp.asarray(lens))
    ids, out_lens = np.asarray(ids), np.asarray(out_lens)
    for b in range(B):
        ref = greedy_decode_np(logits[b], lens[b])
        hyp = list(ids[b, : out_lens[b]])
        assert hyp == ref, (b, hyp, ref)
        assert np.all(ids[b, out_lens[b]:] == PAD_LABEL_ID)


def test_greedy_collapse_rules():
    # sequence: b a a b b c c -> "a c"; blank=0 at index 0
    path = [0, 1, 1, 0, 0, 2, 2]
    logits = np.full((1, len(path), 3), -10.0, np.float32)
    for t, k in enumerate(path):
        logits[0, t, k] = 10.0
    ids, out_lens = greedy_decode(jnp.asarray(logits), jnp.asarray([len(path)]))
    assert list(np.asarray(ids)[0, : int(out_lens[0])]) == [1, 2]


def test_greedy_respects_lengths():
    logits = np.full((1, 6, 3), -10.0, np.float32)
    logits[:, :, 1] = 10.0  # all frames say "1"
    ids, out_lens = greedy_decode(jnp.asarray(logits), jnp.asarray([3]))
    assert list(np.asarray(ids)[0, : int(out_lens[0])]) == [1]


def test_greedy_out_lens_clamped_to_max_len():
    """More emitted symbols than max_len: out_lens must clamp to the id
    matrix width — callers slice ids[b, :out_lens[b]] and an unclamped
    length walks into pads."""
    path = [1, 2, 1, 2, 1, 2]                        # 6 distinct emissions
    logits = np.full((1, len(path), 3), -10.0, np.float32)
    for t, k in enumerate(path):
        logits[0, t, k] = 10.0
    ids, out_lens = greedy_decode(jnp.asarray(logits),
                                  jnp.asarray([len(path)]), max_len=3)
    assert ids.shape == (1, 3)
    assert int(out_lens[0]) == 3
    assert list(np.asarray(ids)[0]) == [1, 2, 1]     # first max_len symbols


def test_edit_distance():
    assert edit_distance("kitten", "sitting") == 3
    assert edit_distance("", "abc") == 3
    assert edit_distance("abc", "") == 3
    assert edit_distance([1, 2, 3], [1, 3]) == 1
    assert edit_distance("same", "same") == 0


def test_cer_accumulator():
    acc = CERAccumulator()
    acc.add("abcd", "abc")   # 1 edit / 3 ref chars
    acc.add("xyz", "xyz")    # 0 / 3
    assert abs(acc.cer - 1 / 6) < 1e-12
    assert acc.num_utts == 2
