"""Confusable speech-like corpus generator (VERDICT r1 missing #1: the
quality gate must rest on spectrally-overlapping, time-varying content,
not separable pure tones)."""

import numpy as np

from chainer_speech_recognition import constants as C
from chainer_speech_recognition.data.synthetic import (
    ConfusableSynth, SymbolMarkov, make_utterance)


def test_markov_text_has_structure_and_no_repeats():
    mk = SymbolMarkov(82)
    rng = np.random.default_rng(0)
    ids = mk.sample(rng, 5000)
    assert all(1 <= k <= 81 for k in ids)
    assert all(a != b for a, b in zip(ids, ids[1:]))   # CTC-unambiguous
    # sparse successors: per-state branching is far below uniform
    succ = {}
    for a, b in zip(ids, ids[1:]):
        succ.setdefault(a, set()).add(b)
    assert max(len(s) for s in succ.values()) <= 6
    # deterministic: same seeds → same chain
    ids2 = SymbolMarkov(82).sample(np.random.default_rng(0), 5000)
    assert ids == ids2


def test_confusable_symbols_have_overlapping_spectra():
    """Adjacent ids share F1 and sit one grid step apart in F2 — the
    confusable-pair construction pure tones never had."""
    s = ConfusableSynth(82)
    # within one F1 row, neighbours differ only in F2 by ~6-13%
    same_row = np.nonzero(s.f1[:-1] == s.f1[1:])[0]
    assert len(same_row) > 40
    ratio = s.f2[same_row + 1] / s.f2[same_row]
    assert (ratio > 1.0).all() and (ratio < 1.15).all()
    # all formants inside the mel band
    assert s.f1.min() > C.MEL_FMIN and s.f2.max() < C.MEL_FMAX


def test_confusable_utterance_is_deterministic_and_sane():
    s = ConfusableSynth(82)
    ids = [3, 17, 4, 60]
    sig1, lab = s.utterance(np.random.default_rng(7), ids, tone_len=800)
    sig2, _ = s.utterance(np.random.default_rng(7), ids, tone_len=800)
    np.testing.assert_array_equal(sig1, sig2)
    assert sig1.dtype == np.float32
    assert np.max(np.abs(sig1)) <= 0.5 + 1e-6
    assert np.sqrt(np.mean(sig1 ** 2)) > 0.02       # not silence
    assert list(lab) == ids


def test_confusable_energy_tracks_the_symbol_formants():
    """The mel-feature energy centroid of a low-F2 symbol must sit below a
    high-F2 symbol's — i.e. symbol identity is actually in the features."""
    from chainer_speech_recognition.frontend.golden_np import features

    s = ConfusableSynth(82)
    lo_id = int(np.argmin(s.f2 + s.f1)) + 1         # low-formant symbol
    hi_id = int(np.argmax(s.f2 + s.f1)) + 1         # high-formant symbol
    rng = np.random.default_rng(3)
    centroids = []
    for k in (lo_id, hi_id):
        sig, _ = s.utterance(rng, [k] * 4, tone_len=1600, snr_db=30.0)
        feats = features(sig, apply_cmvn=False)      # [T, n_mels, 3]
        logmel = feats[:, :, 0]
        w = np.exp(logmel - logmel.max())
        bins = np.arange(logmel.shape[1])
        centroids.append(float((w * bins).sum() / w.sum()))
    assert centroids[0] < centroids[1] - 2.0
