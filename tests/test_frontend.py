"""Golden-oracle parity tests for the audio front-end (SURVEY.md §4.1).

The golden NumPy front-end (frontend/golden_np.py) is the executable spec of
the reference's librosa-style feature pipeline; the device path must be
fp32-allclose to it on every valid frame, for every utterance in a ragged
padded batch, with and without CMVN.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from chainer_speech_recognition import constants as C
from chainer_speech_recognition.frontend import golden_np as g
from chainer_speech_recognition.frontend.jnp_frontend import batch_features, frame_lengths


def _signals(seed=0, lens=(16000, 12345, 8000, 2000)):
    rng = np.random.default_rng(seed)
    nmax = max(lens)
    sigs = np.zeros((len(lens), nmax), np.float32)
    for i, L in enumerate(lens):
        sigs[i, :L] = rng.standard_normal(L).astype(np.float32)
    return sigs, list(lens)


# ---- golden-internal invariants -------------------------------------------

def test_mel_filterbank_shape_and_coverage():
    fb = g.mel_filterbank()
    assert fb.shape == (C.N_MELS, 1 + C.N_FFT // 2)
    assert np.all(fb >= 0)
    # every mel filter has nonzero area
    assert np.all(fb.sum(axis=1) > 0)
    # interior fft bins inside the mel range are STRICTLY covered (no gap
    # between adjacent triangles); >= 0 would be a tautology of fb >= 0
    lo = np.flatnonzero(fb.sum(axis=0) > 0)[0]
    hi = np.flatnonzero(fb.sum(axis=0) > 0)[-1]
    assert hi - lo > fb.shape[1] // 2          # a real span of the axis
    assert np.all(fb[:, lo:hi + 1].sum(axis=0) > 0)


def test_num_frames_convention():
    assert C.num_frames(16000) == 101
    assert C.num_frames(C.HOP_LENGTH) == 2


def test_golden_feature_shape():
    sig = np.random.default_rng(1).standard_normal(4000).astype(np.float32)
    f = g.features(sig)
    assert f.shape == (C.num_frames(4000), C.N_MELS, 3)
    assert f.dtype == np.float32


def test_golden_delta_constant_input_is_zero():
    x = np.ones((50, C.N_MELS), np.float32) * 3.0
    assert np.abs(g.delta(x)).max() == 0.0


def test_golden_cmvn_moments():
    x = np.random.default_rng(2).standard_normal((200, C.N_MELS)).astype(np.float32) * 5 + 3
    y = g.cmvn(x)
    assert np.abs(y.mean(axis=0)).max() < 1e-5
    assert np.abs(y.std(axis=0) - 1.0).max() < 1e-3


# ---- device-vs-golden parity ----------------------------------------------

@pytest.mark.parametrize("cmvn", [True, False])
def test_batch_features_matches_golden(cmvn):
    sigs, lens = _signals()
    feats, flens = batch_features(jnp.asarray(sigs), jnp.asarray(lens), apply_cmvn=cmvn)
    feats, flens = np.asarray(feats), np.asarray(flens)
    assert feats.shape == (len(lens), C.num_frames(sigs.shape[1]), C.N_MELS, 3)
    for i, L in enumerate(lens):
        ref = g.features(sigs[i, :L], apply_cmvn=cmvn)
        T = ref.shape[0]
        assert flens[i] == T
        np.testing.assert_allclose(feats[i, :T], ref, atol=5e-4, rtol=1e-3)
        assert np.all(feats[i, T:] == 0), "padded frames must be zeroed"


def test_batch_features_padding_invariance():
    """An utterance's features must not depend on how much batch padding follows."""
    sigs, lens = _signals(lens=(9000, 5000))
    f1, _ = batch_features(jnp.asarray(sigs), jnp.asarray(lens))
    wide = np.zeros((2, 20000), np.float32)
    wide[:, : sigs.shape[1]] = sigs
    f2, _ = batch_features(jnp.asarray(wide), jnp.asarray(lens))
    T = C.num_frames(5000)
    np.testing.assert_allclose(
        np.asarray(f1)[1, :T], np.asarray(f2)[1, :T], atol=1e-5, rtol=1e-5
    )


def test_frame_lengths():
    out = np.asarray(frame_lengths(jnp.asarray([16000, 160, 0])))
    assert list(out) == [101, 2, 1]
