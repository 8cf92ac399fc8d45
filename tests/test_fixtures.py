"""Frozen-spec guard (VERDICT.md r1 item 7): the golden oracles must
reproduce the checked-in fixture outputs EXACTLY for the pinned inputs —
a refactor of golden_np/ctc_numpy that changes results fails here until
tests/fixtures/generate.py is deliberately re-run (moving the spec is an
explicit act, never a side effect)."""

import os

import numpy as np

from chainer_speech_recognition.frontend.golden_np import features
from chainer_speech_recognition.ops.ctc_numpy import ctc_loss_batch_np

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden.npz")


def _fixture():
    assert os.path.exists(FIX), (
        "missing tests/fixtures/golden.npz — run tests/fixtures/generate.py")
    return np.load(FIX)


def test_frontend_matches_frozen_fixture():
    fx = _fixture()
    for name in ("tones", "noise", "ramp"):
        got = features(fx[f"sig_{name}"], apply_cmvn=True)
        np.testing.assert_allclose(got, fx[f"feat_{name}"],
                                   atol=1e-6, rtol=1e-6, err_msg=name)
        got = features(fx[f"sig_{name}"], apply_cmvn=False)
        np.testing.assert_allclose(got, fx[f"feat_nocmvn_{name}"],
                                   atol=1e-6, rtol=1e-6, err_msg=name)


def test_ctc_matches_frozen_fixture():
    fx = _fixture()
    loss, grad = ctc_loss_batch_np(fx["ctc_logits"], fx["ctc_t_len"],
                                   fx["ctc_labels"], fx["ctc_lab_len"])
    fin = np.isfinite(fx["ctc_loss"])
    np.testing.assert_allclose(loss[fin], fx["ctc_loss"][fin],
                               atol=1e-9, rtol=1e-9)
    np.testing.assert_array_equal(fin, np.isfinite(loss))
    np.testing.assert_allclose(grad, fx["ctc_grad"], atol=1e-9, rtol=1e-9)
