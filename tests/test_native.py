"""C++ runtime components vs Python oracles (SURVEY.md §2.9 equivalents)."""

import numpy as np
import pytest

from chainer_speech_recognition.decode.metrics import (
    edit_distance, edit_distance_py)
from chainer_speech_recognition.utils.native import (
    edit_distance_native, get_lib, read_wav_native)
from chainer_speech_recognition.utils.wav import (
    read_wav, read_wav_py, write_wav)


def test_native_builds():
    assert get_lib() is not None, "g++ build of native/csr_native.cpp failed"


def test_edit_distance_differential():
    rng = np.random.default_rng(0)
    for _ in range(100):
        a = list(rng.integers(0, 5, int(rng.integers(0, 25))))
        b = list(rng.integers(0, 5, int(rng.integers(0, 25))))
        assert edit_distance_native(a, b) == edit_distance_py(a, b)


def test_edit_distance_strings_route_through_native():
    # first, verify the ROUTING claim in this test's name: the native
    # entry point actually answers for ord()-mapped strings (a silent
    # fallback to edit_distance_py would make the value checks vacuous)
    from chainer_speech_recognition.utils.native import (
        edit_distance_native, get_lib)
    if get_lib() is not None:
        assert edit_distance_native(
            [ord(c) for c in "こんにちは"],
            [ord(c) for c in "こんばんは"]) == 2
    assert edit_distance("kitten", "sitting") == 3
    assert edit_distance("こんにちは", "こんばんは") == 2
    assert edit_distance("", "") == 0


def test_wav_native_differential(tmp_path):
    rng = np.random.default_rng(1)
    sig = rng.uniform(-0.9, 0.9, 12345).astype(np.float32)
    path = str(tmp_path / "x.wav")
    write_wav(path, sig)
    w_py = read_wav_py(path)
    native = read_wav_native(path)
    assert native is not None
    w_c, rate = native
    assert rate == 16000
    np.testing.assert_array_equal(w_py, w_c)
    assert read_wav(path).dtype == np.float32


def test_wav_bad_rate_strict_mode_raises(tmp_path):
    import wave
    path = str(tmp_path / "bad.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1); w.setsampwidth(2); w.setframerate(8000)
        w.writeframes(b"\x00\x00" * 100)
    with pytest.raises(ValueError):
        read_wav(path, resample=False)


def test_wav_native_malformed_returns_none(tmp_path):
    path = str(tmp_path / "junk.wav")
    with open(path, "wb") as f:
        f.write(b"not a wav file at all, definitely not RIFF")
    assert read_wav_native(path) is None


def test_edit_distance_batch_differential():
    """Batched C++ kernel (ONE ctypes call per eval batch) vs per-pair
    oracle, mixed lengths including empties, strings and id lists."""
    from chainer_speech_recognition.decode.metrics import (
        edit_distance_batch)

    rng = np.random.default_rng(2)
    hyps, refs = [], []
    for _ in range(40):
        hyps.append(list(rng.integers(1, 6, int(rng.integers(0, 30)))))
        refs.append(list(rng.integers(1, 6, int(rng.integers(0, 30)))))
    out = edit_distance_batch(hyps, refs)
    want = [edit_distance_py(h, r) for h, r in zip(hyps, refs)]
    np.testing.assert_array_equal(out, want)
    # string inputs route through ord()
    s = edit_distance_batch(["kitten", "こんにちは", ""],
                            ["sitting", "こんばんは", "ab"])
    np.testing.assert_array_equal(s, [3, 2, 2])


def test_cer_accumulator_batch_matches_scalar():
    from chainer_speech_recognition.decode.metrics import CERAccumulator

    rng = np.random.default_rng(3)
    pairs = [("".join(chr(97 + c) for c in rng.integers(0, 4, 12)),
              "".join(chr(97 + c) for c in rng.integers(0, 4, 10)))
             for _ in range(16)]
    a, b = CERAccumulator(), CERAccumulator()
    for h, r in pairs:
        a.add(h, r)
    b.add_batch([h for h, _ in pairs], [r for _, r in pairs])
    assert (a.edits, a.ref_len, a.num_utts) == (b.edits, b.ref_len, b.num_utts)
    assert a.cer == b.cer


def test_wav_native_truncated_fmt_chunk_safe(tmp_path):
    """fmt header at the buffer tail: the parser must bounds-check the
    16-byte fmt body (previously a heap out-of-bounds read) and reject."""
    path = str(tmp_path / "trunc.wav")
    body = (b"RIFF" + (36).to_bytes(4, "little") + b"WAVE"
            + b"fmt " + (16).to_bytes(4, "little") + b"\x01\x00\x01\x00")
    with open(path, "wb") as f:
        f.write(body)
    assert read_wav_native(path) is None
    # fuzz a few hundred truncations/mutations of a valid header: none may
    # crash the process (OOB would segfault under ASan/valgrind; here we
    # assert clean None-or-array behavior)
    import numpy as np
    valid = (b"RIFF" + (100).to_bytes(4, "little") + b"WAVE"
             + b"fmt " + (16).to_bytes(4, "little")
             + b"\x01\x00\x01\x00" + (16000).to_bytes(4, "little")
             + (32000).to_bytes(4, "little") + b"\x02\x00\x10\x00"
             + b"data" + (64).to_bytes(4, "little") + b"\x00" * 64)
    rng = np.random.default_rng(0)
    for i in range(300):
        buf = bytearray(valid[: int(rng.integers(8, len(valid) + 1))])
        for _ in range(int(rng.integers(0, 4))):
            buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        with open(path, "wb") as f:
            f.write(bytes(buf))
        out = read_wav_native(path)
        assert out is None or (isinstance(out, tuple)
                               and hasattr(out[0], "shape"))
