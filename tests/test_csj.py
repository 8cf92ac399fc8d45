"""CSJ-style corpus ingestion: Kaldi segments + Japanese text normalization
(VERDICT.md r1 "What's missing" #2 — corpus realism)."""

import numpy as np
import pytest

from chainer_speech_recognition import constants as C
from chainer_speech_recognition.config import BucketConfig
from chainer_speech_recognition.data.corpus import (
    build_vocab, load_signal, normalize_texts, scan_kaldi_style)
from chainer_speech_recognition.data.jptext import (
    hira_to_kata, kata_to_hira, normalize)
from chainer_speech_recognition.data.packed import (
    PackedBatchLoader, PackedCorpus, pack_corpus)
from chainer_speech_recognition.data.sampler import BatchLoader
from chainer_speech_recognition.utils.wav import read_wav, write_wav


# ---------------------------------------------------------------------------
# jptext
# ---------------------------------------------------------------------------

def test_normalize_strips_filler_and_event_tags():
    assert normalize("(F えー)これは<笑>テストです。") == "これはテストです"


def test_normalize_keeps_left_of_annotation_pairs():
    assert normalize("(A ニジュー;二十)パーセント") == "ニジューパーセント"
    # nested: disfluency containing a filler
    assert normalize("(D (F え)あの)きょう") == "きょう"


def test_normalize_uncertain_keeps_content():
    assert normalize("(? きょう)は") == "きょうは"


def test_normalize_glued_drop_tags():
    """Tags written without a following space — ``(笑)``, ``(D2それ)`` —
    must drop like their spaced forms, not leak content (ADVICE r1)."""
    assert normalize("これは(笑)です") == "これはです"
    assert normalize("(D2それ)きょう") == "きょう"
    assert normalize("(Fあの)続き") == "続き"
    # a bare parenthetical that is NOT a tag keeps its content
    assert normalize("(あの)続き") == "あの続き"


def test_normalize_punct_and_nfkc():
    # fullwidth digits/latin fold to ASCII; punctuation and spaces vanish
    assert normalize("ＡＢ１、 こんにちは！") == "AB1こんにちは"
    # the kana long-vowel mark must survive punctuation stripping
    assert normalize("コーヒー") == "コーヒー"
    # NFKC runs BEFORE tag stripping: annotations written with fullwidth
    # parens / tag letters / semicolons must still strip (the tag regexes
    # match ASCII forms only)
    assert normalize("（Ｆ えー）うん") == "うん"
    assert normalize("（Ａ よみ；表記）です") == "よみです"


def test_kana_folding_roundtrip():
    assert hira_to_kata("こんにちは") == "コンニチハ"
    assert kata_to_hira("コンニチハ") == "こんにちは"
    assert normalize("こんにちはコーヒー", kana="katakana") == "コンニチハコーヒー"


# ---------------------------------------------------------------------------
# segments ingestion
# ---------------------------------------------------------------------------

@pytest.fixture
def seg_corpus(tmp_path):
    """One 4-second recording carved into two utterances + one plain
    recording without a segment entry (ignored by segments mode)."""
    rec = tmp_path / "rec1.wav"
    t = np.arange(4 * C.SAMPLE_RATE, dtype=np.float32)
    sig = 0.3 * np.sin(2 * np.pi * 440.0 * t / C.SAMPLE_RATE)
    write_wav(str(rec), sig)
    (tmp_path / "wav.scp").write_text("rec1 rec1.wav\n", encoding="utf-8")
    (tmp_path / "segments").write_text(
        "rec1_001 rec1 0.50 1.50\n"
        "rec1_002 rec1 2.00 3.75\n"
        "rec1_999 missing 0.0 1.0\n"       # unknown recording: skipped
        "rec1_003 rec1 3.50 9.00\n"        # end past recording: clamped
        "rec1_004 rec1 5.00 6.00\n",       # fully out of range: skipped
        encoding="utf-8")
    (tmp_path / "text").write_text(
        "rec1_001 (F えー)こんにちは。\n"
        "rec1_002 さようなら\n"
        "rec1_003 おわり\n"
        "rec1_004 ない\n", encoding="utf-8")
    return tmp_path, sig


def test_scan_segments(seg_corpus):
    root, sig = seg_corpus
    utts = scan_kaldi_style(str(root))
    assert [u.utt_id for u in utts] == ["rec1_001", "rec1_002", "rec1_003"]
    u1, u2, u3 = utts
    assert u1.offset_samples == C.SAMPLE_RATE // 2
    assert u1.num_samples == C.SAMPLE_RATE
    assert u2.num_samples == int(1.75 * C.SAMPLE_RATE)
    # rec1_003's end (9.0 s) is clamped to the 4.0 s recording (ADVICE r1):
    # num_samples must reflect the REAL slice so bucketing is correct
    assert u3.num_samples == int(0.5 * C.SAMPLE_RATE)
    assert len(load_signal(u3, read_wav)) == u3.num_samples
    # load_signal slices the recording exactly
    s1 = load_signal(u1, read_wav)
    np.testing.assert_allclose(
        s1, np.asarray(sig[8000:24000]), atol=1 / 32768.0)
    utts = normalize_texts(utts)
    assert utts[0].text == "こんにちは"


def test_scan_skips_unreadable_recording(seg_corpus, capsys):
    """A missing/corrupt wav listed in wav.scp must skip its segments with
    a warning, not abort the whole corpus scan (ADVICE r2)."""
    root, _ = seg_corpus
    (root / "wav.scp").write_text(
        "rec1 rec1.wav\nrec2 rec2.wav\nrec3 rec3.wav\n", encoding="utf-8")
    (root / "rec3.wav").write_bytes(b"RIFFgarbage")  # corrupt header
    with open(root / "segments", "a", encoding="utf-8") as f:
        f.write("rec2_001 rec2 0.0 1.0\n"     # missing wav → OSError
                "rec3_001 rec3 0.0 1.0\n")    # corrupt wav → wave.Error
    with open(root / "text", "a", encoding="utf-8") as f:
        f.write("rec2_001 これはない\nrec3_001 これもない\n")
    utts = scan_kaldi_style(str(root))
    assert [u.utt_id for u in utts] == ["rec1_001", "rec1_002", "rec1_003"]
    err = capsys.readouterr().err
    assert "rec2" in err and "rec3" in err


def test_segments_through_pack_and_loader(seg_corpus, tmp_path):
    root, sig = seg_corpus
    utts = normalize_texts(scan_kaldi_style(str(root)))
    vocab = build_vocab(utts)
    cfg = BucketConfig(boundaries=(4096,), batch_sizes=(2,), max_label_len=16)

    # packed path: the pack stores the SLICED segments
    prefix = str(tmp_path / "seg")
    pack_corpus(prefix, utts, vocab)
    pc = PackedCorpus(prefix)
    np.testing.assert_allclose(pc.signal(0), load_signal(utts[0], read_wav),
                               atol=2 / 32768.0)
    assert pc.signal_i16(1).shape[0] == utts[1].num_samples

    # streaming BatchLoader slices too
    b = BatchLoader(utts, vocab, cfg).load(0, np.array([0, 1]))
    assert b["num_samples"][0] == utts[0].num_samples
    np.testing.assert_allclose(
        b["signals"][0, : utts[0].num_samples],
        load_signal(utts[0], read_wav), atol=1 / 32768.0)


def test_large_vocab_tones_stay_inside_mel_band():
    """Every synthesizable symbol must live inside the mel filterbank —
    the round-3 parity-corpus bug (ids >= 53 above MEL_FMAX had zero
    feature energy, an irreducible ~0.36 CER floor) must not regress."""
    from chainer_speech_recognition.data.synthetic import tone_frequency

    for V in (41, 82, 200):
        freqs = [tone_frequency(k, V) for k in range(1, V)]
        assert min(freqs) >= C.MEL_FMIN + 100
        assert max(freqs) <= C.MEL_FMAX * 0.95
        assert all(b > a for a, b in zip(freqs, freqs[1:]))  # distinct, sorted
