"""Data pipeline tests: corpus scan/index round-trip, bucketing, sampler
determinism + resume, prefetcher, WAV I/O (SURVEY.md §2.2)."""

import os

import numpy as np

from chainer_speech_recognition import constants as C
from chainer_speech_recognition.config import BucketConfig
from chainer_speech_recognition.data.buckets import (
    assign_bucket, bucket_shapes, padding_waste)
from chainer_speech_recognition.data.corpus import (
    build_vocab, load_index, save_index, scan_corpus)
from chainer_speech_recognition.data.sampler import (
    BatchLoader, BucketSampler, Prefetcher)
from chainer_speech_recognition.data.synthetic import make_utterance
from chainer_speech_recognition.utils.wav import read_wav, write_wav


def _make_corpus(root, n=12, seed=0):
    rng = np.random.default_rng(seed)
    texts = ["あい", "うえお", "かきく", "けこさ"]
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        sig, _ = make_utterance(rng, [1 + i % 4] * (1 + i % 3),
                                tone_len=1600 + 400 * (i % 5))
        write_wav(os.path.join(root, f"utt{i:03d}.wav"), sig)
        with open(os.path.join(root, f"utt{i:03d}.txt"), "w") as f:
            f.write(texts[i % 4])


def test_wav_roundtrip(tmp_path):
    sig = np.random.default_rng(0).uniform(-0.5, 0.5, 4000).astype(np.float32)
    path = str(tmp_path / "x.wav")
    write_wav(path, sig)
    back = read_wav(path)
    assert back.shape == sig.shape
    np.testing.assert_allclose(back, sig, atol=1 / 32768)


def test_scan_and_index_roundtrip(tmp_path):
    root = str(tmp_path / "corpus")
    _make_corpus(root)
    utts = scan_corpus(root)
    assert len(utts) == 12
    assert all(u.text for u in utts)
    assert utts[0].num_frames == C.num_frames(utts[0].num_samples)
    idx_path = str(tmp_path / "index.jsonl")
    save_index(idx_path, utts)
    assert load_index(idx_path) == utts
    vocab = build_vocab(utts)
    assert len(vocab) > 2


def test_scan_corpus_non16k_uses_contract_rate(tmp_path):
    """scan_corpus must index lengths at the 16 kHz CONTRACT rate (what
    read_wav's resampler delivers), not the wav's native rate — a 48 kHz
    corpus would otherwise bucket at 3x-overstated frame counts."""
    root = str(tmp_path / "c48")
    os.makedirs(root)
    sig = np.zeros(48000, np.float32)           # 1 s at 48 kHz
    write_wav(os.path.join(root, "a.wav"), sig, sample_rate=48000)
    with open(os.path.join(root, "a.txt"), "w") as f:
        f.write("あい")
    (u,) = scan_corpus(root)
    assert u.num_samples == C.SAMPLE_RATE        # 1 s at the contract rate
    assert len(read_wav(u.wav)) == u.num_samples


def test_assign_bucket_and_waste():
    cfg = BucketConfig(boundaries=(100, 200), batch_sizes=(4, 2))
    idx = assign_bucket(np.asarray([50, 100, 150, 201]), cfg)
    assert list(idx) == [0, 0, 1, -1]
    shapes = bucket_shapes(cfg)
    # max_samples is the LARGEST N whose frame count still fits the bucket
    # — one sample fewer than 100 hops, NOT 99 hops (which silently
    # clipped ~10 ms off exactly-boundary utterances)
    assert shapes[0].max_samples == 100 * C.HOP_LENGTH - 1
    assert C.num_frames(shapes[0].max_samples) == 100
    assert C.num_frames(shapes[0].max_samples + 1) == 101
    w = padding_waste([50, 100], cfg)
    assert abs(w - (1 - 150 / 200)) < 1e-9


def test_eval_batches_full_coverage(tmp_path):
    """eval_batches must score EVERY kept utterance exactly once, padding
    partial batches with repeats (static shapes) + an n_valid count."""
    root = str(tmp_path / "corpus")
    _make_corpus(root, n=23)
    utts = scan_corpus(root)
    cfg = BucketConfig(boundaries=(64, 128), batch_sizes=(4, 4),
                       max_label_len=8)
    s = BucketSampler(utts, cfg, seed=0)
    seen = []
    for bid, idxs, n_valid in s.eval_batches():
        assert len(idxs) == s.shapes[bid].batch_size  # static shape
        assert 1 <= n_valid <= len(idxs)
        seen.extend(int(i) for i in idxs[:n_valid])
    kept = sorted(int(i) for b in s.buckets for i in b)
    assert sorted(seen) == kept, "every kept utterance scored exactly once"


def test_sampler_determinism_and_shapes(tmp_path):
    root = str(tmp_path / "corpus")
    _make_corpus(root, n=24)
    utts = scan_corpus(root)
    cfg = BucketConfig(boundaries=(64, 128), batch_sizes=(4, 4),
                       max_label_len=8)
    s1 = BucketSampler(utts, cfg, seed=7)
    s2 = BucketSampler(utts, cfg, seed=7)
    b1, b2 = s1.epoch_batches(3), s2.epoch_batches(3)
    assert len(b1) > 0
    assert all((x[0] == y[0]) and np.array_equal(x[1], y[1])
               for x, y in zip(b1, b2))
    # different epoch ⇒ different order
    assert any(not np.array_equal(x[1], y[1])
               for x, y in zip(b1, s1.epoch_batches(4)))

    vocab = build_vocab(utts)
    loader = BatchLoader(utts, vocab, cfg)
    for batch in Prefetcher(loader, b1[:3]):
        bid = batch["bucket_id"]
        shape = s1.shapes[bid]
        assert batch["signals"].shape == (shape.batch_size, shape.max_samples)
        assert batch["labels"].shape == (shape.batch_size, shape.max_label_len)
        assert (batch["num_samples"] > 0).all()
        assert (batch["label_lengths"] > 0).all()


def test_kaldi_style_corpus(tmp_path):
    root = str(tmp_path / "kaldi")
    os.makedirs(root)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(4):
        sig, _ = make_utterance(rng, [1 + i % 3], tone_len=2000)
        write_wav(os.path.join(root, f"a{i}.wav"), sig)
        rows.append((f"utt-{i}", f"a{i}.wav", "あい"[i % 2]))
    with open(os.path.join(root, "wav.scp"), "w") as f:
        f.writelines(f"{u} {w}\n" for u, w, _ in rows)
    with open(os.path.join(root, "text"), "w", encoding="utf-8") as f:
        f.writelines(f"{u} {t}\n" for u, _, t in rows)
    from chainer_speech_recognition.data.corpus import scan_kaldi_style
    utts = scan_kaldi_style(root)
    assert [u.utt_id for u in utts] == [f"utt-{i}" for i in range(4)]
    assert utts[0].num_samples == 2000 and utts[0].text == "あ"
    assert read_wav(utts[0].wav).shape == (2000,)


def test_wav_resample_and_stereo_downmix(tmp_path):
    """Non-16 kHz and stereo inputs are normalized on read (r1 item 10)."""
    from chainer_speech_recognition.utils.wav import resample_sinc
    sr_in = 22050
    t = np.arange(int(sr_in * 0.12)) / sr_in
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    p = str(tmp_path / "hi.wav")
    write_wav(p, tone, sample_rate=sr_in)
    sig = read_wav(p)
    assert abs(len(sig) - int(len(tone) * 16000 / sr_in)) <= 1
    # the resampled tone still correlates >0.99 with an ideal 16 kHz tone
    t16 = np.arange(len(sig)) / 16000.0
    ref = 0.5 * np.sin(2 * np.pi * 440.0 * t16)
    m = slice(100, len(sig) - 100)                 # ignore filter edges
    corr = np.dot(sig[m], ref[m]) / (np.linalg.norm(sig[m])
                                     * np.linalg.norm(ref[m]))
    assert corr > 0.99, corr
    # stereo: mean of channels
    st = str(tmp_path / "st.wav")
    left = np.linspace(-0.5, 0.5, 800).astype(np.float32)
    right = np.full(800, 0.25, np.float32)
    inter = np.stack([left, right], axis=1).reshape(-1)
    write_wav(st, inter, channels=2)
    got = read_wav(st)
    np.testing.assert_allclose(got, (left + right) / 2, atol=1e-4)
    # identity: 16 kHz passthrough returns the input UNTOUCHED
    np.testing.assert_array_equal(resample_sinc(tone, 16000, 16000), tone)


def test_mora_segmenter_and_multiunit_vocab():
    from chainer_speech_recognition.vocab import Vocab, segment_mora
    assert segment_mora("きゃく") == ["きゃ", "く"]
    assert segment_mora("ファン") == ["ファ", "ン"]
    assert segment_mora("こんにちは") == list("こんにちは")
    v = Vocab.build(["きゃく", "くち"], add_unk=False, unit="mora")
    ids = v.encode("きゃく")
    assert len(ids) == 2 and v.decode(ids) == "きゃく"
    # greedy longest-match prefers the multi-char unit
    assert v.encode("きゃ") == [v._to_id["きゃ"]]


def test_prefetcher_early_stop(tmp_path):
    """Abandoning iteration early must terminate the loader thread."""
    import threading
    import time
    root = str(tmp_path / "corpus")
    _make_corpus(root, n=24)
    utts = scan_corpus(root)
    cfg = BucketConfig(boundaries=(64,), batch_sizes=(2,), max_label_len=8)
    vocab = build_vocab(utts)
    s = BucketSampler(utts, cfg, seed=0)
    loader = BatchLoader(utts, vocab, cfg)
    pf = Prefetcher(loader, s.epoch_batches(0), depth=1, num_workers=2)
    it = iter(pf)
    next(it)                      # consume one batch, abandon the rest
    it.close()                    # generator finally → stop()
    assert pf._stop.is_set()
    deadline = time.time() + 5.0
    while time.time() < deadline:
        alive = [t for t in threading.enumerate()
                 if t.name.startswith("csr-loader") and t.is_alive()]
        if not alive:
            break
        time.sleep(0.05)
    # the claim in this test's name: worker threads actually TERMINATE
    # (cancel_futures in Prefetcher.stop) — polling without asserting
    # would pass even if stop() leaked the pool
    assert not alive, f"loader threads still alive after stop(): {alive}"
    # and a fresh iteration after stop() yields nothing
    assert list(iter(pf)) == []


def test_prefetcher_parallel_order_preserved(tmp_path):
    """num_workers>1 must still yield batches in submitted order."""
    root = str(tmp_path / "corpus")
    _make_corpus(root, n=24)
    utts = scan_corpus(root)
    cfg = BucketConfig(boundaries=(64,), batch_sizes=(2,), max_label_len=8)
    vocab = build_vocab(utts)
    s = BucketSampler(utts, cfg, seed=0)
    loader = BatchLoader(utts, vocab, cfg)
    batches = s.epoch_batches(0)
    seq = [loader.load(*b) for b in batches]
    par = list(Prefetcher(loader, batches, depth=6, num_workers=4))
    assert len(par) == len(seq)
    for a, b in zip(par, seq):
        np.testing.assert_array_equal(a["signals"], b["signals"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


def test_scan_corpus_skips_unreadable_wav(tmp_path, capsys):
    """One corrupt wav+txt pair must skip with a warning, not abort the
    whole directory scan (same policy as the Kaldi scanner)."""
    root = str(tmp_path / "c")
    _make_corpus(root, n=3)
    with open(os.path.join(root, "zzz_bad.wav"), "wb") as f:
        f.write(b"RIFFgarbage-not-a-wav")
    with open(os.path.join(root, "zzz_bad.txt"), "w") as f:
        f.write("あい")
    utts = scan_corpus(root)
    assert [u.utt_id for u in utts] == ["utt000", "utt001", "utt002"]
    assert "zzz_bad" in capsys.readouterr().err


def test_learn_bpe_units_and_roundtrip():
    """BPE unit learning (vocab.py::learn_bpe): the most frequent pair
    merges first, the target size caps the inventory, learned vocabs
    segment deterministically via greedy longest-match, and
    decode(encode(t)) == t with strictly shorter label sequences."""
    from chainer_speech_recognition.vocab import (
        BLANK_SYMBOL, UNK_SYMBOL, Vocab, learn_bpe)

    texts = ["かきかきかきすも", "かきすもすも", "かきかき"] * 5
    units = learn_bpe(texts, vocab_size=8)
    # base {か,き,す,も} + merges, capped at 8 - 2 specials = 6 units
    assert len(units) == 6
    assert "かき" in units                 # the most frequent pair
    vocab = Vocab([BLANK_SYMBOL, UNK_SYMBOL] + units)
    for t in texts:
        ids = vocab.encode(t)
        assert vocab.decode(ids) == t
        assert len(ids) < len(t)          # subwords shorten labels
    # deterministic re-learn
    assert learn_bpe(texts, vocab_size=8) == units

    # no repeating pair left -> learning stops early, no infinite loop
    tiny = learn_bpe(["あい", "うえ"], vocab_size=100)
    assert tiny == sorted("あいうえ")


def test_bpe_respects_mora_base():
    """BPE over a mora base never splits a mora: きゃ stays one unit and
    merges as a whole."""
    from chainer_speech_recognition.vocab import learn_bpe

    texts = ["きゃくきゃく", "きゃく"] * 4
    units = learn_bpe(texts, vocab_size=6, unit="mora")
    assert "きゃ" in units or "きゃく" in units
    assert "ゃ" not in units              # small kana never standalone
