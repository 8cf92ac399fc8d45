"""Train-loop guard: an all-filtered corpus must fail fast, not spin."""

import numpy as np
import pytest

from chainer_speech_recognition.config import preset_config
from chainer_speech_recognition.data.corpus import Utterance
from chainer_speech_recognition.train.loop import train
from chainer_speech_recognition.vocab import Vocab


def test_untrainable_corpus_raises(tmp_path):
    # one utterance, longer than every bucket boundary
    utts = [Utterance("u0", "/nonexistent.wav", "あい", 10_000_000)]
    vocab = Vocab.build(["あい"])
    cfg = preset_config("tiny_conv").override({
        "model.vocab_size": len(vocab),
        "train.checkpoint_dir": str(tmp_path / "ck")})
    with pytest.raises(ValueError, match="no trainable batches"):
        train(cfg, utts, vocab, resume=False)


def test_batch_not_divisible_by_mesh_raises(tmp_path):
    """batch % devices != 0 must fail with a clear message, not a raw
    shard_map error (VERDICT.md round-1 Weak #7)."""
    utts = [Utterance(f"u{i}", "/nonexistent.wav", "あい", 16000)
            for i in range(8)]
    vocab = Vocab.build(["あい"])
    cfg = preset_config("tiny_conv").override({
        "model.vocab_size": len(vocab),
        "buckets.boundaries": [128], "buckets.batch_sizes": [6],  # 6 % 8 != 0
        "train.checkpoint_dir": str(tmp_path / "ck")})
    with pytest.raises(ValueError, match="not divisible"):
        train(cfg, utts, vocab, resume=False)


def test_frozen_dsp_knobs_fail_loudly():
    """Overriding a frozen DSP parameter must raise at config construction
    (VERDICT.md round-1 Weak #3: the knobs used to be silently dead)."""
    cfg = preset_config("tiny_conv")
    with pytest.raises(ValueError, match="frozen parity constant"):
        cfg.override({"features.n_mels": 80})
    with pytest.raises(ValueError, match="frozen parity constant"):
        cfg.override({"features.hop_length": 100})
    # non-DSP feature knobs stay tunable
    assert cfg.override({"features.cmvn": False}).features.cmvn is False


@pytest.mark.slow
def test_sigterm_graceful_checkpoint(tmp_path):
    """Graceful preemption (SURVEY.md §5.3): SIGTERM mid-training must
    finish the in-flight dispatch, write a checkpoint at the CURRENT step
    (not the last checkpoint_every boundary), log a signal_stop row, and
    exit 0 — so a preempted run resumes exactly where it stopped."""
    import json
    import os
    import signal
    import subprocess
    import sys
    import time

    from chainer_speech_recognition.data.synthetic import make_utterance
    from chainer_speech_recognition.utils.wav import write_wav

    corpus = tmp_path / "corpus"
    os.makedirs(corpus)
    rng = np.random.default_rng(0)
    kana = ["あ", "い", "う"]
    for i in range(24):
        ids = [1 + int(rng.integers(0, 3))]
        for _ in range(2):
            k = 1 + int(rng.integers(0, 3))
            while k == ids[-1]:
                k = 1 + int(rng.integers(0, 3))
            ids.append(k)
        sig, _ = make_utterance(rng, ids, tone_len=1600)
        write_wav(str(corpus / f"u{i:02d}.wav"), sig)
        (corpus / f"u{i:02d}.txt").write_text(
            "".join(kana[k - 1] for k in ids))

    from chainer_speech_recognition.cli import preprocess as pre_cli
    pre_cli.main(["--corpus", str(corpus), "--out", str(tmp_path / "prep")])

    metrics = tmp_path / "m.jsonl"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "chainer_speech_recognition.cli.train",
         "--data-dir", str(tmp_path / "prep"),
         "--preset", "tiny_conv",
         "--ckpt-dir", str(tmp_path / "ck"),
         "--metrics", str(metrics),
         "--set", "buckets.boundaries=[128]", "buckets.batch_sizes=[8]",
         "train.total_steps=100000", "train.log_every=1",
         "train.checkpoint_every=100000", "train.eval_every=100000",
         "model.rnn_hidden=8", "model.conv_channels=[8,8]"],
        env=env, cwd=os.path.dirname(os.path.dirname(__file__)),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 300
        stepped = False
        while time.time() < deadline and not stepped:
            time.sleep(1.0)
            if metrics.exists():
                rows = [json.loads(l) for l in
                        metrics.read_text().splitlines() if l.strip()]
                stepped = any(r.get("kind") == "train" and r["step"] >= 3
                              for r in rows)
            assert proc.poll() is None, "train exited before signal"
        assert stepped, "no train progress before deadline"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0, "non-graceful exit"
    finally:
        if proc.poll() is None:
            proc.kill()
    rows = [json.loads(l) for l in metrics.read_text().splitlines()
            if l.strip()]
    stops = [r for r in rows if r.get("kind") == "signal_stop"]
    assert stops and stops[-1]["signum"] == int(signal.SIGTERM)
    stop_step = stops[-1]["step"]
    assert stop_step < 100000
    cks = sorted((tmp_path / "ck").glob("step_*.npz"))
    assert cks, "no checkpoint written on SIGTERM"
    assert int(cks[-1].stem.split("_")[1]) == stop_step


def test_use_cache_conflicts_with_device_modes():
    """features.use_cache + an explicit device_cache/rotating data_mode is
    contradictory — must raise, not silently stream (review finding)."""
    from chainer_speech_recognition.data.sampler import BucketSampler
    from chainer_speech_recognition.train.loop import _resolve_data_mode

    utts = [Utterance(f"u{i}", "/x.wav", "あい", 16000) for i in range(4)]
    cfg = preset_config("tiny_conv").override({
        "features.use_cache": True, "train.data_mode": "device_cache"})
    sampler = BucketSampler(utts, cfg.buckets, seed=0)
    with pytest.raises(ValueError, match="incompatible"):
        _resolve_data_mode(cfg, sampler)
    ok = cfg.override({"train.data_mode": "auto"})
    assert _resolve_data_mode(ok, sampler) == "stream"
