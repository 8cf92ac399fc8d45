"""Packed corpus + device-resident cache tests (VERDICT.md round-1 #1):

* pack/read roundtrip is sample-exact vs the WAV path;
* PackedBatchLoader batches ≡ BatchLoader batches (int16 wire format);
* the device-cache train step ≡ the streaming train step on the same rows
  under the 8-fake-device mesh;
* train() in device_cache mode learns, checkpoints, and resumes exactly.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chainer_speech_recognition.config import BucketConfig, preset_config
from chainer_speech_recognition.data.corpus import build_vocab, scan_corpus
from chainer_speech_recognition.data.device_cache import (
    DeviceCorpusCache, estimate_bytes)
from chainer_speech_recognition.data.packed import (
    PackedBatchLoader, PackedCorpus, pack_corpus)
from chainer_speech_recognition.data.sampler import (
    BatchLoader, BucketSampler)
from chainer_speech_recognition.data.synthetic import make_utterance
from chainer_speech_recognition.frontend.jnp_frontend import batch_features
from chainer_speech_recognition.models.presets import build_model
from chainer_speech_recognition.parallel.mesh import (
    batch_sharding, make_mesh, shard_batch)
from chainer_speech_recognition.train.loop import train
from chainer_speech_recognition.train.state import init_state
from chainer_speech_recognition.train.step import (
    make_cached_train_step, make_train_step)
from chainer_speech_recognition.utils.wav import read_wav, write_wav


def _make_corpus(root, n=48, seed=0):
    rng = np.random.default_rng(seed)
    texts = ["あい", "うえお", "かきく", "けこさ"]
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        sig, _ = make_utterance(rng, [1 + i % 4] * (1 + i % 3),
                                tone_len=1600 + 400 * (i % 5))
        write_wav(os.path.join(root, f"utt{i:03d}.wav"), sig)
        with open(os.path.join(root, f"utt{i:03d}.txt"), "w") as f:
            f.write(texts[i % 4])


def _packed(tmp_path, n=48):
    root = str(tmp_path / "corpus")
    _make_corpus(root, n=n)
    utts = scan_corpus(root)
    vocab = build_vocab(utts)
    prefix = str(tmp_path / "train")
    pack_corpus(prefix, utts, vocab)
    return utts, vocab, PackedCorpus(prefix)


def test_pack_roundtrip_sample_exact(tmp_path):
    utts, vocab, pc = _packed(tmp_path, n=12)
    assert len(pc) == 12
    for i, u in enumerate(utts):
        wav_sig = read_wav(u.wav)
        np.testing.assert_array_equal(pc.signal(i), wav_sig)
        np.testing.assert_array_equal(pc.label_ids(i), vocab.encode(u.text))
        assert pc.texts[i] == u.text and pc.utt_ids[i] == u.utt_id
        assert pc.utterances()[i].num_samples == u.num_samples


def test_packed_loader_matches_wav_loader(tmp_path):
    utts, vocab, pc = _packed(tmp_path, n=12)
    cfg = BucketConfig(boundaries=(64,), batch_sizes=(4,), max_label_len=8)
    wav_loader = BatchLoader(utts, vocab, cfg)
    pk_loader = PackedBatchLoader(pc, cfg)
    idxs = np.asarray([3, 7, 0, 11])
    a = wav_loader.load(0, idxs)
    b = pk_loader.load(0, idxs)
    np.testing.assert_array_equal(
        a["signals"], b["signals_i16"].astype(np.float32) / 32768.0)
    np.testing.assert_array_equal(a["num_samples"], b["num_samples"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    np.testing.assert_array_equal(a["label_lengths"], b["label_lengths"])


def _tiny_cfg(vocab_size):
    return preset_config("tiny_conv").override({
        "model.vocab_size": vocab_size, "model.compute_dtype": "float32",
        "buckets.boundaries": [64], "buckets.batch_sizes": [16],
        "buckets.max_label_len": 8,
        "optim.learning_rate": 3e-3, "optim.warmup_steps": 20,
        "optim.decay_steps": 400})


@pytest.mark.slow
def test_device_cache_step_matches_stream_step(tmp_path):
    """Same parameter update whether rows come from the HBM cache (gather
    by slot ids inside shard_map) or a host-assembled streamed batch."""
    utts, vocab, pc = _packed(tmp_path, n=48)
    cfg = _tiny_cfg(len(vocab))
    sampler = BucketSampler(utts, cfg.buckets, seed=0)
    loader = PackedBatchLoader(pc, cfg.buckets)
    mesh = make_mesh(cfg.parallel)              # 8 fake devices
    cache = DeviceCorpusCache(mesh, loader, sampler, seed=0)
    assert estimate_bytes(sampler) > 0

    batches = cache.epoch_batches(0)
    assert batches, "cache produced no batches"
    bid, slots = batches[0]

    model = build_model(cfg.model)
    ex = loader.load(bid, sampler.buckets[bid][:1])
    feats, flens = batch_features(
        jnp.asarray(ex["signals_i16"].astype(np.float32) / 32768.0),
        jnp.asarray(ex["num_samples"]))
    state = init_state(model, cfg.optim, jax.random.key(0), feats, flens)
    state2 = jax.tree.map(jnp.copy, state)

    cached_step = make_cached_train_step(model, cfg, mesh, cache)
    stream_step = make_train_step(model, cfg, mesh)

    s_c, m_c = cached_step(
        state, bid, jax.device_put(slots, batch_sharding(mesh)))
    rows = cache.utterance_indices(bid, slots)
    host = loader.load(bid, rows)
    s_s, m_s = stream_step(
        state2, shard_batch(mesh, {k: v for k, v in host.items()
                                   if k != "bucket_id"}))
    assert abs(float(m_c["loss"]) - float(m_s["loss"])) < 1e-5
    for pc_, ps_ in zip(jax.tree.leaves(s_c.params), jax.tree.leaves(s_s.params)):
        np.testing.assert_allclose(np.asarray(pc_), np.asarray(ps_), atol=1e-6)


@pytest.mark.slow
def test_feature_cache_mode_matches_recompute(tmp_path):
    """cache_features=True: the HBM cache holds front-end OUTPUT (bf16) —
    cached rows must equal batch_features on the same utterances (to bf16
    rounding), and a cached train step must track the recompute step."""
    utts, vocab, pc = _packed(tmp_path, n=48)
    cfg = _tiny_cfg(len(vocab))
    sampler = BucketSampler(utts, cfg.buckets, seed=0)
    loader = PackedBatchLoader(pc, cfg.buckets)
    mesh = make_mesh(cfg.parallel)              # 8 fake devices
    cache = DeviceCorpusCache(mesh, loader, sampler, seed=0,
                              features_cfg=cfg.features,
                              cache_dtype="bfloat16")
    bid, slots = cache.epoch_batches(0)[0]
    assert "features" in cache.buckets[bid]
    assert cache.buckets[bid]["features"].dtype == jnp.bfloat16

    # feature parity vs direct recompute on the same rows
    rows = cache.utterance_indices(bid, slots)
    host = loader.load(bid, rows)
    ref_f, ref_l = batch_features(
        jnp.asarray(host["signals_i16"].astype(np.float32) / 32768.0),
        jnp.asarray(host["num_samples"]))
    n = mesh.devices.size
    k = len(slots) // n
    R = cache.utt_map[bid].shape[1]
    flat = np.concatenate([slots[d * k:(d + 1) * k] + d * R
                           for d in range(n)])
    got_f = np.asarray(cache.buckets[bid]["features"])[flat]
    got_l = np.asarray(cache.buckets[bid]["frame_lengths"])[flat]
    np.testing.assert_array_equal(got_l, np.asarray(ref_l))
    np.testing.assert_allclose(got_f.astype(np.float32), np.asarray(ref_f),
                               atol=0.04, rtol=0.02)   # bf16 rounding

    # cached train step ~= stream (recompute) step
    model = build_model(cfg.model)
    state = init_state(model, cfg.optim, jax.random.key(0),
                       ref_f[:1], ref_l[:1])
    state2 = jax.tree.map(jnp.copy, state)
    cached_step = make_cached_train_step(model, cfg, mesh, cache)
    stream_step = make_train_step(model, cfg, mesh)
    s_c, m_c = cached_step(
        state, bid, jax.device_put(slots, batch_sharding(mesh)))
    s_s, m_s = stream_step(
        state2, shard_batch(mesh, {kk: v for kk, v in host.items()
                                   if kk != "bucket_id"}))
    assert abs(float(m_c["loss"]) - float(m_s["loss"])) < 0.05


@pytest.mark.slow
def test_train_device_cache_mode_and_exact_resume(tmp_path):
    utts, vocab, pc = _packed(tmp_path, n=48)
    cfg = _tiny_cfg(len(vocab)).override({
        "train.data_mode": "device_cache", "train.steps_per_dispatch": 1,
        "train.total_steps": 6, "train.checkpoint_every": 3,
        "train.log_every": 2, "train.eval_every": 1000,
        "train.checkpoint_dir": str(tmp_path / "ckpt_a")})
    loader = PackedBatchLoader(pc, cfg.buckets)
    state_full = train(cfg, utts, vocab, resume=False, loader=loader)
    assert int(state_full.step) == 6

    # interrupted twin: stop at 3 (checkpoint), then resume to 6
    cfg_b = cfg.override({"train.total_steps": 3,
                          "train.checkpoint_dir": str(tmp_path / "ckpt_b")})
    train(cfg_b, utts, vocab, resume=False, loader=loader)
    cfg_b6 = cfg_b.override({"train.total_steps": 6})
    state_res = train(cfg_b6, utts, vocab, resume=True, loader=loader)
    assert int(state_res.step) == 6
    for a, b in zip(jax.tree.leaves(state_full.params),
                    jax.tree.leaves(state_res.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
def test_train_multistep_dispatch_and_exact_resume(tmp_path):
    """steps_per_dispatch=3: K optimizer steps per host dispatch (lax.scan
    in-jit). Resume from a dispatch-boundary checkpoint must be bitwise."""
    utts, vocab, pc = _packed(tmp_path, n=48)
    cfg = _tiny_cfg(len(vocab)).override({
        "train.data_mode": "device_cache", "train.steps_per_dispatch": 3,
        "train.total_steps": 12, "train.checkpoint_every": 6,
        "train.log_every": 3, "train.eval_every": 1000,
        "train.checkpoint_dir": str(tmp_path / "ckpt_a")})
    loader = PackedBatchLoader(pc, cfg.buckets)
    state_full = train(cfg, utts, vocab, resume=False, loader=loader)
    assert int(state_full.step) == 12

    cfg_b = cfg.override({"train.total_steps": 6,
                          "train.checkpoint_dir": str(tmp_path / "ckpt_b")})
    train(cfg_b, utts, vocab, resume=False, loader=loader)
    state_res = train(cfg_b.override({"train.total_steps": 12}), utts, vocab,
                      resume=True, loader=loader)
    assert int(state_res.step) == 12
    for a, b in zip(jax.tree.leaves(state_full.params),
                    jax.tree.leaves(state_res.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
def test_finished_run_resumes_to_noop(tmp_path):
    """Resuming a run whose checkpoint already hit total_steps must not
    execute any extra step (VERDICT.md round-1 Weak #7)."""
    utts, vocab, pc = _packed(tmp_path, n=48)
    cfg = _tiny_cfg(len(vocab)).override({
        "train.data_mode": "device_cache", "train.steps_per_dispatch": 1,
        "train.total_steps": 2, "train.checkpoint_every": 2,
        "train.checkpoint_dir": str(tmp_path / "ckpt")})
    loader = PackedBatchLoader(pc, cfg.buckets)
    s1 = train(cfg, utts, vocab, resume=False, loader=loader)
    s2 = train(cfg, utts, vocab, resume=True, loader=loader)
    assert int(s1.step) == 2 and int(s2.step) == 2
    for a, b in zip(jax.tree.leaves(s1.params), jax.tree.leaves(s2.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_synthesize_packed_roundtrip(tmp_path):
    """Direct-to-pack scale-corpus writer (data/synth_corpus.py): the
    CSRPACK1 output must be a valid PackedCorpus whose stored label ids
    equal vocab.encode(text), and the build must be idempotent."""
    from chainer_speech_recognition.data.synth_corpus import (
        synthesize_packed)
    from chainer_speech_recognition.vocab import Vocab

    prefix = str(tmp_path / "scale")
    info = synthesize_packed(prefix, 6, vocab_size=12, max_samples=8000,
                             min_labels=3, max_labels=5)
    assert info["built"]
    pc = PackedCorpus(prefix)
    vocab = Vocab.load(prefix + ".vocab.txt")
    assert len(pc) == 6
    for i in range(6):
        sig = pc.signal(i)
        assert len(sig) <= 8000 and np.abs(sig).max() <= 1.0
        np.testing.assert_array_equal(pc.label_ids(i),
                                      vocab.encode(pc.texts[i]))
    again = synthesize_packed(prefix, 6, vocab_size=12, max_samples=8000)
    assert not again["built"] and again["bytes"] == info["bytes"]
    # a MISMATCHED request must rebuild, not silently reuse the stale pack
    # (a 100-utt smoke pack must never stand in for a 50k-utt scale run)
    bigger = synthesize_packed(prefix, 9, vocab_size=12, max_samples=8000,
                               min_labels=3, max_labels=5)
    assert bigger["built"] and len(PackedCorpus(prefix)) == 9
    longer = synthesize_packed(prefix, 9, vocab_size=12, max_samples=16000,
                               min_labels=3, max_labels=5)
    assert longer["built"] and longer["bytes"] > bigger["bytes"]
