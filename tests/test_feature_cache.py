"""Cached-feature path (SURVEY.md §2.1 "Feature cache"): preprocess
--cache-features writes golden .npy features; the loader/train-step consume
them, and the loss matches the on-device front-end path (they compute the
same features, golden-vs-jnp parity)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chainer_speech_recognition.cli import preprocess as preprocess_cli
from chainer_speech_recognition.config import preset_config
from chainer_speech_recognition.data.corpus import load_index
from chainer_speech_recognition.data.sampler import BatchLoader, BucketSampler
from chainer_speech_recognition.data.synthetic import make_utterance
from chainer_speech_recognition.frontend.jnp_frontend import batch_features
from chainer_speech_recognition.models.presets import build_model
from chainer_speech_recognition.parallel.mesh import make_mesh, shard_batch
from chainer_speech_recognition.train.state import init_state
from chainer_speech_recognition.train.step import make_train_step
from chainer_speech_recognition.utils.wav import write_wav
from chainer_speech_recognition.vocab import Vocab


def _make_corpus(root, n=16):
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    kana = ["あ", "い", "う", "え"]
    for i in range(n):
        ids = [1 + (i + j) % 4 for j in range(1 + i % 3)]
        ids = [k for j, k in enumerate(ids) if j == 0 or k != ids[j - 1]]
        sig, _ = make_utterance(rng, ids, tone_len=1600)
        write_wav(os.path.join(root, f"u{i:02d}.wav"), sig)
        with open(os.path.join(root, f"u{i:02d}.txt"), "w") as f:
            f.write("".join(kana[k - 1] for k in ids))


@pytest.mark.slow
def test_cached_features_end_to_end(tmp_path):
    corpus, out = str(tmp_path / "c"), str(tmp_path / "prep")
    _make_corpus(corpus)
    preprocess_cli.main(["--corpus", corpus, "--out", out, "--cache-features"])
    utts = load_index(os.path.join(out, "train_index.jsonl"))
    assert all(u.feat and os.path.exists(u.feat) for u in utts)

    cfg = preset_config("tiny_conv").override({
        "model.vocab_size": 9, "model.compute_dtype": "float32",
        "features.use_cache": True,
        "buckets.boundaries": [64], "buckets.batch_sizes": [8],
        "buckets.max_label_len": 8})
    vocab = Vocab.load(os.path.join(out, "vocab.txt"))
    sampler = BucketSampler(utts, cfg.buckets, seed=0)
    loader_c = BatchLoader(utts, vocab, cfg.buckets, use_cached_features=True)
    loader_s = BatchLoader(utts, vocab, cfg.buckets, use_cached_features=False)
    bid, idxs = sampler.epoch_batches(0)[0][:2]

    bc = loader_c.load(bid, idxs)
    bs = loader_s.load(bid, idxs)
    assert bc["features"].shape == (8, 64, 40, 3)
    # cached (golden) features == on-device features on valid frames
    feats_dev, flens = batch_features(jnp.asarray(bs["signals"]),
                                      jnp.asarray(bs["num_samples"]))
    feats_dev, flens = np.asarray(feats_dev), np.asarray(flens)
    for i in range(8):
        t = bc["frame_lengths"][i]
        assert t == flens[i]
        np.testing.assert_allclose(bc["features"][i, :t],
                                   feats_dev[i, :t], atol=5e-4, rtol=1e-3)

    # train one step on each path: same loss (same model/params)
    model = build_model(cfg.model)
    mesh = make_mesh(cfg.parallel)
    ex = jnp.zeros((1, 64, 40, 3), jnp.float32)
    state = init_state(model, cfg.optim, jax.random.key(0), ex,
                       jnp.asarray([64]))
    step_fn = make_train_step(model, cfg, mesh)
    state2 = jax.tree.map(jnp.copy, state)
    bc.pop("bucket_id"); bs.pop("bucket_id")
    _, m_c = step_fn(state, shard_batch(mesh, bc))
    _, m_s = step_fn(state2, shard_batch(mesh, bs))
    assert abs(float(m_c["loss"]) - float(m_s["loss"])) < 5e-3


def test_loader_refuses_missing_cache(tmp_path):
    corpus, out = str(tmp_path / "c"), str(tmp_path / "prep")
    _make_corpus(corpus, n=4)
    preprocess_cli.main(["--corpus", corpus, "--out", out])  # no cache
    utts = load_index(os.path.join(out, "train_index.jsonl"))
    vocab = Vocab.load(os.path.join(out, "vocab.txt"))
    cfg = preset_config("tiny_conv")
    import pytest
    with pytest.raises(ValueError):
        BatchLoader(utts, vocab, cfg.buckets, use_cached_features=True)
