"""End-to-end + distributed training tests (SURVEY.md §4.2/§4.3):

* config-1 slice on synthetic audio: loss decreases, greedy decode recovers
  the toy audio→symbol mapping;
* DP correctness: the shard_map/pmean train step on an 8-device mesh produces
  the same parameters as a 1-device run on the identical batch;
* SpecAugment invariants.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chainer_speech_recognition.config import preset_config
from chainer_speech_recognition.data.synthetic import make_batch
from chainer_speech_recognition.decode.greedy import greedy_decode
from chainer_speech_recognition.frontend.jnp_frontend import batch_features
from chainer_speech_recognition.models.presets import build_model
from chainer_speech_recognition.ops.specaugment import apply_specaugment
from chainer_speech_recognition.parallel.mesh import make_mesh, shard_batch
from chainer_speech_recognition.train.state import init_state
from chainer_speech_recognition.train.step import make_train_step, make_eval_step


def _cfg(**over):
    return preset_config("tiny_conv").override({
        "model.vocab_size": 9, "model.compute_dtype": "float32",
        "optim.learning_rate": 3e-3, "optim.warmup_steps": 20,
        "optim.decay_steps": 400, **over})


def _fixed_batch(rng, B=16, n_max=12000, l_max=8):
    b = make_batch(rng, batch_size=B, vocab_size=9)
    sig = np.zeros((B, n_max), np.float32)
    sig[:, : b["signals"].shape[1]] = b["signals"]
    lab = np.full((B, l_max), -1, np.int32)
    lab[:, : b["labels"].shape[1]] = b["labels"]
    return {"signals": sig, "num_samples": b["num_samples"],
            "labels": lab, "label_lengths": b["label_lengths"]}


def _init(cfg, batch):
    model = build_model(cfg.model)
    feats, flens = batch_features(jnp.asarray(batch["signals"]),
                                  jnp.asarray(batch["num_samples"]))
    state = init_state(model, cfg.optim, jax.random.key(0), feats, flens)
    return model, state


@pytest.mark.slow
def test_toy_training_learns():
    cfg = _cfg()
    rng = np.random.default_rng(0)
    batch0 = _fixed_batch(rng)
    model, state = _init(cfg, batch0)
    mesh = make_mesh(cfg.parallel)          # all 8 fake devices
    train_step = make_train_step(model, cfg, mesh)

    losses = []
    for _ in range(120):
        b = shard_batch(mesh, _fixed_batch(rng))
        state, m = train_step(state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.2, (losses[0], losses[-1])

    # greedy decode recovers the mapping on held-out data
    eval_step = make_eval_step(model, cfg)
    b = _fixed_batch(np.random.default_rng(123))
    _, logits, olens = eval_step(state.params,
                                 {k: jnp.asarray(v) for k, v in b.items()})
    ids, out_lens = greedy_decode(logits, olens, max_len=8)
    ids, out_lens = np.asarray(ids), np.asarray(out_lens)
    exact = sum(
        list(ids[i, : out_lens[i]]) ==
        list(b["labels"][i][: b["label_lengths"][i]])
        for i in range(16))
    assert exact >= 12, f"greedy recovered only {exact}/16"


@pytest.mark.slow
def test_dp_equals_single_device():
    """shard_map+pmean over 8 devices == 1-device step on the same batch."""
    cfg = _cfg()
    rng = np.random.default_rng(1)
    batch = _fixed_batch(rng)
    model, state = _init(cfg, batch)

    mesh8 = make_mesh(cfg.parallel)
    mesh1 = make_mesh(type(cfg.parallel)(num_devices=1))
    step8 = make_train_step(model, cfg, mesh8)
    step1 = make_train_step(model, cfg, mesh1)

    # same state, same batch; specaugment disabled (tiny_conv) so the only
    # difference is where the mean over the batch is computed
    state2 = jax.tree.map(jnp.copy, state)  # step() donates its input
    s8, m8 = step8(state, shard_batch(mesh8, batch))
    s1, m1 = step1(state2, shard_batch(mesh1, batch))

    assert abs(float(m8["loss"]) - float(m1["loss"])) < 1e-5
    for p8, p1 in zip(jax.tree.leaves(s8.params), jax.tree.leaves(s1.params)):
        np.testing.assert_allclose(np.asarray(p8), np.asarray(p1), atol=2e-6)


@pytest.mark.slow
def test_remainder_rows_are_masked():
    """sample_weight=0 rows (padded bucket remainders) must contribute
    exactly nothing: loss and updates invariant to their content."""
    cfg = _cfg()
    rng = np.random.default_rng(5)
    batch = _fixed_batch(rng)
    w = np.ones(16, np.float32)
    w[12:] = 0.0
    batch_a = dict(batch, sample_weight=w)
    # corrupt the masked rows arbitrarily
    batch_b = {k: np.array(v, copy=True) for k, v in batch_a.items()}
    batch_b["signals"][12:] = rng.standard_normal((4, 12000)).astype(np.float32)
    batch_b["labels"][12:, :3] = 5
    batch_b["label_lengths"][12:] = 3

    model, state = _init(cfg, batch)
    state2 = jax.tree.map(jnp.copy, state)
    mesh = make_mesh(cfg.parallel)
    step = make_train_step(model, cfg, mesh)
    sa, ma = step(state, shard_batch(mesh, batch_a))
    sb, mb = step(state2, shard_batch(mesh, batch_b))
    assert float(ma["loss"]) == float(mb["loss"])
    for a, b in zip(jax.tree.leaves(sa.params), jax.tree.leaves(sb.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # and the loss equals the unweighted mean over ONLY the valid rows
    from chainer_speech_recognition.train.step import make_eval_step
    eval_step = make_eval_step(model, cfg)
    # state params were updated; recompute with the ORIGINAL params
    model2, state0 = _init(cfg, batch)
    losses, _, _ = eval_step(state0.params,
                             {k: jnp.asarray(v) for k, v in batch.items()})
    # train loss was computed at the pre-update params of `state`, which
    # _init reproduces deterministically
    expect = float(np.asarray(losses)[:12].mean())
    assert abs(float(ma["loss"]) - expect) < 1e-3


def test_sampler_remainder_covers_every_utterance():
    from chainer_speech_recognition.config import BucketConfig
    from chainer_speech_recognition.data.corpus import Utterance
    from chainer_speech_recognition.data.sampler import BucketSampler
    utts = [Utterance(f"u{i}", "x.wav", "あい", 4000 + 100 * i)
            for i in range(23)]
    cfg = BucketConfig(boundaries=(64,), batch_sizes=(8,), max_label_len=8)
    s = BucketSampler(utts, cfg, seed=0)
    batches = s.epoch_batches(0)
    assert len(batches) == 3                       # 8 + 8 + remainder(7)
    seen = []
    for bid, idxs, n_valid in batches:
        assert len(idxs) == 8
        seen.extend(idxs[:n_valid])
    assert sorted(seen) == list(range(23))         # each utt exactly once


def test_specaugment_invariants():
    cfg = preset_config("bilstm_deep")
    feats = jnp.ones((4, 100, 40, 3), jnp.float32)
    lens = jnp.asarray([100, 60, 30, 10])
    out = apply_specaugment(jax.random.key(0), feats, lens, cfg.specaugment)
    out = np.asarray(out)
    assert out.shape == feats.shape
    assert np.all((out == 0) | (out == 1))         # pure masking of ones
    assert (out == 0).mean() > 0.01                # something was masked
    # masks differ across utterances
    assert not np.array_equal(out[0], out[1])
    # time masks are sampled within each utterance's VALID length: a
    # fully-zero time row can only come from a time mask (freq masks
    # never cover all F), and its start lies in [0, max(len-width, 1)),
    # so no masked row may reach past len + time_mask_max. Sampling over
    # the padded T instead of len (the regression this pins) would mask
    # rows far past the short utterances' lengths.
    lens_np = np.asarray(lens)
    for key in range(8):
        o = np.asarray(apply_specaugment(jax.random.key(key), feats, lens,
                                         cfg.specaugment))
        zero_rows = (o == 0).all(axis=(2, 3))            # [B, T]
        for b, L in enumerate(lens_np):
            hit = np.flatnonzero(zero_rows[b])
            assert hit.size == 0 or hit.max() < L + cfg.specaugment.time_mask_max, \
                (key, b, int(L), int(hit.max()))
    # disabled config is identity
    cfg1 = preset_config("tiny_conv")
    out2 = apply_specaugment(jax.random.key(0), feats, lens, cfg1.specaugment)
    assert np.array_equal(np.asarray(out2), np.asarray(feats))
