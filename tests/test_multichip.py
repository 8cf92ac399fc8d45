"""Guard for the driver's multichip dry-run path: one full shard_map DP
train step on the 8 fake CPU devices (SURVEY.md §4.3; __graft_entry__),
plus the Pallas-CTC-under-mesh equality check (config 5 on the GPU runs
the CTC kernel INSIDE shard_map — interpret mode exercises that exact
composition on the fake mesh)."""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp


@pytest.mark.slow
def test_dryrun_multichip_8():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)   # raises on any sharding error


@pytest.mark.slow
def test_pallas_stack_under_mesh_matches_reference_stack():
    """ctc = pallas (interpret mode on the CPU backend) inside the 8-device
    shard_map train step must reproduce the jnp scan's loss and parameter
    update."""
    from chainer_speech_recognition.config import preset_config
    from chainer_speech_recognition.data.synthetic import make_batch
    from chainer_speech_recognition.frontend.jnp_frontend import (
        batch_features)
    from chainer_speech_recognition.models.presets import build_model
    from chainer_speech_recognition.parallel.mesh import (
        make_mesh, shard_batch)
    from chainer_speech_recognition.train.state import init_state
    from chainer_speech_recognition.train.step import make_train_step

    base = preset_config("bilstm_deep").override({
        "model.vocab_size": 12, "model.compute_dtype": "float32",
        "model.rnn_layers": 2, "model.rnn_hidden": 24,
        "specaugment.enabled": False,      # rng-placement-invariant compare
    })
    cfg_p = base.override({"train.ctc_impl": "pallas"})
    cfg_j = base.override({"train.ctc_impl": "jnp"})

    batch = make_batch(np.random.default_rng(2), batch_size=16,
                       vocab_size=12, min_len=2, max_len=4, tone_len=800)
    mesh = make_mesh(base.parallel)        # 8 fake devices

    model = build_model(base.model)
    feats, flens = batch_features(jnp.asarray(batch["signals"][:1]),
                                  jnp.asarray(batch["num_samples"][:1]))
    state_p = init_state(model, base.optim, jax.random.key(0), feats, flens)
    state_j = jax.tree.map(jnp.copy, state_p)

    step_p = make_train_step(build_model(cfg_p.model), cfg_p, mesh)
    step_j = make_train_step(build_model(cfg_j.model), cfg_j, mesh)
    s_p, m_p = step_p(state_p, shard_batch(mesh, batch))
    s_j, m_j = step_j(state_j, shard_batch(mesh, batch))

    # fp32 end-to-end: the stacks agree to numerical noise
    assert abs(float(m_p["loss"]) - float(m_j["loss"])) < 2e-3
    for a, b in zip(jax.tree.leaves(s_p.params), jax.tree.leaves(s_j.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=5e-4, rtol=1e-3)


@pytest.mark.slow
def test_sharded_eval_matches_single_device():
    """make_sharded_eval_step over the 8-device mesh must reproduce the
    single-device eval step exactly — per-utt losses, logits and lengths
    (VERDICT r1 missing #3: eval rides the DP mesh)."""
    from chainer_speech_recognition.config import preset_config
    from chainer_speech_recognition.data.synthetic import make_batch
    from chainer_speech_recognition.frontend.jnp_frontend import (
        batch_features)
    from chainer_speech_recognition.models.presets import build_model
    from chainer_speech_recognition.parallel.mesh import (
        make_mesh, shard_batch)
    from chainer_speech_recognition.train.state import init_state
    from chainer_speech_recognition.train.step import (
        make_eval_step, make_sharded_eval_step)

    cfg = preset_config("bigru").override({
        "model.vocab_size": 12, "model.compute_dtype": "float32",
        "model.rnn_layers": 1, "model.rnn_hidden": 16,
    })
    model = build_model(cfg.model)
    batch = make_batch(np.random.default_rng(5), batch_size=16,
                       vocab_size=12, min_len=2, max_len=4, tone_len=800)
    feats, flens = batch_features(jnp.asarray(batch["signals"][:1]),
                                  jnp.asarray(batch["num_samples"][:1]))
    state = init_state(model, cfg.optim, jax.random.key(0), feats, flens)
    mesh = make_mesh(cfg.parallel)         # 8 fake devices

    single = make_eval_step(model, cfg)
    sharded = make_sharded_eval_step(model, cfg, mesh)
    b1 = {k: jnp.asarray(v) for k, v in batch.items()}
    l1, g1, o1 = single(state.params, b1)
    l8, g8, o8 = sharded(state.params, shard_batch(mesh, batch))
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l8),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g8),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o8))


@pytest.mark.slow
def test_sharded_beam_matches_single_device():
    """beam_decode(mesh=...) splits rows over the 8-device mesh — results
    must be identical to the single-device beam, with and without LM."""
    from chainer_speech_recognition.config import preset_config
    from chainer_speech_recognition.decode.beam import beam_decode
    from chainer_speech_recognition.decode.lm import NGramLM
    from chainer_speech_recognition.parallel.mesh import make_mesh
    from chainer_speech_recognition.vocab import Vocab

    mesh = make_mesh(preset_config("bigru").parallel)   # 8 fake devices
    vocab = Vocab.build(["あいう", "ういあ", "あいあ"], add_unk=False)
    lm = NGramLM.train(["あいう"] * 30 + ["あいあ"] * 7, vocab, order=2)
    B, T, V = 16, 20, len(vocab)
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 2
    lens = rng.integers(8, T + 1, B)
    for lm_arg, a, b in [(None, 0.0, 0.0), (lm, 0.6, 0.8)]:
        single = beam_decode(logits, lens, beam=8, lm=lm_arg,
                             alpha=a, beta=b)
        sharded = beam_decode(logits, lens, beam=8, lm=lm_arg,
                              alpha=a, beta=b, mesh=mesh)
        assert [[int(x) for x in h] for h in sharded] == \
               [[int(x) for x in h] for h in single]


@pytest.mark.slow
def test_sharded_streaming_matches_single_device():
    """Streaming with a DP mesh: lockstep streams committed batch-sharded
    over the 8 fake devices (GSPMD partitions the chunk step) must emit
    exactly the single-device transcription — greedy and beam."""
    from chainer_speech_recognition.config import preset_config
    from chainer_speech_recognition.decode.streaming import (
        StreamingRecognizer)
    from chainer_speech_recognition.models.presets import build_model
    from chainer_speech_recognition.parallel.mesh import make_mesh

    cfg = preset_config("bigru").override({
        "features.cmvn_mode": "causal", "model.vocab_size": 8,
        "model.compute_dtype": "float32", "model.rnn_layers": 2,
        "model.rnn_hidden": 16})
    model = build_model(cfg.model)
    x = jnp.zeros((1, 32, 40, 3), jnp.float32)
    params = jax.jit(model.init)(jax.random.key(0), x, jnp.asarray([32]))
    mesh = make_mesh(cfg.parallel)
    assert mesh.devices.size == 8

    B = 8
    rng = np.random.default_rng(0)
    ns = [int(rng.integers(6000, 12000)) for _ in range(B)]
    pcm = np.asarray(rng.uniform(-0.5, 0.5, (B, max(ns))), np.float32)
    for b, nb in enumerate(ns):
        pcm[b, nb:] = 0.0

    def run(mesh_arg, **kw):
        rec = StreamingRecognizer(model, params, cfg, batch=B,
                                  chunk_frames=16, right_frames=8,
                                  mesh=mesh_arg, **kw)
        rec.accept(pcm, drain=False)
        rec.flush(num_samples=ns)
        return rec.emitted

    assert run(mesh) == run(None)
    assert run(mesh, decoder="beam", beam=4) == run(None, decoder="beam",
                                                    beam=4)
