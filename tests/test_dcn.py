"""Multi-slice scale-out: the 2-D ``(dcn, data)`` mesh (ARCHITECTURE.md
§2.7, ``parallel.dcn_slices``) must be semantically identical to the 1-D
DP mesh — batch rows shard over BOTH axes, every collective reduces over
both, and XLA is free to route the inner reduction over ICI and only the
slice partials over DCN. On the 8 fake CPU devices (SURVEY.md §4.3) a
(2, 4) mesh stands in for a 2-slice × 4-chip pod."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chainer_speech_recognition.config import Config, preset_config
from chainer_speech_recognition.parallel.mesh import (
    batch_sharding, dispatch_sharding, make_mesh, shard_batch)


def _dcn_cfg(preset="bigru", **over):
    base = {
        "parallel.dcn_slices": 2,
        "model.vocab_size": 12, "model.compute_dtype": "float32",
        "model.rnn_layers": 1, "model.rnn_hidden": 16,
        "specaugment.enabled": False,
    }
    base.update(over)
    return preset_config(preset).override(base)


def test_mesh_shape_axes_and_validation():
    cfg = _dcn_cfg()
    mesh = make_mesh(cfg.parallel)
    assert mesh.axis_names == ("dcn", "data")
    assert mesh.devices.shape == (2, 4)
    assert cfg.parallel.batch_axes == ("dcn", "data")
    # 1-D config unchanged
    cfg1 = preset_config("bigru")
    assert cfg1.parallel.batch_axes == "data"
    assert make_mesh(cfg1.parallel).axis_names == ("data",)
    # indivisible split fails loudly
    with pytest.raises(ValueError):
        make_mesh(_dcn_cfg(**{"parallel.dcn_slices": 3}).parallel)


def test_config_roundtrip_carries_dcn():
    cfg = _dcn_cfg()
    back = Config.from_json(cfg.to_json())
    assert back.parallel.dcn_slices == 2
    assert back.parallel.batch_axes == ("dcn", "data")


def test_helpers_shard_over_both_axes():
    mesh = make_mesh(_dcn_cfg().parallel)
    x = np.zeros((16, 4), np.float32)
    put = jax.device_put(x, batch_sharding(mesh))
    # fully split on the batch dim: each device holds 16/8 rows
    shard_shapes = {s.data.shape for s in put.addressable_shards}
    assert shard_shapes == {(2, 4)}
    idx = jax.device_put(np.zeros((3, 16), np.int32),
                         dispatch_sharding(mesh, 2))
    assert {s.data.shape for s in idx.addressable_shards} == {(3, 2)}


@pytest.mark.slow
def test_dcn_train_step_matches_1d_mesh():
    """One shard_map train step on the (2,4) mesh == the same step on the
    1-D 8-device mesh: loss and updated params agree to numerical noise
    (the reduction ORDER differs — psum over two axes tree-reduces)."""
    from chainer_speech_recognition.data.synthetic import make_batch
    from chainer_speech_recognition.frontend.jnp_frontend import (
        batch_features)
    from chainer_speech_recognition.models.presets import build_model
    from chainer_speech_recognition.train.state import init_state
    from chainer_speech_recognition.train.step import make_train_step

    cfg2 = _dcn_cfg()
    cfg1 = cfg2.override({"parallel.dcn_slices": 1})
    model = build_model(cfg2.model)
    batch = make_batch(np.random.default_rng(3), batch_size=16,
                       vocab_size=12, min_len=2, max_len=4, tone_len=800)
    feats, flens = batch_features(jnp.asarray(batch["signals"][:1]),
                                  jnp.asarray(batch["num_samples"][:1]))
    state2 = init_state(model, cfg2.optim, jax.random.key(0), feats, flens)
    state1 = jax.tree.map(jnp.copy, state2)

    mesh2, mesh1 = make_mesh(cfg2.parallel), make_mesh(cfg1.parallel)
    s2, m2 = make_train_step(model, cfg2, mesh2)(
        state2, shard_batch(mesh2, batch))
    s1, m1 = make_train_step(model, cfg1, mesh1)(
        state1, shard_batch(mesh1, batch))

    assert abs(float(m2["loss"]) - float(m1["loss"])) < 1e-5
    assert float(m2["valid_frac"]) == float(m1["valid_frac"])
    for a, b in zip(jax.tree.leaves(s2.params), jax.tree.leaves(s1.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6, rtol=1e-5)


@pytest.mark.slow
def test_dcn_cached_step_and_eval_match_1d_mesh():
    """Device-cache feeding (HBM rows sharded over BOTH mesh axes,
    slot-id dispatches) and the sharded eval forward on the (2,4) mesh
    reproduce the 1-D mesh results."""
    from chainer_speech_recognition.data.buckets import BucketConfig
    from chainer_speech_recognition.data.device_cache import (
        DeviceCorpusCache)
    from chainer_speech_recognition.data.sampler import BucketSampler
    from chainer_speech_recognition.data.synthetic import make_batch
    from chainer_speech_recognition.frontend.jnp_frontend import (
        batch_features)
    from chainer_speech_recognition.models.presets import build_model
    from chainer_speech_recognition import constants as C
    from chainer_speech_recognition.train.state import init_state
    from chainer_speech_recognition.train.step import (
        make_cached_train_step, make_sharded_eval_step)

    cfg2 = _dcn_cfg()
    cfg1 = cfg2.override({"parallel.dcn_slices": 1})
    model = build_model(cfg2.model)
    B = 16
    batch = make_batch(np.random.default_rng(7), batch_size=B,
                       vocab_size=12, min_len=2, max_len=4, tone_len=800)

    class _Loader:
        def load(self, bid, idxs, n_valid=None):
            sel = {k: v[np.asarray(idxs) % B] for k, v in batch.items()}
            sel["signals_i16"] = np.clip(
                sel.pop("signals") * 32768.0, -32768, 32767).astype(np.int16)
            return sel

    n_frames = C.num_frames(batch["signals"].shape[1])
    bcfg = BucketConfig(boundaries=(n_frames + 4,), batch_sizes=(B,),
                        max_label_len=batch["labels"].shape[1])

    class _Utt:
        def __init__(self, i):
            self.num_frames = n_frames
            self.text = "x" * int(batch["label_lengths"][i % B])

    feats, flens = batch_features(jnp.asarray(batch["signals"][:1]),
                                  jnp.asarray(batch["num_samples"][:1]))
    state0 = init_state(model, cfg2.optim, jax.random.key(0), feats, flens)

    results = {}
    for tag, cfg in (("dcn", cfg2), ("flat", cfg1)):
        mesh = make_mesh(cfg.parallel)
        sampler = BucketSampler([_Utt(i) for i in range(2 * B)], bcfg,
                                seed=0)
        cache = DeviceCorpusCache(mesh, _Loader(), sampler, seed=0,
                                  axis=cfg.parallel.batch_axes,
                                  features_cfg=cfg.features)
        step = make_cached_train_step(model, cfg, mesh, cache)
        bid, slots = cache.epoch_batches(0)[0]
        st, m = step(jax.tree.map(jnp.copy, state0), bid,
                     jax.device_put(slots, batch_sharding(mesh)))
        ev = make_sharded_eval_step(model, cfg, mesh)
        losses, logits, olens = ev(st.params, shard_batch(mesh, batch))
        results[tag] = (float(m["loss"]), np.asarray(losses),
                        np.asarray(olens))

    assert abs(results["dcn"][0] - results["flat"][0]) < 1e-5
    np.testing.assert_allclose(results["dcn"][1], results["flat"][1],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(results["dcn"][2], results["flat"][2])


@pytest.mark.slow
def test_dcn_beam_and_streaming_match_single_device():
    """Decoders on the (2,4) mesh: beam_decode(mesh=...) (axis defaults
    to ALL mesh axes) and the mesh-sharded StreamingRecognizer equal the
    unsharded results exactly."""
    from chainer_speech_recognition.decode.beam import beam_decode
    from chainer_speech_recognition.decode.streaming import (
        StreamingRecognizer)
    from chainer_speech_recognition.models.presets import build_model

    mesh = make_mesh(_dcn_cfg().parallel)
    B, T, V = 16, 20, 9
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 2
    lens = rng.integers(8, T + 1, B)
    single = beam_decode(logits, lens, beam=4)
    sharded = beam_decode(logits, lens, beam=4, mesh=mesh)
    assert [[int(x) for x in h] for h in sharded] == \
           [[int(x) for x in h] for h in single]

    # mesh-sharded chunks run under a GSPMD jit over the 2-D mesh and
    # must emit the single-device transcription
    cfg = _dcn_cfg().override({"features.cmvn_mode": "causal",
                               "model.vocab_size": 8,
                               "model.rnn_layers": 1})
    model = build_model(cfg.model)
    x = jnp.zeros((1, 32, 40, 3), jnp.float32)
    params = jax.jit(model.init)(jax.random.key(0), x, jnp.asarray([32]))
    S = 8
    pcm = np.asarray(rng.uniform(-0.5, 0.5, (S, 8000)), np.float32)

    def run(mesh_arg):
        rec = StreamingRecognizer(model, params, cfg, batch=S,
                                  chunk_frames=16, right_frames=8,
                                  mesh=mesh_arg)
        rec.accept(pcm, drain=False)
        rec.flush()
        return rec.emitted

    assert run(mesh) == run(None)
