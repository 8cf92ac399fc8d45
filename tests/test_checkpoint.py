"""Checkpoint/resume tests (SURVEY.md §4.4): save at step k, restore, and the
restored state must be bitwise-identical; the end-to-end CLI loop must resume
and reproduce the same step k+1 as an uninterrupted run."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chainer_speech_recognition.config import preset_config
from chainer_speech_recognition.data.synthetic import make_batch
from chainer_speech_recognition.frontend.jnp_frontend import batch_features
from chainer_speech_recognition.models.presets import build_model
from chainer_speech_recognition.parallel.mesh import make_mesh, shard_batch
from chainer_speech_recognition.train.checkpoint import (
    latest_checkpoint, list_checkpoints, load_config, restore_checkpoint,
    save_checkpoint)
from chainer_speech_recognition.train.state import init_state
from chainer_speech_recognition.train.step import make_train_step


def _setup(tmp_path):
    cfg = preset_config("tiny_conv").override({
        "model.vocab_size": 9, "model.compute_dtype": "float32",
        "train.checkpoint_dir": str(tmp_path / "ckpts")})
    model = build_model(cfg.model)
    rng = np.random.default_rng(0)
    batch = make_batch(rng, batch_size=8, vocab_size=9, max_label_len=8)
    feats, flens = batch_features(jnp.asarray(batch["signals"]),
                                  jnp.asarray(batch["num_samples"]))
    state = init_state(model, cfg.optim, jax.random.key(0), feats, flens)
    return cfg, model, state, batch


def test_save_restore_bitwise(tmp_path):
    cfg, model, state, _ = _setup(tmp_path)
    # a FRESH state has all-zero Adam moments and step=0 — identical to
    # the zeros template below, which would make those comparisons
    # vacuous (a restore that silently zero-filled opt_state would pass).
    # Fill every leaf with distinct nonzero values first.
    leaves, treedef = jax.tree.flatten(state)
    leaves = [jnp.full_like(l, (i % 7) + 1) for i, l in enumerate(leaves)]
    state = jax.tree.unflatten(treedef, leaves)
    assert all(float(jnp.abs(l).min()) > 0 for l in jax.tree.leaves(state))
    path = save_checkpoint(cfg.train.checkpoint_dir, state, cfg)
    assert os.path.exists(path)
    # template with different values restores exactly
    template = jax.tree.map(jnp.zeros_like, state)
    restored = restore_checkpoint(path, template)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), "bitwise mismatch"
    # frozen config round-trips
    assert load_config(cfg.train.checkpoint_dir) == cfg


@pytest.mark.slow
def test_resume_reproduces_next_step(tmp_path):
    cfg, model, state, batch = _setup(tmp_path)
    mesh = make_mesh(cfg.parallel)
    step_fn = make_train_step(model, cfg, mesh)

    # run 2 steps, checkpoint after step 1
    s1, _ = step_fn(jax.tree.map(jnp.copy, state), shard_batch(mesh, batch))
    save_checkpoint(cfg.train.checkpoint_dir, s1, cfg)
    s2, m2 = step_fn(jax.tree.map(jnp.copy, s1), shard_batch(mesh, batch))

    # restore and redo step 2
    template = jax.tree.map(jnp.zeros_like, s1)
    r1 = restore_checkpoint(latest_checkpoint(cfg.train.checkpoint_dir), template)
    r2, mr2 = step_fn(r1, shard_batch(mesh, batch))

    assert float(m2["loss"]) == float(mr2["loss"])
    for a, b in zip(jax.tree.leaves(s2.params), jax.tree.leaves(r2.params)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), \
            "resume is not bitwise-exact"


def test_keep_last_n(tmp_path):
    cfg, model, state, _ = _setup(tmp_path)
    for k in range(5):
        state = state.replace(step=jnp.asarray(k, jnp.int32))
        save_checkpoint(cfg.train.checkpoint_dir, state, cfg, keep=2)
    kept = list_checkpoints(cfg.train.checkpoint_dir)
    assert kept == ["step_00000003.npz", "step_00000004.npz"]


@pytest.mark.slow
def test_resume_on_different_mesh_size(tmp_path):
    """Elastic resume (SURVEY.md §5.3): a checkpoint from a 2-device run
    restored into a 4-device mesh must continue training with (near-)
    identical results — params carry no sharding, so the only difference
    is psum reduction order (numeric noise). This is the config-5 rescale
    story: grow/shrink the chip count between runs without conversion."""
    cfg, model, state, batch = _setup(tmp_path)
    cfg2 = cfg.override({"parallel.num_devices": 2})
    cfg4 = cfg.override({"parallel.num_devices": 4})
    mesh2, mesh4 = make_mesh(cfg2.parallel), make_mesh(cfg4.parallel)

    # one step on the 2-device mesh, checkpoint
    step2 = make_train_step(model, cfg2, mesh2)
    s1, _ = step2(jax.tree.map(jnp.copy, state), shard_batch(mesh2, batch))
    path = save_checkpoint(cfg2.train.checkpoint_dir, s1, cfg2)

    # continue on 4 devices from the restored checkpoint...
    template = jax.tree.map(jnp.zeros_like, s1)
    restored = restore_checkpoint(path, template)
    step4 = make_train_step(model, cfg4, mesh4)
    s2_4, m4 = step4(jax.tree.map(jnp.copy, restored),
                     shard_batch(mesh4, batch))
    # ...and (reference) on the original 2 devices
    s2_2, m2 = step2(jax.tree.map(jnp.copy, s1), shard_batch(mesh2, batch))

    assert int(s2_4.step) == int(s2_2.step) == 2
    assert abs(float(m4["loss"]) - float(m2["loss"])) < 1e-4
    for a, b in zip(jax.tree.leaves(s2_2.params), jax.tree.leaves(s2_4.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-5, rtol=1e-4)


def test_wide_step_checkpoints_listed_and_pruned(tmp_path):
    """Steps >= 1e8 widen the zero-padded filename field: listing, latest,
    and keep-last-N must order them NUMERICALLY, not lexicographically
    (review r3: an 8-digit-anchored regex silently rolled training back
    to an older checkpoint)."""
    cfg, model, state, _ = _setup(tmp_path)
    d = cfg.train.checkpoint_dir
    for s in (99_999_999, 100_000_000, 7):
        save_checkpoint(d, state.replace(step=jnp.asarray(s, jnp.uint32)),
                        cfg, keep=10)
    names = list_checkpoints(d)
    steps = [int(n.split("_")[1].split(".")[0]) for n in names]
    assert steps == sorted(steps) and len(steps) == 3
    assert latest_checkpoint(d).endswith("step_100000000.npz")
    # prune keeps the NUMERICALLY newest
    save_checkpoint(d, state.replace(step=jnp.asarray(7, jnp.uint32)),
                    cfg, keep=2)
    kept = [int(n.split("_")[1].split(".")[0])
            for n in list_checkpoints(d)]
    assert kept == [99_999_999, 100_000_000]   # numerically newest two


def test_keep_zero_rejected(tmp_path):
    """keep=0 would make the prune slice [:-0] == [] and silently never
    delete anything — it must fail loudly instead."""
    cfg, model, state, _ = _setup(tmp_path)
    with pytest.raises(ValueError, match="keep"):
        save_checkpoint(cfg.train.checkpoint_dir, state, cfg, keep=0)


def test_qkv_migration_restores_old_mhsa_layout():
    """Checkpoints written before the QKV fusion (separate q/k/v Dense
    params) must keep loading: the loader concatenates them into the fused
    qkv layout — exactly matching the fused layer's slicing — anywhere in
    the tree (params AND optimizer moments)."""
    from chainer_speech_recognition.models.attention import _MHSA
    from chainer_speech_recognition.train.checkpoint import (
        _flat_leaves, _migrate_state_dict, _nest, _unnest)

    B, T, d, h = 2, 8, 8, 2
    x = jnp.asarray(np.random.default_rng(0).standard_normal((B, T, d)),
                    jnp.float32)
    lens = jnp.asarray([8, 5])
    mask = (jnp.arange(T)[None, :] < lens[:, None])
    m = _MHSA(heads=h, dtype=jnp.float32)
    params = m.init(jax.random.key(0), x, mask)
    want = m.apply(params, x, mask)

    # fabricate the OLD layout: split the fused kernel/bias back into q/k/v
    sd = _nest(_flat_leaves(params))
    fused = sd["params"].pop("qkv")
    for i, name in enumerate(("q", "k", "v")):
        sd["params"][name] = {
            "kernel": np.asarray(fused["kernel"][:, i * d:(i + 1) * d]),
            "bias": np.asarray(fused["bias"][i * d:(i + 1) * d])}
    migrated = _migrate_state_dict(sd, _nest(_flat_leaves(params)))
    restored = _nest({k: jnp.asarray(v)
                      for k, v in _unnest(migrated).items()})
    got = m.apply(restored, x, mask)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_npz_round_trip_keeps_uint32_rng_and_step(tmp_path):
    """The .npz format stores each leaf under its tree path with its own
    dtype: the uint32 PRNG key data, a uint32 step and the float params
    come back with identical dtypes, shapes and bits."""
    cfg, model, state, _ = _setup(tmp_path)
    state = state.replace(step=jnp.asarray(12345, jnp.uint32))
    assert np.asarray(state.rng).dtype == np.uint32
    path = save_checkpoint(cfg.train.checkpoint_dir, state, cfg)
    with np.load(path) as z:
        assert "step" in z.files and "rng" in z.files
        assert any(k.startswith("params/params/") for k in z.files)
        assert z["step"].dtype == np.uint32
    restored = restore_checkpoint(path, jax.tree.map(jnp.zeros_like, state))
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def test_restore_rejects_tree_mismatch(tmp_path):
    """A checkpoint of another model (a leaf missing, extra, or of another
    shape) fails loudly instead of restoring a half-filled state."""
    cfg, model, state, _ = _setup(tmp_path)
    path = save_checkpoint(cfg.train.checkpoint_dir, state, cfg)
    other = state.replace(params={"params": {
        **state.params["params"],
        "output": {"kernel": jnp.zeros((3, 3)), "bias": jnp.zeros((3,))}}})
    with pytest.raises(ValueError, match="output"):
        restore_checkpoint(path, other)
    extra = state.replace(params={"params": {
        **state.params["params"], "extra": {"kernel": jnp.zeros((2,))}}})
    with pytest.raises(ValueError, match="missing"):
        restore_checkpoint(path, extra)
