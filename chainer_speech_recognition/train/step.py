"""The jitted train/eval steps — everything between the two host↔device
boundaries of the reference's iteration (SURVEY.md §3.2) fused into ONE
compiled program: on-device front-end → SpecAugment → acoustic model →
CTC → grad → clip → update, with the gradient all-reduce over the DP mesh
inside ``shard_map`` (BASELINE.json:5,11).

Batches are dicts of padded host arrays:
  signals        [B, N_max] float32 PCM
  num_samples    [B] int32
  labels         [B, L_max] int32 (PAD_LABEL_ID beyond label_lengths)
  label_lengths  [B] int32
Per-bucket static shapes → one XLA compile per bucket (SURVEY.md §2.2).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..config import Config
from ..frontend.jnp_frontend import batch_features
from ..ops.ctc_jax import LOG_ZERO, ctc_loss
from ..ops.ctc_pallas import ctc_loss_pallas
from ..ops.specaugment import apply_specaugment
from .state import TrainState, make_optimizer


def _ctc(cfg: Config):
    """The loss ``train.ctc_impl`` names: "pallas" is the Triton-route
    kernel (interpreted only on the CPU backend, where it is tested),
    "jnp" the ``lax.scan``; "auto" takes the kernel on a GPU."""
    backend = jax.default_backend()
    impl = cfg.train.ctc_impl
    if impl == "auto":
        impl = "pallas" if backend == "gpu" else "jnp"
    if impl == "pallas":
        return functools.partial(ctc_loss_pallas,
                                 interpret=backend == "cpu")
    return {"jnp": ctc_loss}[impl]


def _signals(batch):
    """float32 signal view; int16 batches (packed-corpus wire format, half
    the host→device bytes) are converted on device, where it is free."""
    if "signals" in batch:
        return batch["signals"]
    return batch["signals_i16"].astype(jnp.float32) / 32768.0


def _forward_loss(model, cfg: Config, params, batch, rng, train: bool,
                  axis: str | None = None):
    """Weighted-mean CTC loss over the GLOBAL batch.

    ``batch["sample_weight"]`` (optional, [B] fp32) masks padded remainder
    rows to exactly zero gradient; samples with no valid CTC alignment are
    masked the same way. With ``axis`` set, the normalizer is the psum'd
    global weight sum, so the per-device loss values sum (psum) to the
    exact global weighted mean regardless of per-device valid counts —
    gradients then combine with psum, not pmean.
    """
    if "features" in batch:          # cached-feature batches (SURVEY §2.1)
        feats, flens = batch["features"], batch["frame_lengths"]
    else:                            # on-device front-end
        feats, flens = batch_features(
            _signals(batch), batch["num_samples"],
            apply_cmvn=cfg.features.cmvn_arg)
    if train and cfg.specaugment.enabled:
        feats = apply_specaugment(rng, feats, flens, cfg.specaugment)
    logits, olens = model.apply(params, feats, flens)
    losses = _ctc(cfg)(logits, olens, batch["labels"], batch["label_lengths"])
    valid = losses < -LOG_ZERO / 2
    w = batch.get("sample_weight")
    real = (jnp.ones_like(losses) if w is None
            else jnp.asarray(w, jnp.float32))
    w = real * valid.astype(jnp.float32)
    wsum = jnp.sum(w)
    total = jax.lax.psum(wsum, axis) if axis is not None else wsum
    loss = jnp.sum(jnp.where(valid, losses, 0.0) * w) / jnp.maximum(total, 1.0)
    counts = (jnp.sum(w), jnp.sum(real))      # (valid real, real) samples
    return loss, (counts, logits, olens)


def _make_device_step(model, cfg: Config, tx, axis):
    """Per-device train math (grads → psum over the mesh → optax update),
    shared by the streaming and device-cache feeding modes."""

    def device_step(state: TrainState, batch):
        step_rng = jax.random.fold_in(
            jax.random.wrap_key_data(state.rng), state.step)
        step_rng = jax.random.fold_in(step_rng, jax.lax.axis_index(axis))

        (loss, ((n_valid, n_real), _, _)), grads = jax.value_and_grad(
            lambda p: _forward_loss(model, cfg, p, batch, step_rng,
                                    train=True, axis=axis),
            has_aux=True)(state.params)

        # the per-device loss is local_weighted_sum / GLOBAL weight count
        # (psum'd inside _forward_loss), so summing devices' losses and
        # grads yields the exact global weighted mean — exact even when
        # devices hold different numbers of valid/masked samples
        grads = jax.lax.psum(grads, axis)             # gradient all-reduce
        loss = jax.lax.psum(loss, axis)
        valid_frac = (jax.lax.psum(n_valid, axis)
                      / jnp.maximum(jax.lax.psum(n_real, axis), 1.0))
        gnorm = optax.global_norm(grads)

        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        new_params = jax.tree.map(lambda p, u: p + u, state.params, updates)
        new_state = TrainState(
            params=new_params, opt_state=new_opt,
            step=state.step + 1, rng=state.rng)
        metrics = {"loss": loss, "grad_norm": gnorm, "valid_frac": valid_frac}
        return new_state, metrics

    return device_step


def make_train_step(model, cfg: Config, mesh) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics) jitted over mesh.

    Inside shard_map each device computes grads on its batch shard, then
    ``lax.psum`` all-reduces them over the batch axes; the optax update
    runs replicated.
    """
    tx = make_optimizer(cfg.optim)
    axis = cfg.parallel.batch_axes
    device_step = _make_device_step(model, cfg, tx, axis)

    # one compiled shard_map per batch key-set (signals-mode vs cached-
    # feature-mode batches carry different keys; shapes are per-bucket)
    cache: dict = {}

    def jitted(batch):
        keys = tuple(sorted(batch.keys()))
        if keys not in cache:
            specs = {k: P(axis) for k in keys}
            cache[keys] = jax.jit(
                shard_map(device_step, mesh=mesh,
                          in_specs=(P(), specs), out_specs=(P(), P()),
                          check_vma=False),
                donate_argnums=(0,))
        return cache[keys]

    def call(state, batch):
        return jitted(batch)(state, batch)

    # ahead-of-time view of the same program (memory analysis, cost)
    call.lower = lambda state, batch: jitted(batch).lower(state, batch)
    return call


def make_cached_train_step(model, cfg: Config, mesh, corpus_cache,
                           steps_per_dispatch: int = 1) -> Callable:
    """Train step fed from a DeviceCorpusCache (data/device_cache.py).

    call(state, bucket_id, slot_ids) — the slot-id vector is the ONLY
    per-step host→device transfer; inside shard_map each device gathers its
    B/n rows from its local shard of the bucket (wide-row gather), then
    runs the exact same device step as the streaming path.

    ``steps_per_dispatch`` = K > 1 runs K steps as one ``lax.scan`` inside a
    single dispatch (slot_ids [K, B]), amortizing the host's per-dispatch
    cost over K steps. Metrics come back averaged over the K steps.
    """
    tx = make_optimizer(cfg.optim)
    axis = cfg.parallel.batch_axes
    device_step = _make_device_step(model, cfg, tx, axis)
    K = steps_per_dispatch

    def cached_step(state: TrainState, bucket, idx):
        batch = jax.tree.map(lambda x: jnp.take(x, idx, axis=0), bucket)
        return device_step(state, batch)

    def cached_multi(state: TrainState, bucket, idxs):   # idxs [K, kb]
        def body(st, idx):
            return cached_step(st, bucket, idx)
        state, ms = jax.lax.scan(body, state, idxs)
        return state, jax.tree.map(lambda x: jnp.mean(x, axis=0), ms)

    compiled: dict = {}

    def call(state, bucket_id: int, slot_ids):
        if bucket_id not in compiled:
            bucket = corpus_cache.buckets[bucket_id]
            specs = {k: P(axis) for k in bucket}
            idx_spec = P(axis) if K == 1 else P(None, axis)
            fn = cached_step if K == 1 else cached_multi
            compiled[bucket_id] = jax.jit(
                shard_map(fn, mesh=mesh,
                          in_specs=(P(), specs, idx_spec),
                          out_specs=(P(), P()),
                          check_vma=False),
                donate_argnums=(0,))
        return compiled[bucket_id](state, corpus_cache.buckets[bucket_id],
                                   slot_ids)

    return call


def _eval_forward(model, cfg: Config, params, batch):
    """Shared eval math: front-end → model → per-utt CTC loss."""
    if "features" in batch:
        feats, flens = batch["features"], batch["frame_lengths"]
    else:
        feats, flens = batch_features(
            _signals(batch), batch["num_samples"],
            apply_cmvn=cfg.features.cmvn_arg)
    logits, olens = model.apply(params, feats, flens)
    losses = ctc_loss(logits, olens, batch["labels"], batch["label_lengths"])
    return losses, logits, olens


def make_eval_step(model, cfg: Config) -> Callable:
    """eval_step(params, batch) → (per-utt ctc loss [B], logits, out_lens).

    Single-program jit; greedy decode is applied by the caller so beam/LM
    variants can share this step.
    """

    @jax.jit
    def eval_step(params, batch):
        return _eval_forward(model, cfg, params, batch)

    return eval_step


def make_auto_eval(model, cfg: Config, mesh=None) -> Callable:
    """Eval over HOST batches: ``call(params, batch)`` strips
    ``bucket_id``, moves rows to device — sharded over ``mesh`` when it
    has >1 device, plain single-device otherwise — and returns
    (losses, logits, olens). The one place the sharded/unsharded eval
    dichotomy lives (used by the train loop and the evaluate CLI)."""
    from ..parallel.mesh import shard_batch

    if mesh is not None and mesh.devices.size > 1:
        step = make_sharded_eval_step(model, cfg, mesh)

        def call(params, batch):
            b = shard_batch(mesh, {k: v for k, v in batch.items()
                                   if k != "bucket_id"},
                            axis=cfg.parallel.batch_axes)
            return step(params, b)
    else:
        step = make_eval_step(model, cfg)

        def call(params, batch):
            b = {k: jnp.asarray(v) for k, v in batch.items()
                 if k != "bucket_id"}
            return step(params, b)
    return call


def make_sharded_eval_step(model, cfg: Config, mesh) -> Callable:
    """Eval step sharded over the DP mesh (on an n-device run, periodic dev
    eval must not serialize onto one device while the others idle).

    Each device runs the forward on its B/n batch rows, then one
    ``all_gather`` replicates the per-utterance results — rows
    come back in exactly the single-device order, and downstream decoders
    (jitted outside the mesh) see ordinary replicated arrays. Callers feed
    batches through ``parallel.mesh.shard_batch`` so rows land on their
    device directly.
    """
    axis = cfg.parallel.batch_axes

    def device_eval(params, batch):
        losses, logits, olens = _eval_forward(model, cfg, params, batch)
        g = lambda x: jax.lax.all_gather(x, axis, tiled=True)
        return g(losses), g(logits), g(olens)

    cache: dict = {}

    def call(params, batch):
        keys = tuple(sorted(batch.keys()))
        if keys not in cache:
            specs = {k: P(axis) for k in keys}
            cache[keys] = jax.jit(
                shard_map(device_eval, mesh=mesh,
                          in_specs=(P(), specs),
                          out_specs=(P(), P(), P()),
                          check_vma=False))
        return cache[keys](params, batch)

    return call
