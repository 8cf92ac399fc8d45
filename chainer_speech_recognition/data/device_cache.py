"""Device-resident corpus cache: batches assembled ON the device.

Streaming padded batches from host to device caps end-to-end training at
the host→device link rate. The reference's answer (precomputed feature
cache on disk [SURVEY.md §2.1]) doesn't help: the bytes still cross the
link every step.

This cache crosses the link ONCE. Each bucket's padded int16 PCM (plus
labels/lengths) is transferred a single time into device memory, sharded
by rows over the DP mesh (device d holds utterances d, d+n, d+2n, …).
Every training step then sends only a [B] int32 index vector; each device
gathers its own B/n rows from its local shard inside the jitted step
(wide-row gathers). Steady-state host→device traffic: ~1 KB/step instead
of ~21 MB/step.

Budget: int16 PCM ≈ 32 KB/s of audio, so a device's budget of
``train.device_cache_budget_gb`` holds that many GB of padded speech per
device. Corpora beyond it rotate windows (``RotatingDeviceCache``) or fall
back to the streaming Prefetcher path (train/loop.py picks per config;
``estimate_bytes`` lets callers decide). Whether the cache beats the
streaming path on a GPU is not measured yet.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .sampler import BucketSampler


@functools.lru_cache(maxsize=None)
def _feature_builder(mesh, axis, features_cfg, cache_dtype, chunk):
    """Cached jitted shard_map front-end builder — RotatingDeviceCache
    calls this per window per epoch; re-tracing it each call would put
    seconds of compile on every window swap's critical path. Shapes
    re-specialize through the inner jit cache."""
    from jax import shard_map
    from ..frontend.jnp_frontend import batch_features as frontend

    cdt = jnp.dtype(cache_dtype)
    apply_cmvn = features_cfg.cmvn_arg

    def local(sig, num):                       # [R, S] int16, [R] int32
        R = sig.shape[0]
        # pad the TRANSIENT front-end input to a chunk multiple (padded
        # rows are sliced away below — the cache never stores them)
        R_pad = -(-R // chunk) * chunk
        if R_pad != R:
            sig = jnp.pad(sig, ((0, R_pad - R), (0, 0)))
            num = jnp.pad(num, (0, R_pad - R), constant_values=1)
        nc = R_pad // chunk

        def one(args):
            s, n = args
            f, fl = frontend(s.astype(jnp.float32) / 32768.0, n,
                             apply_cmvn=apply_cmvn)
            return f.astype(cdt), fl
        f, fl = jax.lax.map(
            one, (sig.reshape(nc, chunk, -1), num.reshape(nc, chunk)))
        f = f.reshape((R_pad,) + f.shape[2:])
        return f[:R], fl.reshape(-1)[:R]

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(P(axis), P(axis)),
                             out_specs=(P(axis), P(axis)),
                             check_vma=False))


def _build_features(mesh, axis, sig_dev, num_dev, features_cfg,
                    cache_dtype, chunk):
    """Run the configured front-end once over a bucket's device-resident
    PCM, sharded rows staying local; ``lax.map`` over row chunks bounds
    the transient (ext-signal + fp32-feature) memory to ``chunk`` rows per
    device. Returns (features [n*R, T, M, 3] cache_dtype, frame_lengths)."""
    fn = _feature_builder(mesh, axis, features_cfg, cache_dtype, chunk)
    return fn(sig_dev, num_dev)


def _to_int16(host: dict) -> "np.ndarray":
    """int16 wire view of a loaded batch: packed loaders already carry
    int16 signals; float (wav) loaders requantize (the source was PCM16,
    so the round trip is lossless)."""
    sig = host.get("signals_i16")
    if sig is None:
        sig = np.clip(host["signals"] * 32768.0,
                      -32768, 32767).astype(np.int16)
    return sig


def _pcm_row_bytes(shape) -> int:
    return shape.max_samples * 2 + shape.max_label_len * 4 + 8


def _feat_row_bytes(shape, cache_dtype: str) -> int:
    from .. import constants as C

    itemsize = np.dtype(cache_dtype).itemsize
    return (shape.max_frames * C.N_MELS * C.N_FEATURE_CHANNELS * itemsize
            + shape.max_label_len * 4 + 8)


def estimate_bytes(sampler: BucketSampler, features: bool = False,
                   cache_dtype: str = "bfloat16") -> int:
    """Device bytes the cache would occupy across the whole mesh.

    ``features=True`` (the train-loop default path) estimates the BUILD
    PEAK of the feature cache — steady-state bf16 features plus the
    largest single bucket's transient PCM (buckets build one at a time;
    each bucket's PCM is freed once its features exist) — so the
    device_cache/rotating auto decision respects the budget even while
    building, not just at steady state."""
    total, max_bucket_pcm = 0, 0
    for shape, idxs in zip(sampler.shapes, sampler.buckets):
        if features:
            total += _feat_row_bytes(shape, cache_dtype) * len(idxs)
            max_bucket_pcm = max(max_bucket_pcm,
                                 shape.max_samples * 2 * len(idxs))
        else:
            total += _pcm_row_bytes(shape) * len(idxs)
    return total + max_bucket_pcm


class DeviceCorpusCache:
    """Per-bucket device-resident padded corpus, rows sharded over the mesh.

    ``buckets[bid]`` is a dict of jax Arrays sharded ``P(axis)`` on rows.
    PCM mode (``features_cfg=None``):
      signals_i16   [n*R, S_b]   int16
      num_samples   [n*R]        int32
      labels        [n*R, L]     int32
      label_lengths [n*R]        int32
    Feature mode (``features_cfg`` = FeatureConfig): the front-end runs
    ONCE at build time (on device, chunked ``lax.map`` under ``shard_map``
    so transient memory stays bounded) and the cache stores
      features       [n*R, T_b, n_mels, 3]  cache_dtype (bf16 default)
      frame_lengths  [n*R] int32  (+ labels/label_lengths)
    — the reference's precomputed feature cache (SURVEY.md §2.1) made
    device-resident: every training step then skips the front-end
    recompute, and bf16 features are SMALLER than int16 PCM (1024-frame
    utt: 245 KB vs 327 KB). R is padded to a chunk multiple (padded slots
    are never sampled). ``epoch_batches`` emits device-LOCAL slot ids:
    segment d of each [B] index vector addresses device d's own shard, so
    the in-step gather is local (no collectives).
    """

    FE_CHUNK = 32          # rows per device per front-end build step
    PUT_ROWS = 256         # rows per device per cache-build load chunk
                           # (bounds the host-RAM peak; see __init__)

    def __init__(self, mesh: Mesh, loader, sampler: BucketSampler,
                 axis: str | tuple[str, ...] = "data", seed: int = 0,
                 features_cfg=None, cache_dtype: str = "bfloat16"):
        self.n = mesh.devices.size
        self.axis = axis
        self.seed = seed
        self.shapes = sampler.shapes
        sharding = NamedSharding(mesh, P(axis))
        self.buckets: dict[int, dict] = {}
        self.real_counts: dict[int, np.ndarray] = {}   # [n] per device
        self.utt_map: dict[int, np.ndarray] = {}       # [n, R] -> corpus idx
        for bid, idxs in enumerate(sampler.buckets):
            if len(idxs) == 0:
                continue
            local = [idxs[d :: self.n] for d in range(self.n)]
            R = max(len(l) for l in local)
            counts = np.asarray([len(l) for l in local], np.int32)
            padded = np.stack([
                np.concatenate([l, np.full(R - len(l), idxs[0],
                                           dtype=idxs.dtype)])
                for l in local])                        # [n, R]
            # chunked host assembly (review r3): loading the WHOLE bucket
            # through a float32 wav loader peaks at ~4x the bucket's int16
            # bytes of host RAM (float signals + the requantize temp);
            # loading PUT_ROWS rows/device at a time into a preallocated
            # int16 buffer bounds the float transient to one chunk
            host: dict | None = None
            for r0 in range(0, R, self.PUT_ROWS):
                sel = padded[:, r0 : r0 + self.PUT_ROWS]     # [n, w]
                part = loader.load(bid, sel.reshape(-1))
                arrs = {"signals_i16": _to_int16(part),
                        "num_samples": part["num_samples"].astype(np.int32),
                        "labels": part["labels"],
                        "label_lengths": part["label_lengths"]}
                if host is None:
                    host = {k: np.empty((self.n * R,) + v.shape[1:], v.dtype)
                            for k, v in arrs.items()}
                w = sel.shape[1]
                for k, v in arrs.items():
                    # device-major layout: device d owns global rows
                    # [d*R, (d+1)*R) — exactly what P(axis) shards; one
                    # strided assignment through a [n, R, ...] view of
                    # the host buffer places every device's chunk
                    host[k].reshape((self.n, R) + v.shape[1:])[:, r0:r0 + w] \
                        = v.reshape((self.n, w) + v.shape[1:])
            sig = host["signals_i16"]
            num = host["num_samples"]
            if features_cfg is not None:
                feats, flens = _build_features(
                    mesh, axis, jax.device_put(sig, sharding),
                    jax.device_put(num, sharding),
                    features_cfg, cache_dtype, self.FE_CHUNK)
                self.buckets[bid] = {
                    "features": feats, "frame_lengths": flens,
                    "labels": jax.device_put(host["labels"], sharding),
                    "label_lengths": jax.device_put(
                        host["label_lengths"], sharding),
                }
            else:
                self.buckets[bid] = {
                    "signals_i16": jax.device_put(sig, sharding),
                    "num_samples": jax.device_put(num, sharding),
                    "labels": jax.device_put(host["labels"], sharding),
                    "label_lengths": jax.device_put(
                        host["label_lengths"], sharding),
                }
            self.real_counts[bid] = counts
            self.utt_map[bid] = padded

    def epoch_dispatches(self, epoch: int,
                         steps_per_dispatch: int) -> list[tuple[int, np.ndarray]]:
        """Group the epoch's batches into [K, B] slot matrices of same-bucket
        consecutive batches, for make_cached_train_step(steps_per_dispatch=K).
        The per-bucket batch count is rounded up to a multiple of K by
        wrapping (same oversampling policy as epoch_batches); dispatch order
        is shuffled deterministically."""
        k = steps_per_dispatch
        if k <= 1:
            return self.epoch_batches(epoch)
        per_bucket: dict[int, list[np.ndarray]] = {}
        for bid, slots in self.epoch_batches(epoch):
            per_bucket.setdefault(bid, []).append(slots)
        rng = np.random.default_rng([self.seed, epoch, 0xD15B])
        out = []
        for bid, vecs in per_bucket.items():
            while len(vecs) % k:
                vecs.append(vecs[len(vecs) % k - 1])     # wrap-pad
            for j in range(0, len(vecs), k):
                out.append((bid, np.stack(vecs[j : j + k])))
        order = rng.permutation(len(out))
        return [out[i] for i in order]

    def epoch_batches(self, epoch: int) -> list[tuple[int, np.ndarray]]:
        """Deterministic per-(seed, epoch) list of (bucket_id, local slot
        ids [B]); segment d of each vector is device d's sample of its own
        rows. Batches-per-bucket is ceil(max_rows_per_device / k): every
        real row is visited at least once per epoch; devices with fewer
        rows wrap around their permutation (standard distributed-sampler
        padding — slight oversampling instead of dropping remainders)."""
        rng = np.random.default_rng([self.seed, epoch, 0xCACE])
        out = []
        for bid, cache in self.buckets.items():
            B = self.shapes[bid].batch_size
            if B % self.n:
                raise ValueError(
                    f"bucket {bid}: batch size {B} not divisible by "
                    f"mesh size {self.n} — adjust buckets.batch_sizes")
            k = B // self.n
            counts = self.real_counts[bid]
            nb = -(-int(max(counts)) // k)         # ceil: cover every row
            perms = [np.resize(rng.permutation(int(c)), nb * k)
                     for c in counts]              # wrap-pad short devices
            for j in range(nb):
                seg = [p[j * k : (j + 1) * k] for p in perms]
                out.append((bid, np.concatenate(seg).astype(np.int32)))
        order = rng.permutation(len(out))
        return [out[i] for i in order]

    def utterance_indices(self, bid: int, slot_ids: np.ndarray) -> np.ndarray:
        """Map one batch's device-local slot ids back to corpus indices
        (segment d indexes utt_map[d]) — for tests/debugging."""
        k = len(slot_ids) // self.n
        return np.concatenate([
            self.utt_map[bid][d][slot_ids[d * k : (d + 1) * k]]
            for d in range(self.n)])


class RotatingDeviceCache:
    """Device-resident cache for corpora LARGER than the device budget.

    The full-corpus DeviceCorpusCache needs the whole padded corpus in
    device memory;
    a CSJ-scale corpus (~660 h ≈ 76 GB int16) does not fit. Falling back to
    per-step streaming re-pays the host→device link every step (the round-1
    wall). This rotates WINDOWS instead:

    * each epoch, every bucket's device-local rows are permuted (seed,
      epoch)-deterministically and chunked into ``n_windows`` fixed-size
      slices, sized so one window ≤ half the budget;
    * training runs all dispatches of window w while window w+1's host
      assembly + async ``device_put`` proceeds in a background thread
      (double-buffering: ≤ 2 windows resident);
    * every step still sends only [K, B] slot ids; the per-bucket window
      row counts are FIXED across windows, so the compiled step is reused
      (buffers are call arguments, not compile-time constants).

    Each epoch transfers the corpus once (like streaming) but in large
    sequential copies that overlap compute, and every row is visited ≥ once
    per epoch. Shuffling is window-local within an epoch and global across
    epochs (rows are re-permuted before re-chunking) — the standard
    shard-then-shuffle trade.
    """

    def __init__(self, mesh: Mesh, loader, sampler: BucketSampler,
                 budget_bytes: int,
                 axis: str | tuple[str, ...] = "data", seed: int = 0,
                 features_cfg=None, cache_dtype: str = "bfloat16"):
        self.n = mesh.devices.size
        self.axis = axis
        self.seed = seed
        self.loader = loader
        self.shapes = sampler.shapes
        self.sharding = NamedSharding(mesh, P(axis))
        self.mesh = mesh
        # feature windows (train.cache_features): fetch_window runs the
        # front-end once per arriving window (in the background fetch
        # thread, overlapping training on the previous window) and keeps
        # bf16 features — 25% smaller than int16 PCM, and the per-step
        # front-end recompute disappears from the dispatch critical path
        self.features_cfg = features_cfg
        self.cache_dtype = cache_dtype
        self.bucket_rows: dict[int, list[np.ndarray]] = {}   # per device
        # window sizing respects the budget at the RESIDENCY PEAK, not the
        # steady state: PCM mode holds 2 windows (double buffer) = 2p/row;
        # feature mode holds the current window's features, the next
        # window's features, and the next window's transient build PCM
        # = (2f + p)/row
        total_cost = 0
        for bid, idxs in enumerate(sampler.buckets):
            if len(idxs) == 0:
                continue
            self.bucket_rows[bid] = [idxs[d :: self.n] for d in range(self.n)]
            shape = self.shapes[bid]
            if features_cfg is not None:
                cost = 2 * _feat_row_bytes(shape, cache_dtype) \
                    + _pcm_row_bytes(shape)
            else:
                cost = 2 * _pcm_row_bytes(shape)
            total_cost += cost * len(idxs)
        if not self.bucket_rows:
            raise ValueError("rotating cache: no non-empty buckets")
        # make_cached_train_step reads .buckets at call time; the loop
        # points this at the current window's buffers (set_window) before
        # its first dispatch. Instance state — two live caches must not
        # share a window (ADVICE r1).
        self.buckets: dict[int, dict] = {}
        self.n_windows = max(1, -(-total_cost // max(int(budget_bytes), 1)))
        # fixed per-device rows per window, per bucket (ceil split)
        self.rows_per_window: dict[int, int] = {}
        for bid, per_dev in self.bucket_rows.items():
            r_max = max(len(l) for l in per_dev)
            self.rows_per_window[bid] = -(-r_max // self.n_windows)

    # ---- epoch plan -------------------------------------------------------

    def _epoch_perms(self, epoch: int) -> dict[int, list[np.ndarray]]:
        """Per-bucket, per-device permuted corpus rows for this epoch."""
        rng = np.random.default_rng([self.seed, epoch, 0x307A7E])
        return {bid: [l[rng.permutation(len(l))] for l in per_dev]
                for bid, per_dev in self.bucket_rows.items()}

    def _window_rows(self, perms, w: int) -> dict[int, np.ndarray]:
        """[n, R_w] corpus-index matrix per bucket for window w (wrap-padded
        so shapes are static; padded slots are never sampled)."""
        out = {}
        for bid, per_dev in perms.items():
            R = self.rows_per_window[bid]
            fallback = next(l for l in per_dev if len(l))   # same-bucket row
            rows = []
            for l in per_dev:
                if len(l) == 0:      # device owns no rows of this bucket:
                    rows.append(np.broadcast_to(fallback[:1], (R,)).copy())
                    continue
                # device-local slice of this window (wrap within the
                # device's own rows — every device always contributes R)
                idx = np.arange(w * R, (w + 1) * R) % len(l)
                rows.append(l[idx])
            out[bid] = np.stack(rows)
        return out

    def _window_counts(self, perms, w: int) -> dict[int, np.ndarray]:
        """REAL (unwrapped) rows per device in window w, per bucket."""
        out = {}
        for bid, per_dev in perms.items():
            R = self.rows_per_window[bid]
            counts = []
            for l in per_dev:
                lo, hi = w * R, (w + 1) * R
                counts.append(max(0, min(hi, len(l)) - lo))
            out[bid] = np.asarray(counts, np.int32)
        return out

    def epoch_plan(self, epoch: int, steps_per_dispatch: int):
        """[(window_id, bucket_id, slots [K, B] or [B])] — window ids are
        contiguous non-decreasing so the loop swaps buffers on change."""
        k = max(1, steps_per_dispatch)
        perms = self._epoch_perms(epoch)
        rng = np.random.default_rng([self.seed, epoch, 0x307A7F])
        plan = []
        for w in range(self.n_windows):
            counts = self._window_counts(perms, w)
            vecs_by_bucket: dict[int, list[np.ndarray]] = {}
            for bid, c in counts.items():
                B = self.shapes[bid].batch_size
                if B % self.n:
                    raise ValueError(
                        f"bucket {bid}: batch size {B} not divisible by "
                        f"mesh size {self.n}")
                kb = B // self.n
                if int(max(c)) == 0:
                    continue
                nb = -(-int(max(c)) // kb)
                # sample window-LOCAL slot ids; wrap devices with fewer
                # real rows (oversampling, as in DeviceCorpusCache)
                perms_local = [np.resize(rng.permutation(max(int(ci), 1)),
                                         nb * kb) for ci in c]
                for j in range(nb):
                    seg = [p[j * kb : (j + 1) * kb] for p in perms_local]
                    vecs_by_bucket.setdefault(bid, []).append(
                        np.concatenate(seg).astype(np.int32))
            wplan = []
            for bid, vecs in vecs_by_bucket.items():
                if k == 1:
                    wplan.extend((w, bid, v) for v in vecs)
                else:
                    while len(vecs) % k:
                        vecs.append(vecs[len(vecs) % k - 1])
                    wplan.extend((w, bid, np.stack(vecs[j : j + k]))
                                 for j in range(0, len(vecs), k))
            order = rng.permutation(len(wplan))
            plan.extend(wplan[i] for i in order)
        return plan

    # ---- buffers ----------------------------------------------------------

    def fetch_window(self, epoch: int, w: int) -> dict[int, dict]:
        """Assemble window w's host arrays and start their async transfer.
        Safe to call from a background thread (pure NumPy + device_put)."""
        perms = self._epoch_perms(epoch)
        rows = self._window_rows(perms, w)
        counts = self._window_counts(perms, w)
        buffers = {}
        for bid, mat in rows.items():
            if int(counts[bid].max()) == 0:
                # epoch_plan never dispatches this bucket in window w
                # (all-wrapped rows) — skip its IO + transfer + FE build
                continue
            host = self.loader.load(bid, mat.reshape(-1))
            sig = _to_int16(host)
            labels = {
                "labels": jax.device_put(host["labels"], self.sharding),
                "label_lengths": jax.device_put(
                    host["label_lengths"], self.sharding),
            }
            sig_dev = jax.device_put(sig, self.sharding)
            num_dev = jax.device_put(
                host["num_samples"].astype(np.int32), self.sharding)
            if self.features_cfg is not None:
                feats, flens = _build_features(
                    self.mesh, self.axis, sig_dev, num_dev,
                    self.features_cfg, self.cache_dtype,
                    DeviceCorpusCache.FE_CHUNK)
                buffers[bid] = {"features": feats, "frame_lengths": flens,
                                **labels}
            else:
                buffers[bid] = {"signals_i16": sig_dev,
                                "num_samples": num_dev, **labels}
        return buffers

    def set_window(self, buffers: dict[int, dict]) -> None:
        self.buckets = buffers


def rotating_dispatches(cache: RotatingDeviceCache, epoch: int, plan, pool):
    """Iterate a rotating (sub-)plan with double-buffered window fetches —
    the ONE implementation of the swap discipline used by both the train
    loop and bench.py: window w+1's host assembly + transfer (+ on-device
    FE in feature mode) runs on ``pool`` while window w trains. Yields
    (bucket_id, slots) with the right window resident."""
    window_seq: list[int] = []
    for w, _, _ in plan:
        if not window_seq or window_seq[-1] != w:
            window_seq.append(w)
    futures = {}
    if window_seq:
        futures[window_seq[0]] = pool.submit(
            cache.fetch_window, epoch, window_seq[0])
    cur_w = None
    for w, bid, slots in plan:
        if w != cur_w:
            cache.set_window(futures.pop(w).result())
            cur_w = w
            pos = window_seq.index(w) + 1
            if pos < len(window_seq) and window_seq[pos] not in futures:
                futures[window_seq[pos]] = pool.submit(
                    cache.fetch_window, epoch, window_seq[pos])
        yield bid, slots
