#!/usr/bin/env python
"""Benchmark harness (BASELINE.json:2): training utterances/sec/device on
the config-2 acoustic model (conv subsampling + 3-layer BiGRU CTC), bucketed
synthetic 16 kHz audio, full fused train step (on-device front-end → model →
CTC → grad → update) under the DP mesh.

Run on the GPU:  python bench.py          (``--backend cpu`` runs the same
code on the CPU backend, for tests; its numbers are not device numbers)

Prints ONE JSON line last:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, "extra": {...}}
``device`` names the platform, ``device_kind``, device count and the
card's name and power limit (nvidia-smi) the numbers were taken on.

Reported alongside the device-resident headline (``extra``):
* ``mfu`` / ``model_tflops_per_sec`` — analytic model-FLOPs utilization
  (utils/flops.py) against the device's published bf16 peak;
* ``from_disk_utt_per_sec_per_chip`` — SUSTAINED end-to-end training rate
  on an on-disk packed corpus via the device-resident corpus cache
  (data/device_cache.py), i.e. what a user actually gets;
* ``from_disk_stream_utt_per_sec`` — the same corpus fed by the streaming
  host loader (the no-cache fallback rate).

Every timed window ends in ``jax.block_until_ready``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints them
    (read in a child process that stays off JAX); "" without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def _bench_from_disk(cfg, args, n_chips):
    """Build (once) an on-disk packed corpus, then measure sustained
    end-to-end training throughput in both feeding modes."""
    import numpy as np

    from chainer_speech_recognition import constants as C
    from chainer_speech_recognition.data.corpus import (
        Utterance, build_vocab, scan_corpus)
    from chainer_speech_recognition.data.device_cache import (
        DeviceCorpusCache)
    from chainer_speech_recognition.data.packed import (
        PackedBatchLoader, PackedCorpus, pack_corpus)
    from chainer_speech_recognition.data.sampler import (
        BucketSampler, Prefetcher)
    from chainer_speech_recognition.data.synthetic import make_utterance
    from chainer_speech_recognition.frontend.jnp_frontend import (
        batch_features)
    from chainer_speech_recognition.models.presets import build_model
    from chainer_speech_recognition.parallel.mesh import (
        dispatch_sharding, make_mesh, shard_batch)
    from chainer_speech_recognition.train.state import init_state
    from chainer_speech_recognition.train.step import (
        make_cached_train_step, make_train_step)
    from chainer_speech_recognition.utils.wav import write_wav
    from chainer_speech_recognition.vocab import Vocab
    import jax

    work = args.disk_workdir
    os.makedirs(work, exist_ok=True)
    prefix = os.path.join(work, f"bench_{args.disk_utts}_{args.frames}")
    max_samples = (args.frames - 1) * C.HOP_LENGTH
    t_pack0 = time.perf_counter()
    if not (os.path.exists(prefix + ".pack")
            and os.path.exists(prefix + ".meta.npz")):
        rng = np.random.default_rng(7)
        wav_dir = prefix + "_wavs"
        os.makedirs(wav_dir, exist_ok=True)
        utts = []
        for i in range(args.disk_utts):
            n_lab = int(rng.integers(8, 25))
            ids = [int(k) for k in rng.integers(1, 40, n_lab)]
            sig, _ = make_utterance(rng, ids, tone_len=max_samples // 25)
            sig = sig[:max_samples]
            path = os.path.join(wav_dir, f"u{i:05d}.wav")
            write_wav(path, sig)
            text = "".join(chr(0x3042 + k) for k in ids)
            utts.append(Utterance(f"u{i:05d}", path, text, len(sig)))
        vocab = Vocab.build([u.text for u in utts])
        pack_corpus(prefix, utts, vocab)
        vocab.save(prefix + ".vocab.txt")
    vocab = Vocab.load(prefix + ".vocab.txt")
    pack_seconds = time.perf_counter() - t_pack0

    pc = PackedCorpus(prefix)
    cfg = cfg.override({
        "model.vocab_size": len(vocab),
        "buckets.boundaries": [args.frames],
        "buckets.batch_sizes": [args.batch],
        "buckets.max_label_len": 32,
    })
    model = build_model(cfg.model)
    mesh = make_mesh(cfg.parallel)
    sampler = BucketSampler(pc.utterances(), cfg.buckets, seed=0)
    loader = PackedBatchLoader(pc, cfg.buckets)

    ex = loader.load(0, sampler.buckets[0][:1])
    feats, flens = batch_features(
        (ex["signals_i16"].astype(np.float32) / 32768.0), ex["num_samples"])
    state = init_state(model, cfg.optim, jax.random.key(0), feats, flens)

    # --- device-cache mode (the train-loop default): transfer once, run
    # the front-end once into bf16 device features, then index-fed K-step
    # dispatches (lax.scan in-jit amortizes per-dispatch host latency) ----
    t0 = time.perf_counter()
    cache = DeviceCorpusCache(mesh, loader, sampler, seed=0,
                              features_cfg=cfg.features)
    jax.block_until_ready(cache.buckets[0]["features"])
    cache_build_seconds = time.perf_counter() - t0
    K = args.steps_per_dispatch
    cached_step = make_cached_train_step(model, cfg, mesh, cache,
                                         steps_per_dispatch=K)
    sh = dispatch_sharding(mesh, 1 if K == 1 else 2)

    def dispatch_stream():
        epoch = 0
        while True:
            for bid, slots in cache.epoch_dispatches(epoch, K):
                yield bid, slots
            epoch += 1

    stream = dispatch_stream()
    for _ in range(3):                         # compile + warm (donation
        bid, slots = next(stream)              # layout settles on call 2+)
        state, m = cached_step(state, bid, jax.device_put(slots, sh))
        jax.block_until_ready((state, m))
    dispatches = -(-args.disk_steps // K)
    t0 = time.perf_counter()
    for _ in range(dispatches):
        bid, slots = next(stream)
        state, m = cached_step(state, bid, jax.device_put(slots, sh))
    jax.block_until_ready((state, m))
    dt = time.perf_counter() - t0
    cached_ups = args.batch * dispatches * K / dt / n_chips

    # --- streaming mode: padded batches cross the link every step -------
    batches = sampler.epoch_batches(0)
    stream_step = make_train_step(model, cfg, mesh)
    n_s = min(args.disk_stream_steps, len(batches))
    it = iter(Prefetcher(loader, batches, num_workers=4))
    b0 = next(it)
    state, m = stream_step(state, shard_batch(
        mesh, {k: v for k, v in b0.items() if k != "bucket_id"}))
    jax.block_until_ready((state, m))          # compile+warm
    t0 = time.perf_counter()
    done = 0
    for b in it:
        state, m = stream_step(state, shard_batch(
            mesh, {k: v for k, v in b.items() if k != "bucket_id"}))
        done += 1
        if done >= n_s:
            break
    jax.block_until_ready((state, m))
    sdt = time.perf_counter() - t0
    stream_ups = args.batch * done / sdt / n_chips if done else 0.0

    ctx = {"cfg": cfg, "model": model, "mesh": mesh, "sampler": sampler,
           "loader": loader, "state": state}
    return {
        "from_disk_utt_per_sec_per_chip": round(cached_ups, 1),
        "from_disk_stream_utt_per_sec": round(stream_ups, 1),
        "from_disk_corpus_utts": args.disk_utts,
        "from_disk_cache_build_seconds": round(cache_build_seconds, 2),
        "from_disk_pack_seconds": round(pack_seconds, 2),
    }, ctx


def _bench_rotating(ctx, args, n_chips, budget_bytes=None,
                    key_prefix="from_disk_rotating", timed_epochs=2):
    """Rotating-window mode: by default force the budget so ≥3 windows
    rotate; the CSJ-scale caller passes the UNFORCED per-device budget.
    Epoch 0 warms/compiles, then ``timed_epochs`` full epochs are timed —
    the cross-epoch window re-permutation is on the measured path. Uses
    the SAME double-buffered window iteration as train/loop.py (shared
    generator) — the measured pipeline IS the production pipeline."""
    import concurrent.futures

    import jax

    from chainer_speech_recognition.data.device_cache import (
        RotatingDeviceCache, estimate_bytes, rotating_dispatches)
    from chainer_speech_recognition.parallel.mesh import dispatch_sharding
    from chainer_speech_recognition.train.step import (
        make_cached_train_step)

    cfg, model, mesh = ctx["cfg"], ctx["model"], ctx["mesh"]
    sampler, loader, state = ctx["sampler"], ctx["loader"], ctx["state"]
    budget = budget_bytes or max(estimate_bytes(sampler, features=True),
                                 1) // 2
    rot = RotatingDeviceCache(mesh, loader, sampler, budget_bytes=budget,
                              seed=0, features_cfg=cfg.features)
    Kr = 2
    rot_step = make_cached_train_step(model, cfg, mesh, rot,
                                      steps_per_dispatch=Kr)
    sh_r = dispatch_sharding(mesh, 2)
    rot_done = 0
    t_rot0 = None
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        for epoch in range(1 + timed_epochs):           # epoch 0 warms/compiles
            plan = rot.epoch_plan(epoch, Kr)
            for bid, slots in rotating_dispatches(rot, epoch, plan, pool):
                state, m = rot_step(state, bid, jax.device_put(slots, sh_r))
                if t_rot0 is not None:
                    rot_done += 1
            if epoch == 0:
                jax.block_until_ready((state, m))       # compile+warm
                t_rot0 = time.perf_counter()
        jax.block_until_ready((state, m))
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    rot_dt = time.perf_counter() - t_rot0
    rot_ups = args.batch * Kr * rot_done / rot_dt / n_chips if rot_done else 0.0
    return {f"{key_prefix}_utt_per_sec": round(rot_ups, 1),
            f"{key_prefix}_windows": rot.n_windows}


def _bench_csj_scale(args, n_chips, compute_dtype):
    """CSJ-scale rotating demonstration (config 5, BASELINE.json:11): a
    multi-GB on-disk packed corpus (built once, cached) trained for ≥2
    FULL timed epochs in rotating-window mode at the UNFORCED default
    per-device budget — no artificial window
    forcing. Records sustained utt/s, window count, corpus bytes, and
    peak device memory."""
    import jax
    import numpy as np

    from chainer_speech_recognition import constants as C
    from chainer_speech_recognition.config import preset_config
    from chainer_speech_recognition.data.packed import (
        PackedBatchLoader, PackedCorpus)
    from chainer_speech_recognition.data.sampler import BucketSampler
    from chainer_speech_recognition.data.synth_corpus import (
        synthesize_packed)
    from chainer_speech_recognition.frontend.jnp_frontend import (
        batch_features)
    from chainer_speech_recognition.models.presets import build_model
    from chainer_speech_recognition.parallel.mesh import make_mesh
    from chainer_speech_recognition.train.state import init_state
    from chainer_speech_recognition.vocab import Vocab

    os.makedirs(args.disk_workdir, exist_ok=True)
    prefix = os.path.join(args.disk_workdir,
                          f"csj_{args.csj_utts}_{args.frames}")
    max_samples = (args.frames - 1) * C.HOP_LENGTH
    build = synthesize_packed(prefix, args.csj_utts, vocab_size=64,
                              max_samples=max_samples, log_every=4000)
    vocab = Vocab.load(prefix + ".vocab.txt")
    pc = PackedCorpus(prefix)
    cfg = preset_config(args.preset).override({
        "model.vocab_size": len(vocab),
        "model.compute_dtype": compute_dtype,
        "buckets.boundaries": [args.frames],
        "buckets.batch_sizes": [args.batch],
        "buckets.max_label_len": 32,
    })
    model = build_model(cfg.model)
    mesh = make_mesh(cfg.parallel)
    sampler = BucketSampler(pc.utterances(), cfg.buckets, seed=0)
    loader = PackedBatchLoader(pc, cfg.buckets)
    ex = loader.load(0, sampler.buckets[0][:1])
    feats, flens = batch_features(
        ex["signals_i16"][:1].astype(np.float32) / 32768.0,
        ex["num_samples"][:1])
    state = init_state(model, cfg.optim, jax.random.key(0), feats, flens)
    ctx = {"cfg": cfg, "model": model, "mesh": mesh, "sampler": sampler,
           "loader": loader, "state": state}
    # UNFORCED: the per-device default budget × mesh size, exactly what
    # train/loop.py's auto mode would grant
    budget = int(cfg.train.device_cache_budget_gb * 1e9 * n_chips)
    out = {"csj_scale_corpus_gb": round(build["bytes"] / 1e9, 2),
           "csj_scale_corpus_utts": args.csj_utts,
           "csj_scale_build_seconds": build["seconds"],
           "csj_scale_timed_epochs": args.csj_epochs}
    out.update(_bench_rotating(ctx, args, n_chips, budget_bytes=budget,
                               key_prefix="csj_scale",
                               timed_epochs=args.csj_epochs))
    try:
        stats = jax.local_devices()[0].memory_stats() or {}
        if "peak_bytes_in_use" in stats:
            out["csj_scale_peak_device_gb"] = round(
                stats["peak_bytes_in_use"] / 1e9, 2)
    except Exception:
        pass
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--backend", choices=["gpu", "cpu"], default="gpu")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=64)  # B64: measured sweet spot
    p.add_argument("--frames", type=int, default=1024)  # ~10.2 s utterances
    p.add_argument("--preset", default="bigru")
    p.add_argument("--no-from-disk", action="store_true",
                   help="skip the on-disk end-to-end measurement")
    p.add_argument("--no-presets", action="store_true",
                   help="skip the per-preset device-resident matrix")
    p.add_argument("--disk-utts", type=int, default=512)
    p.add_argument("--csj-utts", type=int, default=13000,
                   help="CSJ-scale demo corpus size (~327 KB/utt → ~4.3 GB)")
    p.add_argument("--csj-epochs", type=int, default=2,
                   help="timed FULL epochs for the CSJ-scale rotating demo")
    p.add_argument("--no-csj-scale", action="store_true",
                   help="skip the multi-GB rotating demonstration")
    p.add_argument("--disk-steps", type=int, default=64)
    p.add_argument("--steps-per-dispatch", type=int, default=8)
    p.add_argument("--disk-stream-steps", type=int, default=6)
    p.add_argument("--disk-workdir",
                   default=os.path.join(REPO, ".bench_corpus"))
    p.add_argument("--no-longform", action="store_true",
                   help="skip the long-form (T'=1024) attention measurement")
    p.add_argument("--inject-error", default=None, metavar="SECTION",
                   help="testing hook: raise inside the named section to "
                        "exercise the crash isolation (tests/test_bench_"
                        "isolation.py)")
    args = p.parse_args(argv)

    import jax

    if args.backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        # no fallback: a GPU benchmark that finds no GPU measures nothing
        raise SystemExit(f"bench: no GPU found (devices: {jax.devices()})")
    from chainer_speech_recognition.utils.runtime import enable_compilation_cache
    enable_compilation_cache()
    import jax.numpy as jnp
    import numpy as np

    from chainer_speech_recognition import constants as C
    from chainer_speech_recognition.config import preset_config
    from chainer_speech_recognition.data.synthetic import make_batch
    from chainer_speech_recognition.frontend.jnp_frontend import batch_features
    from chainer_speech_recognition.models.presets import build_model
    from chainer_speech_recognition.parallel.mesh import make_mesh, shard_batch
    from chainer_speech_recognition.train.state import init_state
    from chainer_speech_recognition.train.step import make_train_step
    from chainer_speech_recognition.utils import flops as F

    n_chips = len(jax.devices())
    compute_dtype = "float32" if args.backend == "cpu" else "bfloat16"
    cfg = preset_config(args.preset).override({
        "model.vocab_size": 64, "model.compute_dtype": compute_dtype,
    })
    model = build_model(cfg.model)
    mesh = make_mesh(cfg.parallel)

    def make_bucket_batch(Bn, frames):
        """Synthetic bucket batch: utterances 60-100% of the bucket's max
        frames, zero-padded to the static shape. ONE copy of the recipe —
        the long-form section measures on the identical convention."""
        brng = np.random.default_rng(0)
        ms = (frames - 1) * C.HOP_LENGTH
        bb = make_batch(brng, batch_size=Bn, vocab_size=64, min_len=8,
                        max_len=24, tone_len=ms // 24, max_label_len=32)
        bsig = np.zeros((Bn, ms), np.float32)
        bn = min(bb["signals"].shape[1], ms)
        bsig[:, :bn] = bb["signals"][:, :bn]
        return {"signals": bsig,
                "num_samples": np.minimum(bb["num_samples"], ms),
                "labels": bb["labels"],
                "label_lengths": bb["label_lengths"]}

    B = args.batch
    batch = make_bucket_batch(B, args.frames)

    # Timing: every window ends in jax.block_until_ready. The batch is
    # device-resident during the timed loop (real training gets the same
    # property from the device corpus cache — see the from_disk numbers).
    from chainer_speech_recognition.decode.greedy import greedy_decode
    from chainer_speech_recognition.train.step import make_eval_step

    kind = jax.devices()[0].device_kind

    def bench_device_resident(pcfg, pmodel):
        """(train utt/s/chip, device-time utt/s/chip, decode utt/s/chip,
        mfu, ...) for one preset on the device-resident batch.

        The DEVICE-TIME rate comes from the enqueue-N-drain slope between
        N=steps and N=2 (min over repeats): the fixed per-drain latency and
        pipeline-fill cancel, so this figure moves only when the device's
        per-step cost moves."""
        feats, flens = batch_features(jnp.asarray(batch["signals"][:1]),
                                      jnp.asarray(batch["num_samples"][:1]))
        st = init_state(pmodel, pcfg.optim, jax.random.key(0), feats, flens)
        step = make_train_step(pmodel, pcfg, mesh)
        sharded = shard_batch(mesh, batch)
        st, m = step(st, sharded)                  # compile
        jax.block_until_ready((st, m))
        st, m = step(st, sharded)                  # warm
        jax.block_until_ready((st, m))

        def timed(n, reps=2):
            nonlocal st, m
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                for _ in range(n):
                    st, m = step(st, sharded)
                jax.block_until_ready((st, m))
                best = min(best, time.perf_counter() - t0)
            return best

        dt = timed(args.steps)
        dt2 = timed(2)
        slope = max(dt - dt2, 1e-9) / max(args.steps - 2, 1)
        t_ups = B * args.steps / dt / n_chips
        t_dev_ups = B / slope / n_chips
        # arithmetic efficiency: analytic model FLOPs at the PADDED bucket
        # shape vs the device's bf16 peak
        fps = F.train_flops_per_utt(pcfg.model, args.frames) * t_ups
        p_mfu = F.mfu(fps, kind)

        ev = make_eval_step(pmodel, pcfg)
        eb = {k: jnp.asarray(v) for k, v in batch.items()}

        def decode_once():
            losses, logits, olens = ev(st.params, eb)
            ids, out_lens = greedy_decode(logits, olens, max_len=64)
            return ids

        jax.block_until_ready(decode_once())
        t0 = time.perf_counter()
        for _ in range(args.steps):
            ids = decode_once()
        jax.block_until_ready(ids)
        ddt = time.perf_counter() - t0
        # the eval/greedy decode path runs unsharded (one device): its
        # rate IS the per-device rate — dividing by n_chips would
        # misreport on multi-device meshes
        d_ups = B * args.steps / ddt
        return (t_ups, t_dev_ups, d_ups, p_mfu, fps, float(m["loss"]),
                dt, ddt)

    def bench_beam_e2e(pcfg, pmodel, beam=8):
        """Honest END-TO-END prefix-beam decode: device scan + on-device
        traceback + host pull + id-list materialization, LM fusion on.
        Two rates:
        * stream — beam_decode_stream, the bulk-decode path (grouped
          pulls amortize the device→host latency);
        * sync — one blocking beam_decode per batch (interactive path).
        """
        from chainer_speech_recognition.decode.beam import (
            beam_decode, beam_decode_stream)
        feats, flens = batch_features(jnp.asarray(batch["signals"][:1]),
                                      jnp.asarray(batch["num_samples"][:1]))
        st = init_state(pmodel, pcfg.optim, jax.random.key(0), feats, flens)
        ev = make_eval_step(pmodel, pcfg)
        eb = {k: jnp.asarray(v) for k, v in batch.items()}
        _, logits, olens = ev(st.params, eb)
        logits = jax.block_until_ready(logits)
        V = logits.shape[-1]
        lm = (np.zeros((V, V), np.float32), 2)
        kw = dict(beam=beam, lm=lm, alpha=0.5, beta=1.0, max_len=64)
        hyps = beam_decode(logits, olens, **kw)          # compile + warm
        hyps = beam_decode(logits, olens, **kw)
        assert len(hyps) == B
        n_rep = max(16, args.steps)
        # warm the stream path's per-group-size stack jits (full group of
        # 8 + the n_rep%8 tail group) so the timed loop measures steady
        # state, not two XLA compiles
        for _ in beam_decode_stream(
                ((logits, olens) for _ in range(8 + n_rep % 8 or 8)), **kw):
            pass
        t0 = time.perf_counter()
        done = 0
        for hs in beam_decode_stream(
                ((logits, olens) for _ in range(n_rep)), **kw):
            done += len(hs)
        sdt = time.perf_counter() - t0
        assert done == B * n_rep
        t0 = time.perf_counter()
        for _ in range(n_rep):
            hyps = beam_decode(logits, olens, **kw)
        bdt = time.perf_counter() - t0
        # unsharded one-device rates (see d_ups note)
        return (B * n_rep / sdt, B * n_rep / bdt)

    def bench_beam_hashed(beam=8, V_lm=200, T_lm=256, B_lm=32):
        """Sparse-LM beam at the scale the dense table cannot reach:
        order-4 / V=200 shallow fusion, where dense
        would be V^3·V·4 = 6.4 GB. Builds a synthetic order-4 backoff LM
        with ~120k known contexts (CSJ-scale kana LM density), converts
        to the HashedLM open-addressing device repr, and measures the
        same end-to-end stream decode as bench_beam_e2e."""
        from chainer_speech_recognition.decode.beam import (
            beam_decode_stream)
        from chainer_speech_recognition.decode.lm import NGramLM

        rng = np.random.default_rng(0)
        lm = NGramLM(4, V_lm)
        lm.logp[0][()] = {c: float(np.log(0.9 / (V_lm - 1)))
                          for c in range(1, V_lm)}
        for k in (1, 2, 3):
            raw = rng.integers(1, V_lm, size=(60_000, k))
            ctxs = {tuple(int(x) for x in row) for row in raw}
            for ctx in list(ctxs)[:40_000]:
                succ = rng.integers(1, V_lm, size=8)
                lp = np.log(rng.dirichlet(np.ones(8)) * 0.7)
                lm.logp[k][ctx] = {int(c): float(p)
                                   for c, p in zip(succ, lp)}
                lm.backoff[k][ctx] = float(np.log(0.3))
        t0 = time.perf_counter()
        h = lm.to_hashed()
        build_s = time.perf_counter() - t0
        lg = rng.standard_normal((B_lm, T_lm, V_lm)).astype(np.float32)
        path = rng.integers(0, V_lm, (B_lm, T_lm))
        np.put_along_axis(lg, path[..., None], 6.0, axis=2)
        lg = jnp.asarray(lg)
        ol = jnp.asarray(np.full(B_lm, T_lm, np.int32))
        kw = dict(beam=beam, lm=h, alpha=0.5, beta=1.0, max_len=64)
        n_rep = 24
        for _ in beam_decode_stream(          # compile + warm both groups
                ((lg, ol) for _ in range(8 + n_rep % 8 or 8)), **kw):
            pass
        t0 = time.perf_counter()
        done = 0
        for hs in beam_decode_stream(((lg, ol) for _ in range(n_rep)), **kw):
            done += len(hs)
        sdt = time.perf_counter() - t0
        assert done == B_lm * n_rep
        return (B_lm * n_rep / sdt, h.bytes,
                V_lm ** 3 * V_lm * 4, build_s)

    def bench_largevocab(V, with_hashed=False, B_lv=32, T_lv=256):
        """CSJ-realistic vocabulary scale: greedy, beam
        K=8 e2e (stream path, dense bigram fusion), and optionally
        order-4 hashed-LM fusion, at BPE-sized V on synthetic logits.
        The V=200 row uses identical shapes so the within-3× comparison
        lives in one record."""
        from chainer_speech_recognition.decode.beam import (
            beam_decode_stream)
        from chainer_speech_recognition.decode.greedy import (
            greedy_decode as _greedy)

        rng = np.random.default_rng(0)
        lg = rng.standard_normal((B_lv, T_lv, V)).astype(np.float32)
        path = rng.integers(0, V, (B_lv, T_lv))
        np.put_along_axis(lg, path[..., None], 6.0, axis=2)
        lg = jnp.asarray(lg)
        ol = jnp.asarray(np.full(B_lv, T_lv, np.int32))
        out = {}
        # greedy
        jax.block_until_ready(_greedy(lg, ol, max_len=64))
        t0 = time.perf_counter()
        for _ in range(20):
            res = _greedy(lg, ol, max_len=64)
        jax.block_until_ready(res)
        out["greedy_utt_per_sec"] = round(
            B_lv * 20 / (time.perf_counter() - t0), 1)
        # beam e2e (stream path, dense bigram fusion like beam_e2e)
        lm = (np.zeros((V, V), np.float32), 2)
        kw = dict(beam=8, lm=lm, alpha=0.5, beta=1.0, max_len=64)
        n_rep = 24
        for _ in beam_decode_stream(
                ((lg, ol) for _ in range(8 + n_rep % 8 or 8)), **kw):
            pass
        t0 = time.perf_counter()
        done = 0
        for hs in beam_decode_stream(((lg, ol) for _ in range(n_rep)), **kw):
            done += len(hs)
        assert done == B_lv * n_rep
        out["beam_e2e_utt_per_sec"] = round(
            B_lv * n_rep / (time.perf_counter() - t0), 1)
        if with_hashed:
            from chainer_speech_recognition.decode.lm import (
                NGramLM, device_lm)
            lm4 = NGramLM(4, V)
            lm4.logp[0][()] = {c: float(np.log(0.9 / (V - 1)))
                               for c in range(1, V)}
            for k in (1, 2, 3):
                raw = rng.integers(1, V, size=(60_000, k))
                ctxs = {tuple(int(x) for x in row) for row in raw}
                for ctx in list(ctxs)[:40_000]:
                    succ = rng.integers(1, V, size=8)
                    lp = np.log(rng.dirichlet(np.ones(8)) * 0.7)
                    lm4.logp[k][ctx] = {int(c): float(p)
                                        for c, p in zip(succ, lp)}
                    lm4.backoff[k][ctx] = float(np.log(0.3))
            t0 = time.perf_counter()
            h = device_lm(lm4, repr="auto", dense_budget_bytes=0)
            out["lm_build_seconds"] = round(time.perf_counter() - t0, 1)
            out["lm_hashed_mb"] = round(h.bytes / 2**20, 1)
            out["lm_rows_dtype"] = str(h.rows.dtype)
            kw = dict(beam=8, lm=h, alpha=0.5, beta=1.0, max_len=64)
            for _ in beam_decode_stream(
                    ((lg, ol) for _ in range(8 + n_rep % 8 or 8)), **kw):
                pass
            t0 = time.perf_counter()
            done = 0
            for hs in beam_decode_stream(((lg, ol) for _ in range(n_rep)),
                                         **kw):
                done += len(hs)
            assert done == B_lv * n_rep
            out["beam_hashed_o4_utt_per_sec"] = round(
                B_lv * n_rep / (time.perf_counter() - t0), 1)
        return out

    def bench_streaming(chunk=64, right=16, S=16, secs=8, decoder="greedy",
                        preset=None):
        """Online recognition (decode/streaming.py): S lockstep streams
        fed 1 s PCM blocks through the compiled chunk step; returns the
        steady-state real-time factor (audio-seconds per wall-second,
        all streams summed) at (chunk+right)*10 ms buffer latency.
        decoder="beam" adds the chunk-carried prefix beam + LM fusion
        (K=8, dense bigram table) — the online config-4 path.
        ``preset`` overrides args.preset (the conformer_stream serving
        figures); chunk-causal attention presets get
        their emit region from attn_chunk and require right_frames=0."""
        from chainer_speech_recognition.decode.streaming import (
            StreamingRecognizer)

        scfg = preset_config(preset or args.preset).override({
            "features.cmvn_mode": "causal",
            "model.compute_dtype": compute_dtype})
        if scfg.model.attn_chunk:
            right = 0              # lookahead lives inside the chunk
        smodel = build_model(scfg.model)
        ex = jnp.zeros((1, 64, scfg.features.n_mels, 3), jnp.float32)
        sparams = jax.jit(smodel.init)(jax.random.key(0), ex,
                                       jnp.asarray([64], jnp.int32))
        V = scfg.model.vocab_size
        kw = (dict(decoder="beam", beam=8,
                   lm=(np.zeros((V, V), np.float32), 2))
              if decoder == "beam" else {})
        rec = StreamingRecognizer(smodel, sparams, scfg, batch=S,
                                  chunk_frames=chunk, right_frames=right,
                                  **kw)
        rng = np.random.default_rng(0)
        n = C.SAMPLE_RATE * secs
        pcm = rng.uniform(-0.5, 0.5, (S, n)).astype(np.float32)
        for pass_no in range(2):                  # pass 0 compiles + warms
            rec.reset()
            t0 = time.perf_counter()
            for off in range(0, n, C.SAMPLE_RATE):
                rec.accept(pcm[:, off : off + C.SAMPLE_RATE])
            rec.flush()
            sdt = time.perf_counter() - t0
        return S * secs / sdt

    device = {"platform": jax.devices()[0].platform, "kind": kind,
              "count": n_chips, "gpu": gpu_name_and_power_limit()}
    extra = {"preset": args.preset, "batch": B, "frames": args.frames}

    def section(name, fn, default=None):
        """Crash isolation: one broken section must never unwind the
        process and erase the perf record. A failure lands as ``extra["errors"][name]`` (traceback
        tail) and the final JSON line still prints as the last stdout
        line. ``--inject-error NAME`` exercises this path in tests."""
        try:
            if args.inject_error == name:
                raise RuntimeError(f"injected failure in section {name!r}")
            return fn()
        except Exception:
            import traceback
            tail = [ln.strip() for ln in
                    traceback.format_exc().strip().splitlines()
                    if ln.strip()][-3:]
            extra.setdefault("errors", {})[name] = " | ".join(tail)
            print(f"[bench] section {name!r} failed: {tail[-1]}",
                  file=sys.stderr, flush=True)
            return default

    dr = section("device_resident",
                 lambda: bench_device_resident(cfg, model))
    if dr is not None:
        (ups_per_chip, dev_ups, decode_ups, mfu, flops_per_sec, last_loss,
         dt, ddt) = dr
        audio_sec = float(np.sum(batch["num_samples"])) / C.SAMPLE_RATE
        dev_mfu = F.mfu(F.train_flops_per_utt(cfg.model, args.frames)
                        * dev_ups, kind)
        extra.update({
            "single_dispatch_utt_per_sec": round(ups_per_chip, 1),
            "train_device_utt_per_sec": round(dev_ups, 1),
            "train_rtf_per_chip": round(
                audio_sec * args.steps / dt / n_chips, 1),
            "model_tflops_per_sec": round(flops_per_sec / 1e12, 2),
            "mfu": round(mfu, 4) if mfu is not None else None,
            "mfu_device": round(dev_mfu, 4) if dev_mfu is not None else None,
            "decode_utt_per_sec_per_chip": round(decode_ups, 1),
            "decode_rtf_per_chip": round(audio_sec * args.steps / ddt, 1),
            "loss": round(last_loss, 4),
        })
    else:
        ups_per_chip = dev_ups = decode_ups = 0.0
        mfu = None

    headline = ups_per_chip

    def result_line():
        return json.dumps({
            "metric": "train_utterances_per_sec_per_chip",
            "value": round(headline, 3),
            "unit": "utt/s/chip",
            "device": device,
            "extra": extra,
        })

    if args.backend == "gpu":
        # FIRST preliminary line as soon as the headline microbench is in:
        # consumers read the LAST stdout line, and every section below is
        # minutes of compiles — a harness timeout anywhere past this point
        # must still find a parseable record
        print(result_line(), flush=True)
        be = section("beam_e2e", lambda: bench_beam_e2e(cfg, model))
        if be is not None:
            extra["beam_e2e_utt_per_sec"] = round(be[0], 1)
            extra["beam_sync_utt_per_sec"] = round(be[1], 1)
        bh = section("beam_hashed", lambda: bench_beam_hashed())
        if bh is not None:
            extra["beam_hashed_o4_v200_utt_per_sec"] = round(bh[0], 1)
            extra["lm_hashed_o4_v200_mb"] = round(bh[1] / 2**20, 1)
            extra["lm_dense_o4_v200_equiv_gb"] = round(bh[2] / 2**30, 2)
        # CSJ-realistic vocabulary scale: greedy +
        # beam + order-4 hashed fusion at BPE-sized V, with a same-shape
        # V=200 row so the within-3× claim is checkable in one record
        lv = {}
        for V_lv, hashed_lv in ((200, False), (2048, True), (4096, True)):
            r = section(f"largevocab_v{V_lv}",
                        lambda V_lv=V_lv, h=hashed_lv: bench_largevocab(
                            V_lv, with_hashed=h))
            if r is not None:
                lv[f"v{V_lv}"] = r
        if lv:
            extra["largevocab"] = lv
        # online figures for every STREAMABLE preset: RNN/conv presets and
        # the chunk-causal attention family both stream; only global-
        # attention presets (attn_blocks > 0, attn_chunk == 0) are
        # offline-only and skip them
        if cfg.model.attn_blocks == 0 or cfg.model.attn_chunk > 0:
            r = section("streaming_greedy", lambda: bench_streaming())
            if r is not None:
                extra["stream_rt_factor_16"] = round(r, 1)
            r = section("streaming_beam",
                        lambda: bench_streaming(decoder="beam"))
            if r is not None:
                extra["stream_beam_lm_rt_factor_16"] = round(r, 1)
        # long-form attention: global attention at T' = 1024 (frames
        # 4096), beyond the bucket menu
        if not args.no_longform:
            def _longform():
                lf_frames, lf_B, lf_steps = 4096, 16, 6
                lcfg = preset_config("conformer").override({
                    "model.vocab_size": 64,
                    "model.compute_dtype": compute_dtype,
                    "buckets.boundaries": [lf_frames],
                    "buckets.batch_sizes": [lf_B]})
                lmodel = build_model(lcfg.model)
                lb = make_bucket_batch(lf_B, lf_frames)
                lf, ll = batch_features(jnp.asarray(lb["signals"][:1]),
                                        jnp.asarray(lb["num_samples"][:1]))
                lst = init_state(lmodel, lcfg.optim, jax.random.key(0),
                                 lf, ll)
                lstep = make_train_step(lmodel, lcfg, mesh)
                lsh = shard_batch(mesh, lb)
                for _ in range(2):                     # compile + warm
                    lst, lm_ = lstep(lst, lsh)
                    jax.block_until_ready((lst, lm_))
                t0 = time.perf_counter()
                for _ in range(lf_steps):
                    lst, lm_ = lstep(lst, lsh)
                jax.block_until_ready((lst, lm_))
                return lf_B * lf_steps / (time.perf_counter() - t0) / n_chips
            r = section("attn_longform", _longform)
            if r is not None:
                extra["conformer_longform_t1024_utt_per_sec"] = round(r, 1)

            def _longform_e2e(secs=120, B_lf=4, beam=8, iters=4):
                """Minutes-long OFFLINE transcription end to end: front-end
                → conformer forward with global attention at T' ≈ secs·25
                → prefix beam → host pull. The product surface is `decode`
                on a long wav; this measures the same pipeline shape
                device-side."""
                from chainer_speech_recognition.decode.beam import (
                    beam_decode)
                lcfg = preset_config("conformer").override({
                    "model.vocab_size": 64,
                    "model.compute_dtype": compute_dtype})
                lmodel = build_model(lcfg.model)
                n = C.SAMPLE_RATE * secs
                rng = np.random.default_rng(0)
                sig = rng.uniform(-0.3, 0.3, (B_lf, n)).astype(np.float32)
                slens = np.full(B_lf, n, np.int64)
                slens[0] = int(n * 0.8)            # one shorter row
                feats, flens = batch_features(jnp.asarray(sig),
                                              jnp.asarray(slens))
                lst = init_state(lmodel, lcfg.optim, jax.random.key(0),
                                 feats, flens)
                fwd = jax.jit(lmodel.apply)
                logits, olens = fwd(lst.params, feats, flens)
                logits = jax.block_until_ready(logits)
                hyps = beam_decode(logits, olens, beam=beam)  # compile
                t0 = time.perf_counter()
                for _ in range(iters):
                    logits, olens = fwd(lst.params, feats, flens)
                    hyps = beam_decode(logits, olens, beam=beam)
                dt = time.perf_counter() - t0
                audio = float(np.sum(slens)) / C.SAMPLE_RATE * iters
                return {"longform_e2e_secs_per_utt": secs,
                        "longform_e2e_utt_per_sec": round(
                            B_lf * iters / dt, 2),
                        "longform_e2e_rtf": round(audio / dt, 1)}
            r = section("longform_e2e", _longform_e2e)
            if r is not None:
                extra.update(r)
        # chunk-causal attention serving figures: the streaming attention family's RT factor, greedy and beam+LM
        if args.preset != "conformer_stream":
            r = section("streaming_attn_greedy",
                        lambda: bench_streaming(preset="conformer_stream"))
            if r is not None:
                extra["conformer_stream_rt_factor_16"] = round(r, 1)
            r = section("streaming_attn_beam",
                        lambda: bench_streaming(preset="conformer_stream",
                                                decoder="beam"))
            if r is not None:
                extra["conformer_stream_beam_lm_rt_factor_16"] = round(r, 1)

    if not args.no_from_disk and args.backend == "gpu":
        fd_pair = section("from_disk", lambda: _bench_from_disk(
            preset_config(args.preset).override(
                {"model.compute_dtype": compute_dtype}), args, n_chips))
        if fd_pair is not None:
            fd, fd_ctx = fd_pair
            extra.update(fd)
            # the headline is the SUSTAINED end-to-end rate on an on-disk
            # corpus (device cache + K-step dispatches): what users get,
            # including all host work — not a device-resident microbench
            headline = fd["from_disk_utt_per_sec_per_chip"]
            # re-derive arithmetic-efficiency numbers at the headline rate
            fps = F.train_flops_per_utt(cfg.model, args.frames) * headline
            extra["model_tflops_per_sec"] = round(fps / 1e12, 2)
            m2 = F.mfu(fps, kind)
            extra["mfu"] = round(m2, 4) if m2 is not None else None
            # PRELIMINARY line: consumers read the LAST stdout line — if a
            # harness timeout kills the slower extras below (rotating
            # bench, per-preset matrix), the headline still lands
            print(result_line(), flush=True)

            rot = section("rotating",
                          lambda: _bench_rotating(fd_ctx, args, n_chips))
            if rot is not None:
                extra.update(rot)

    # per-preset matrix: the flagship + conv + attention presets, not just
    # the headline one
    if args.backend == "gpu" and not args.no_presets:
        # the headline preset's row only exists if its section actually
        # measured — a 0.0 placeholder would be indistinguishable from a
        # real data point in the driver record
        presets_extra = {}
        if dr is not None:
            presets_extra[args.preset] = {
                "train_utt_per_sec": round(ups_per_chip, 1),
                "train_device_utt_per_sec": round(dev_ups, 1),
                "decode_utt_per_sec": round(decode_ups, 1),
                "mfu": round(mfu, 4) if mfu is not None else None,
                "mfu_device": extra.get("mfu_device")}
        for pname in ("bigru", "bilstm_deep", "glu_conv", "conformer",
                      "conformer_stream"):
            if pname == args.preset:
                continue
            pcfg = preset_config(pname).override({
                "model.vocab_size": 64,
                "model.compute_dtype": compute_dtype})
            r = section(
                f"preset_{pname}",
                lambda pcfg=pcfg: bench_device_resident(
                    pcfg, build_model(pcfg.model)))
            if r is not None:
                pdev_mfu = F.mfu(
                    F.train_flops_per_utt(pcfg.model, args.frames) * r[1],
                    kind)
                presets_extra[pname] = {
                    "train_utt_per_sec": round(r[0], 1),
                    "train_device_utt_per_sec": round(r[1], 1),
                    "decode_utt_per_sec": round(r[2], 1),
                    "mfu": round(r[3], 4) if r[3] is not None else None,
                    "mfu_device": (round(pdev_mfu, 4)
                                   if pdev_mfu is not None else None)}
        extra["presets"] = presets_extra

    # multi-GB rotating demonstration LAST (it is the slowest section —
    # ~4.3 GB corpus build on first run + 2 full timed epochs); a line
    # with everything above is already on stdout if a timeout lands here
    if args.backend == "gpu" and not args.no_from_disk \
            and not args.no_csj_scale:
        print(result_line(), flush=True)
        cs = section("csj_scale",
                     lambda: _bench_csj_scale(args, n_chips, compute_dtype))
        if cs is not None:
            extra.update(cs)

    print(result_line())
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SystemExit, KeyboardInterrupt):
        # a Ctrl-C / exit must NOT be rewritten into a fake
        # 0.0 "measurement" as the last stdout line (the driver parses
        # exactly that line); an abort propagates untouched — any earlier
        # PRELIMINARY result line remains the record
        raise
    except Exception:      # last-ditch: the driver parses the LAST line —
        import traceback   # even a crash outside every section must leave
        tb = traceback.format_exc().strip().splitlines()  # valid JSON there
        print(json.dumps({
            "metric": "train_utterances_per_sec_per_chip", "value": 0.0,
            "unit": "utt/s/chip",
            "extra": {"errors": {"main": " | ".join(
                ln.strip() for ln in tb[-3:])}}}))
        sys.exit(1)
