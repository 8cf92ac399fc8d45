#!/usr/bin/env python
"""Bring-up check: the whole system on one GPU, in ONE process.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --chips 4    # four GPUs: the data-parallel step only

Phases (one card), each through the entry points a user calls — every CLI
runs through its ``main(argv)`` in this process, so only one JAX process
ever opens the card:

1. device     — JAX's devices and the card's name and power limit
                (nvidia-smi, in a child process that stays off JAX); a
                platform other than ``gpu`` is an error, with no fallback.
2. corpus     — ``cli.make_synthetic`` (5-15 s utterances, so the 1024- and
                1536-frame buckets fill), ``cli.preprocess --pack``,
                ``cli.train_lm --order 3``.
3. train      — ``cli.train --preset bilstm_deep`` at preset widths and the
                default bucket menu through the device-cache path, a saved
                checkpoint, then a resume for 2 more steps.
4. decode     — ``cli.evaluate --compare --beam 8 --lm``, ``cli.decode`` on
                two wavs, ``cli.stream --partials`` with a ``uni_gru`` and a
                ``conformer_stream`` checkpoint.
5. presets    — one jitted train step and one eval forward for every other
                preset at preset widths.
6. references — bf16 train-step loss vs a float32 HIGHEST-precision forward;
                the device front-end vs the NumPy golden one; device greedy
                and beam vs the host decoders; the Triton CTC kernel vs the
                ``lax.scan`` CTC, alone and inside the train step (timed).
7. memory     — the train step's ``memory_analysis()`` and peak bytes.

Every phase that fails makes the script exit non-zero. The last stdout line
is the JSON object ``{"ok": true, "device": {...}}`` and nothing else.
Times printed here are bring-up readings (compile included where noted),
not benchmark results.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def say(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


@dataclasses.dataclass
class Scale:
    """How big each phase runs. The defaults are the real (preset) sizes;
    tests build a tiny one to run the phase functions on the CPU."""

    utts: int = 160                  # synthetic corpus size
    min_seconds: float = 5.0
    max_seconds: float = 15.0
    vocab: int = 82
    labels: tuple[int, int] = (20, 60)  # label count range per utterance
    train_steps: int = 20            # first run; the resume adds 2
    steps_per_dispatch: int = 2
    sets: tuple[str, ...] = ()       # extra --set overrides for every CLI
    model_over: dict = dataclasses.field(default_factory=dict)
                                     # smaller widths/depths (tests); each
                                     # applies only to presets that use it
    stream_steps: int = 2
    batch: int = 16                  # synthetic batches (presets, refs)
    frames: int = 1024
    ctc_shape: tuple[int, int, int, int] = (24, 256, 84, 128)  # B,T,V,L
    beam_rows: int = 4
    timed_steps: int = 10
    interpret: bool = False          # Pallas interpreter (CPU tests only)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def gpu_name_and_power_limit() -> str:
    """What ``nvidia-smi --query-gpu=name,power.limit`` prints, or "" ."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip()


@contextlib.contextmanager
def timed(name: str, times: dict):
    t0 = time.perf_counter()
    yield
    times[name] = time.perf_counter() - t0
    say(f"phase {name}: {times[name]:.1f} s (compile included)")


def run_cli(main, argv: list[str]) -> str:
    """Run one CLI ``main(argv)`` in this process; echo and return stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"    {line}", flush=True)
    if rc not in (None, 0):
        raise RuntimeError(f"{main.__module__} exited {rc}")
    return out


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    say(f"ok: {what}")


def _model_over(preset: str, scale: Scale) -> dict:
    """``scale.model_over`` restricted to the stacks ``preset`` has."""
    from chainer_speech_recognition.config import preset_config

    m = preset_config(preset).model
    uses = {"rnn": m.rnn_type != "none", "glu": m.glu_blocks > 0,
            "attn": m.attn_blocks > 0}
    return {f"model.{k}": v for k, v in scale.model_over.items()
            if uses.get(k.split("_")[0], True)}


def _model_cfg(preset: str, scale: Scale, vocab_size: int, **over):
    from chainer_speech_recognition.config import preset_config

    cfg = preset_config(preset).override({"model.vocab_size": vocab_size})
    return cfg.override({"parallel.num_devices": 1,
                         **_model_over(preset, scale), **over})


def _synthetic_batch(scale: Scale, vocab_size: int, seed: int = 0) -> dict:
    """Padded bucket batch: utterances of 60-100 % of ``scale.frames``."""
    import numpy as np

    from chainer_speech_recognition import constants as C
    from chainer_speech_recognition.data.synthetic import make_batch

    n = (scale.frames - 1) * C.HOP_LENGTH
    b = make_batch(np.random.default_rng(seed), batch_size=scale.batch,
                   vocab_size=vocab_size, min_len=8, max_len=24,
                   tone_len=n // 24, max_label_len=32)
    sig = np.zeros((scale.batch, n), np.float32)
    m = min(n, b["signals"].shape[1])
    sig[:, :m] = b["signals"][:, :m]
    return {"signals": sig, "num_samples": np.minimum(b["num_samples"], n),
            "labels": b["labels"], "label_lengths": b["label_lengths"]}


def _init(model, cfg, batch, seed=0):
    import jax
    import jax.numpy as jnp

    from chainer_speech_recognition.frontend.jnp_frontend import (
        batch_features)
    from chainer_speech_recognition.train.state import init_state

    feats, flens = batch_features(jnp.asarray(batch["signals"][:1]),
                                  jnp.asarray(batch["num_samples"][:1]))
    return init_state(model, cfg.optim, jax.random.key(seed), feats, flens)


def _time_steps(step, state, batch, n: int):
    """(state, seconds per step) over n steps ending in block_until_ready,
    after two untimed steps (the donated state's layout settles on the
    second call, which can compile once more)."""
    import jax

    for _ in range(2):
        state, m = step(state, batch)
    jax.block_until_ready((state, m))
    t0 = time.perf_counter()
    for _ in range(n):
        state, m = step(state, batch)
    jax.block_until_ready((state, m))
    return state, (time.perf_counter() - t0) / n


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(count: int) -> dict:
    import jax

    devs = jax.devices()
    say(f"jax {jax.__version__} devices: {devs}")
    d = devs[0]
    info = {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}
    say(f"device_kind: {d.device_kind}")
    say(f"nvidia-smi name, power.limit: {gpu_name_and_power_limit()}")
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {d.platform}")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found {len(devs)}")
    from chainer_speech_recognition.utils.runtime import (
        enable_compilation_cache)
    say(f"compile cache: {enable_compilation_cache()}")
    return info


def phase_corpus(work: str, scale: Scale) -> dict:
    from chainer_speech_recognition.cli import make_synthetic, preprocess
    from chainer_speech_recognition.cli import train_lm

    corpus, data = os.path.join(work, "corpus"), os.path.join(work, "data")
    arpa = os.path.join(work, "lm3.arpa")
    run_cli(make_synthetic.main, [
        "--out", corpus, "--utts", str(scale.utts), "--vocab",
        str(scale.vocab), "--min-seconds", str(scale.min_seconds),
        "--max-seconds", str(scale.max_seconds),
        "--min-labels", str(scale.labels[0]),
        "--max-labels", str(scale.labels[1])])
    run_cli(preprocess.main, ["--corpus", corpus, "--out", data,
                              "--dev-fraction", "0.1", "--pack", "--stats"])
    run_cli(train_lm.main, ["--data-dir", data, "--order", "3",
                            "--out", arpa])
    wavs = sorted(os.path.join(corpus, f) for f in os.listdir(corpus)
                  if f.endswith(".wav"))
    check(os.path.exists(os.path.join(data, "train.pack")),
          "packed corpus written")
    check(os.path.getsize(arpa) > 0, "order-3 ARPA LM written")
    return {"corpus": corpus, "data": data, "arpa": arpa, "wavs": wavs,
            "vocab": os.path.join(data, "vocab.txt")}


def _read_metrics(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _train_sets(preset: str, scale: Scale, total: int) -> list[str]:
    sets = [f"train.total_steps={total}",
            f"train.steps_per_dispatch={scale.steps_per_dispatch}",
            f"train.log_every={scale.steps_per_dispatch}",
            "train.eval_every=1000000", "train.checkpoint_every=1000000"]
    sets += [f"{k}={json.dumps(v)}"
             for k, v in _model_over(preset, scale).items()]
    return sets + list(scale.sets)


def phase_train(paths: dict, work: str, scale: Scale,
                preset: str = "bilstm_deep") -> str:
    from chainer_speech_recognition.cli import train as train_cli

    ckpt = os.path.join(work, f"ckpt_{preset}")
    m1, m2 = (os.path.join(work, f"{preset}_{i}.jsonl") for i in (1, 2))
    n1 = scale.train_steps
    run_cli(train_cli.main, ["--data-dir", paths["data"], "--preset", preset,
                             "--ckpt-dir", ckpt, "--metrics", m1,
                             "--set", *_train_sets(preset, scale, n1)])
    first = _read_metrics(m1)
    mode = [r for r in first if r["kind"] == "data_mode"][0]
    say(f"data mode: {mode}")
    for r in first:
        if r["kind"] == "compile":
            say(f"train step compile, bucket {r['bucket_id']}: "
                f"{r['seconds']} s")
    check(mode["mode"] == "device_cache", "default device-cache path taken")
    losses = [(r["step"], r["loss"], r["bucket_id"]) for r in first
              if r["kind"] == "train"]
    check(losses and losses[-1][0] >= n1, f"{losses[-1][0]} steps trained")
    check(all(abs(lo) < 1e30 for _, lo, _ in losses),
          "training losses finite")

    n2 = n1 + 2
    run_cli(train_cli.main, ["--data-dir", paths["data"], "--preset", preset,
                             "--ckpt-dir", ckpt, "--metrics", m2,
                             "--set", *_train_sets(preset, scale, n2)])
    second = _read_metrics(m2)
    resume = [r for r in second if r["kind"] == "resume"]
    check(bool(resume) and resume[0]["step"] == losses[-1][0],
          f"resumed at step {resume[0]['step'] if resume else None}")
    more = [(r["step"], r["loss"], r["bucket_id"]) for r in second
            if r["kind"] == "train"]
    check(bool(more) and more[-1][0] == n2, f"step counter continued to {n2}")
    # CTC loss is a sum over frames, so compare with the same bucket's
    # losses before the resume (all buckets if it had none)
    step, loss, bucket = more[-1]
    prev = [lo for _, lo, b in losses if b == bucket] or \
        [lo for _, lo, _ in losses]
    lo, hi = min(prev) / 2, max(prev) * 2
    check(lo <= loss <= hi,
          f"loss continues: {loss:.3f} at step {step} (bucket {bucket}) vs "
          f"{[round(x, 3) for x in prev]} before the resume on that bucket "
          f"(accepted range [{lo:.3f}, {hi:.3f}])")
    return ckpt


def phase_decode(paths: dict, ckpt: str) -> None:
    from chainer_speech_recognition.cli import decode as decode_cli
    from chainer_speech_recognition.cli import evaluate as evaluate_cli

    out = run_cli(evaluate_cli.main, [
        "--ckpt-dir", ckpt, "--data-dir", paths["data"], "--compare",
        "--beam", "8", "--lm", paths["arpa"]])
    cers = dict(re.findall(r"CER\[(\S+)\] (\S+)", out))
    check(set(cers) == {"greedy", "beam8", "beam8+lm"},
          f"evaluate --compare scored {sorted(cers)}")
    check(all(0.0 <= float(v) < 10.0 for v in cers.values()),
          f"CERs finite: {cers}")
    wavs = paths["wavs"][:2]
    out = run_cli(decode_cli.main, ["--ckpt-dir", ckpt, "--vocab",
                                    paths["vocab"], *wavs])
    check(all(any(line.startswith(w + "\t") for line in out.splitlines())
              for w in wavs), "decode transcribed both wavs")


def phase_stream(paths: dict, work: str, scale: Scale, preset: str) -> None:
    from chainer_speech_recognition.cli import stream as stream_cli
    from chainer_speech_recognition.cli import train as train_cli

    ckpt = os.path.join(work, f"ckpt_{preset}")
    # a few steps fed batch by batch: no device cache to build for them
    run_cli(train_cli.main, ["--data-dir", paths["data"], "--preset", preset,
                             "--ckpt-dir", ckpt, "--set",
                             *_train_sets(preset, scale, scale.stream_steps),
                             "train.data_mode=stream"])
    wav = paths["wavs"][0]
    out = run_cli(stream_cli.main, ["--ckpt-dir", ckpt, "--vocab",
                                    paths["vocab"], "--partials", wav])
    check(any(wav in line for line in out.splitlines()),
          f"stream --partials ({preset}) transcribed {os.path.basename(wav)}")


def phase_presets(presets, scale: Scale, vocab_size: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from chainer_speech_recognition.models.presets import build_model
    from chainer_speech_recognition.parallel.mesh import (
        make_mesh, shard_batch)
    from chainer_speech_recognition.train.step import (
        make_eval_step, make_train_step)

    batch = _synthetic_batch(scale, vocab_size)
    for name in presets:
        cfg = _model_cfg(name, scale, vocab_size)
        model = build_model(cfg.model)
        mesh = make_mesh(cfg.parallel)
        state = _init(model, cfg, batch)
        step = make_train_step(model, cfg, mesh)
        t0 = time.perf_counter()
        state, m = step(state, shard_batch(mesh, batch))
        loss = float(m["loss"])
        t_train = time.perf_counter() - t0
        ev = make_eval_step(model, cfg)
        t0 = time.perf_counter()
        losses, logits, olens = ev(
            state.params, {k: jnp.asarray(v) for k, v in batch.items()})
        logits = np.asarray(logits)
        t_eval = time.perf_counter() - t0
        check(np.isfinite(loss) and np.isfinite(logits).all()
              and logits.shape[0] == scale.batch,
              f"{name}: train step loss {loss:.3f} ({t_train:.1f} s with "
              f"compile), eval logits {logits.shape} ({t_eval:.1f} s with "
              "compile)")
        del state, step
        jax.clear_caches()


def phase_loss_reference(preset: str, scale: Scale, vocab_size: int,
                         rtol: float = 1e-2) -> None:
    """bf16 train-step loss vs a float32 forward at HIGHEST precision on
    the same batch and parameters (SpecAugment off so both see the same
    features; the reference uses the lax.scan CTC)."""
    import jax
    import jax.numpy as jnp

    from chainer_speech_recognition.models.presets import build_model
    from chainer_speech_recognition.parallel.mesh import (
        make_mesh, shard_batch)
    from chainer_speech_recognition.train.step import (
        _forward_loss, make_train_step)

    batch = _synthetic_batch(scale, vocab_size, seed=1)
    cfg = _model_cfg(preset, scale, vocab_size,
                     **{"specaugment.enabled": False})
    model = build_model(cfg.model)
    mesh = make_mesh(cfg.parallel)
    state = _init(model, cfg, batch)
    params = jax.tree.map(jnp.copy, state.params)
    _, m = make_train_step(model, cfg, mesh)(state, shard_batch(mesh, batch))
    got = float(m["loss"])
    cfg32 = cfg.override({"model.compute_dtype": "float32",
                          "train.ctc_impl": "jnp"})
    model32 = build_model(cfg32.model)
    dev = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("highest"):
        want = float(jax.jit(lambda p, b: _forward_loss(
            model32, cfg32, p, b, None, train=False)[0])(params, dev))
    rel = abs(got - want) / abs(want)
    check(rel <= rtol,
          f"{preset}: bf16 train-step loss {got:.5f} vs float32 HIGHEST "
          f"{want:.5f}, rel {rel:.2e} <= {rtol:g} (bf16 matmul operands "
          "keep 8 mantissa bits; the CTC sum over ~T' frames averages the "
          "rounding)")


def phase_frontend_reference(paths: dict, n: int = 4,
                             atol: float = 1e-2) -> None:
    """Device front-end vs the NumPy golden one on real utterances."""
    import jax.numpy as jnp
    import numpy as np

    from chainer_speech_recognition.frontend.golden_np import features
    from chainer_speech_recognition.frontend.jnp_frontend import (
        batch_features)
    from chainer_speech_recognition.utils.wav import read_wav

    sigs = [read_wav(w) for w in paths["wavs"][:n]]
    N = max(len(s) for s in sigs)
    pad = np.zeros((len(sigs), N), np.float32)
    for i, s in enumerate(sigs):
        pad[i, :len(s)] = s
    feats, flens = batch_features(jnp.asarray(pad), jnp.asarray(
        [len(s) for s in sigs]), apply_cmvn=True)
    feats, flens = np.asarray(feats), np.asarray(flens)
    err = 0.0
    for i, s in enumerate(sigs):
        gold = features(s, apply_cmvn=True)
        check(gold.shape[0] == flens[i], f"utt {i}: {flens[i]} frames")
        err = max(err, float(np.abs(feats[i, :flens[i]] - gold).max()))
    check(err <= atol,
          f"front-end vs golden_np max-abs {err:.3e} <= {atol:g} "
          "(fp32 cuFFT + HIGHEST mel matmul; log + CMVN amplify near-silent "
          "mel bins)")


def phase_decoder_reference(ckpt: str, paths: dict, scale: Scale) -> None:
    """Device greedy and beam on real logits vs the host decoders: exact."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from chainer_speech_recognition.cli.evaluate import load_model_and_params
    from chainer_speech_recognition.decode.beam import (
        beam_decode, beam_decode_reference)
    from chainer_speech_recognition.decode.greedy import (
        greedy_decode, greedy_decode_np)
    from chainer_speech_recognition.frontend.jnp_frontend import (
        batch_features)
    from chainer_speech_recognition.utils.wav import read_wav

    cfg, model, state, _ = load_model_and_params(ckpt)
    params = state.params
    sigs = [read_wav(w) for w in paths["wavs"][:scale.beam_rows]]
    N = max(len(s) for s in sigs)
    pad = np.zeros((len(sigs), N), np.float32)
    for i, s in enumerate(sigs):
        pad[i, :len(s)] = s
    feats, flens = batch_features(jnp.asarray(pad), jnp.asarray(
        [len(s) for s in sigs]), apply_cmvn=cfg.features.cmvn_arg)
    logits, olens = model.apply(params, feats, flens)
    ids, lens = greedy_decode(logits, olens)
    ids, lens, lg = np.asarray(ids), np.asarray(lens), np.asarray(logits)
    ol = np.asarray(olens)
    same = all(list(ids[b, :lens[b]]) == greedy_decode_np(lg[b], ol[b])
               for b in range(len(sigs)))
    check(same, f"device greedy == host greedy on {len(sigs)} utterances")
    # the few-step model's logits give short hypotheses, so add rows of
    # peaked logits around a random path (long ones) at the same width
    rng = np.random.default_rng(5)
    B, T, V = scale.beam_rows, min(160, lg.shape[1]), lg.shape[2]
    peaked = rng.standard_normal((B, T, V)).astype(np.float32)
    path = rng.integers(0, V, (B, T))
    np.put_along_axis(peaked, path[..., None], 6.0, axis=2)
    for name, x, n in (("model", logits, ol),
                       ("peaked", jnp.asarray(peaked), np.full(B, T))):
        hyps = beam_decode(x, jnp.asarray(n), beam=8)
        lp = np.asarray(jax.nn.log_softmax(x, axis=-1))
        ref = [beam_decode_reference(lp[b], n[b], beam=8)
               for b in range(len(n))]
        check([list(map(int, h)) for h in hyps] == ref,
              f"device beam8 == host beam8 on {len(n)} {name} rows "
              f"(hypothesis lengths {[len(r) for r in ref]})")


def phase_ctc_kernel(scale: Scale, rtol: float = 1e-4, atol_grad: float = 1e-4,
                     gold_rows: int = 3) -> dict:
    """The Triton CTC kernel vs the lax.scan CTC at a real width: loss
    against the scan, gradient against the float64 golden oracle next to
    the scan's own error; then both timed forward+backward."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from chainer_speech_recognition.ops.ctc_jax import ctc_loss
    from chainer_speech_recognition.ops.ctc_numpy import ctc_loss_batch_np
    from chainer_speech_recognition.ops.ctc_pallas import (
        ctc_loss_pallas, padded_states)

    B, T, V, L = scale.ctc_shape
    rng = np.random.default_rng(3)
    logits_np = (rng.standard_normal((B, T, V)) * 2).astype(np.float32)
    logits = jnp.asarray(logits_np)
    tl = rng.integers(T // 2, T + 1, B)
    tl[0] = T
    ll = rng.integers(1, min(L, T // 2 - 1) + 1, B)
    ll[0] = min(L, T // 2 - 1)
    labels_np = rng.integers(1, V, (B, L))
    args = (jnp.asarray(tl, jnp.int32), jnp.asarray(labels_np, jnp.int32),
            jnp.asarray(ll, jnp.int32))
    kern = jax.jit(jax.value_and_grad(lambda x: jnp.sum(ctc_loss_pallas(
        x, *args, interpret=scale.interpret))))
    scan = jax.jit(jax.value_and_grad(lambda x: jnp.sum(ctc_loss(x, *args))))
    lk = np.asarray(ctc_loss_pallas(logits, *args, interpret=scale.interpret))
    lj = np.asarray(ctc_loss(logits, *args))
    gk, gj = np.asarray(kern(logits)[1]), np.asarray(scan(logits)[1])
    r = min(gold_rows, B)
    _, gg = ctc_loss_batch_np(logits_np[:r], tl[:r], labels_np[:r], ll[:r])
    err_l = float(np.max(np.abs(lk - lj) / np.abs(lj)))
    err_k = float(np.abs(gk[:r] - gg).max())
    err_s = float(np.abs(gj[:r] - gg).max())
    tol_g = max(atol_grad, 2 * err_s)
    S = 2 * L + 1
    say(f"CTC at B={B} T={T} V={V} S={S} (row {padded_states(S)}): kernel "
        f"vs scan loss rel {err_l:.2e}, grad max-abs "
        f"{float(np.abs(gk - gj).max()):.2e}; vs float64 golden on {r} "
        f"rows: kernel grad {err_k:.2e}, scan grad {err_s:.2e}")
    check(err_l <= rtol and err_k <= tol_g,
          f"CTC kernel: loss rel {err_l:.2e} <= {rtol:g} vs the scan; grad "
          f"max-abs {err_k:.2e} vs golden <= {tol_g:.2e} = max({atol_grad:g},"
          " 2 x the scan's own error) (both fp32: α+β-logP cancels at "
          "|logP| ~ 1e3, where one fp32 ulp is ~1e-4)")
    times = {}
    for name, fn in (("scan", scan), ("kernel", kern), ("kernel2", kern),
                     ("scan2", scan)):
        jax.block_until_ready(fn(logits))
        t0 = time.perf_counter()
        for _ in range(scale.timed_steps):
            out = fn(logits)
        jax.block_until_ready(out)
        times[name] = (time.perf_counter() - t0) / scale.timed_steps
    say(f"CTC fwd+bwd alone, ms per call (scan, kernel, kernel, scan): "
        f"{times['scan'] * 1e3:.3f} {times['kernel'] * 1e3:.3f} "
        f"{times['kernel2'] * 1e3:.3f} {times['scan2'] * 1e3:.3f}")
    return times


def phase_ctc_train_step(preset: str, scale: Scale, vocab_size: int) -> dict:
    """One preset's train step with the CTC kernel vs with the scan, timed
    in turns (scan, kernel, kernel, scan) on one batch; plus the step's
    memory analysis and peak device memory."""
    import jax

    from chainer_speech_recognition.models.presets import build_model
    from chainer_speech_recognition.parallel.mesh import (
        make_mesh, shard_batch)
    from chainer_speech_recognition.train.step import make_train_step

    batch = _synthetic_batch(scale, vocab_size, seed=2)
    out = {}
    steps, states = {}, {}
    for impl in ("jnp", "pallas"):
        cfg = _model_cfg(preset, scale, vocab_size,
                         **{"train.ctc_impl": impl})
        model = build_model(cfg.model)
        mesh = make_mesh(cfg.parallel)
        sb = shard_batch(mesh, batch)
        state = _init(model, cfg, batch)
        step = make_train_step(model, cfg, mesh)
        if impl == "pallas":
            compiled = step.lower(state, sb).compile()
            say(f"{preset} train step memory_analysis: "
                f"{compiled.memory_analysis()}")
        t0 = time.perf_counter()
        state, m = step(state, sb)
        jax.block_until_ready((state, m))
        say(f"{preset} train step ({impl} CTC) first call "
            f"{time.perf_counter() - t0:.1f} s (compile included)")
        steps[impl], states[impl] = (step, sb), state
    for impl in ("jnp", "pallas", "pallas", "jnp"):
        step, sb = steps[impl]
        states[impl], dt = _time_steps(step, states[impl], sb,
                                       scale.timed_steps)
        out.setdefault(impl, []).append(dt)
    say(f"{preset} B={scale.batch} frames={scale.frames} train step ms "
        f"(scan, kernel, kernel, scan): {out['jnp'][0] * 1e3:.2f} "
        f"{out['pallas'][0] * 1e3:.2f} {out['pallas'][1] * 1e3:.2f} "
        f"{out['jnp'][1] * 1e3:.2f}")
    stats = jax.devices()[0].memory_stats() or {}
    say(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    return out


def phase_dp(n: int, scale: Scale, vocab_size: int = 84,
             rtol_loss: float = 1e-2, rtol_update: float = 5e-2) -> None:
    """bilstm_deep DP train step over an n-device mesh vs the 1-device step
    on the same global batch: both steps' losses, and the parameter
    updates after the second step (SGD, so an update is linear in the
    gradient; warmup 1, so step 1 has lr 0 and step 2 the peak)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from chainer_speech_recognition.models.presets import build_model
    from chainer_speech_recognition.parallel.mesh import (
        make_mesh, shard_batch)
    from chainer_speech_recognition.train.step import make_train_step

    batch = _synthetic_batch(scale, vocab_size, seed=4)
    runs = {}
    for nd in (n, 1):
        cfg = _model_cfg("bilstm_deep", scale, vocab_size, **{
            "parallel.num_devices": nd, "specaugment.enabled": False,
            "optim.optimizer": "sgd", "optim.warmup_steps": 1})
        model = build_model(cfg.model)
        mesh = make_mesh(cfg.parallel)
        say(f"mesh {dict(mesh.shape)} over {mesh.devices.ravel().tolist()}")
        state = _init(model, cfg, batch)
        p0 = jax.tree.map(np.asarray, state.params)
        step = make_train_step(model, cfg, mesh)
        sb = shard_batch(mesh, batch)
        losses = []
        for _ in range(2):
            state, m = step(state, sb)
            losses.append(float(m["loss"]))
        upd = jax.tree.map(lambda a, b: np.asarray(a) - b, state.params, p0)
        runs[nd] = (losses, upd)
        del state, step
    (l_n, u_n), (l_1, u_1) = runs[n], runs[1]
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_n, l_1))
    check(rel <= rtol_loss,
          f"{n}-device vs 1-device loss {l_n} vs {l_1}: rel {rel:.2e} <= "
          f"{rtol_loss:g} (bf16 compute; per-device GEMMs see B/{n} rows "
          "and psum adds in another order)")
    scale_u = max(float(np.abs(u).max()) for u in jax.tree.leaves(u_1))
    diff = max(float(np.abs(a - b).max()) for a, b in
               zip(jax.tree.leaves(u_n), jax.tree.leaves(u_1)))
    check(scale_u > 0 and diff <= rtol_update * scale_u,
          f"parameter updates after step 2 differ by max-abs {diff:.3e} <= "
          f"{rtol_update:g} x max update {scale_u:.3e}")


# ---------------------------------------------------------------------------

OTHER_PRESETS = ("bigru", "glu_conv", "conformer", "conformer_stream",
                 "uni_gru", "tiny_conv")


def run_one_card(work: str, scale: Scale) -> None:
    from chainer_speech_recognition.vocab import Vocab

    times: dict = {}
    with timed("corpus", times):
        paths = phase_corpus(work, scale)
    V = len(Vocab.load(paths["vocab"]))
    with timed("train", times):
        ckpt = phase_train(paths, work, scale)
    with timed("evaluate_decode", times):
        phase_decode(paths, ckpt)
    for preset in ("uni_gru", "conformer_stream"):
        with timed(f"stream_{preset}", times):
            phase_stream(paths, work, scale, preset)
    with timed("presets", times):
        phase_presets(OTHER_PRESETS, scale, V)
    with timed("ref_loss", times):
        for preset in ("bilstm_deep", "conformer"):
            phase_loss_reference(preset, scale, V)
    with timed("ref_frontend", times):
        phase_frontend_reference(paths)
    with timed("ref_decoders", times):
        phase_decoder_reference(ckpt, paths, scale)
    with timed("ctc_kernel", times):
        phase_ctc_kernel(scale)
    with timed("ctc_train_step", times):
        for preset in ("bilstm_deep", "conformer"):
            phase_ctc_train_step(preset, scale, V)
    say("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in times.items()}))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chips", type=int, default=1, choices=(1, 4),
                   help="4: run only the 4-GPU data-parallel step check")
    p.add_argument("--workdir", default=os.path.join(REPO, ".smoke_work"))
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    device = phase_device(args.chips)
    scale = Scale()
    if args.chips > 1:
        phase_dp(args.chips, scale)
    else:
        shutil.rmtree(args.workdir, ignore_errors=True)
        os.makedirs(args.workdir)
        try:
            run_one_card(args.workdir, scale)
        finally:
            shutil.rmtree(args.workdir, ignore_errors=True)
    say(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
