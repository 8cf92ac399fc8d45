"""Decode CLI: checkpoint + wav file(s) → text (SURVEY.md §3.5).

Greedy by default; ``--beam K`` switches to prefix beam search, and
``--lm``/``--lm-alpha``/``--lm-beta`` enable n-gram LM shallow fusion
(config 4, BASELINE.json:10).
"""

from __future__ import annotations

import argparse
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..decode.greedy import greedy_decode
from ..frontend.jnp_frontend import batch_features
from ..utils.wav import read_wav
from ..utils.runtime import enable_compilation_cache
from ..vocab import Vocab
from .evaluate import load_model_and_params


def main(argv=None):
    enable_compilation_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--average-last", type=int, default=1,
                   help="average the parameters of the last N kept "
                        "checkpoints (eval-time checkpoint averaging)")
    p.add_argument("--vocab", required=True, help="vocab.txt path")
    p.add_argument("--beam", type=int, default=0,
                   help="beam width (0 = greedy)")
    p.add_argument("--lm", default=None, help="ARPA n-gram LM for fusion")
    p.add_argument("--lm-alpha", type=float, default=0.5)
    p.add_argument("--lm-beta", type=float, default=1.0)
    p.add_argument("--lm-repr", default="auto",
                   choices=("auto", "dense", "hashed"),
                   help="device LM representation: dense table, sparse "
                        "hashed (scales to order>=4 / large V), or auto "
                        "by table size")
    p.add_argument("--nbest", type=int, default=1,
                   help="with --beam: print the top-N hypotheses per wav "
                        "(tab-separated: path, rank, log-score, text)")
    p.add_argument("--batch", type=int, default=32,
                   help="wavs per device batch: long wav lists are decoded "
                        "in length-sorted chunks (bounded memory + padding "
                        "waste) and printed in input order")
    p.add_argument("--wav-list", default=None,
                   help="file with one wav path per line (for corpora past "
                        "the shell's argv limit); combines with positional "
                        "wavs")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted eval-time config overrides (same rules as "
                        "evaluate --set: deployment knobs; model.* is "
                        "rejected)")
    p.add_argument("wavs", nargs="*")
    args = p.parse_args(argv)

    if args.wav_list:
        with open(args.wav_list, encoding="utf-8") as f:
            args.wavs += [l.strip() for l in f if l.strip()]
    if not args.wavs:
        raise SystemExit("no wavs given (positional or --wav-list)")
    if args.batch <= 0:
        raise SystemExit("--batch must be >= 1")
    # --nbest only has meaning on the beam path (ADVICE r2): fail loudly
    # instead of silently printing greedy 1-best
    if args.nbest > 1 and args.beam <= 0:
        raise SystemExit("--nbest requires --beam K")
    if args.lm and args.beam <= 0:
        raise SystemExit("--lm requires --beam K (greedy decode cannot "
                         "apply LM fusion)")
    if args.beam > 0 and args.nbest > args.beam:
        print(f"warning: --nbest {args.nbest} clamped to beam width "
              f"{args.beam}", file=sys.stderr)   # stdout is the result TSV

    import json as _json
    overrides = {}
    for kv in args.set:
        key, _, val = kv.partition("=")
        try:
            overrides[key] = _json.loads(val)
        except _json.JSONDecodeError:
            overrides[key] = val
    cfg, model, state, _ = load_model_and_params(args.ckpt_dir,
                                               args.average_last,
                                               overrides=overrides)
    vocab = Vocab.load(args.vocab)
    if len(vocab) != cfg.model.vocab_size:
        raise SystemExit(
            f"vocab has {len(vocab)} symbols but the checkpoint was trained "
            f"with model.vocab_size={cfg.model.vocab_size} — wrong vocab "
            "file for this checkpoint (decodes would be silently garbled)")

    lm = None
    if args.lm:
        from ..decode.lm import NGramLM, device_lm
        lm = device_lm(NGramLM.from_arpa(args.lm, vocab), args.lm_repr)

    # bounded memory: only HEADER lengths are read upfront (at the
    # contract rate, matching read_wav's resampler); PCM is read
    # per-chunk inside acoustic(), so a 100k-wav list never holds more
    # than one chunk of signals in host RAM.
    def header_len(path):
        with wave.open(path, "rb") as w:
            return int(round(w.getnframes() * C.SAMPLE_RATE
                             / w.getframerate()))

    wav_lens = [header_len(w) for w in args.wavs]
    B = len(wav_lens)
    # long wav lists decode in length-sorted fixed-size chunks: bounded
    # memory, bounded padding waste, and signal lengths quantized to 1 s
    # so a 10k-wav corpus costs a handful of XLA compiles, not thousands.
    # A single sub-batch invocation keeps its exact shape (no quantizing).
    multi = B > args.batch
    bs = args.batch if multi else B
    order = sorted(range(B), key=lambda i: wav_lens[i]) if multi \
        else list(range(B))
    results: list = [None] * B

    chunks = [order[start : start + bs] for start in range(0, B, bs)]
    # ONE compiled forward per padded shape (a handful thanks to the 1 s
    # quantization) — an unjitted model.apply would dispatch the model
    # body op-by-op per chunk, each dispatch a host round-trip
    forward = jax.jit(model.apply)

    def acoustic(chunk):
        """chunk of wav indices → (logits, olens); async-dispatched, so
        the streamed beam path below keeps several chunks in flight."""
        pad = bs - len(chunk)
        rows = chunk + [chunk[0]] * pad          # static batch shape
        n_max = max(wav_lens[i] for i in chunk)
        if multi:
            n_max = -(-n_max // C.SAMPLE_RATE) * C.SAMPLE_RATE
        signals = np.zeros((bs, n_max), np.float32)
        lens = np.zeros(bs, np.int32)
        cache: dict = {}                          # pad rows reuse chunk[0]
        for r, i in enumerate(rows):
            sig = cache.get(i)
            if sig is None:
                cache[i] = sig = read_wav(args.wavs[i])
            signals[r, : len(sig)] = sig
            lens[r] = len(sig)
        # same front-end implementation the checkpoint was trained with
        feats, flens = batch_features(
            jnp.asarray(signals), jnp.asarray(lens),
            apply_cmvn=cfg.features.cmvn_arg)
        return forward(state.params, feats, flens)

    if args.beam > 0 and args.nbest > 1:
        from ..decode.beam import beam_decode_nbest
        n = min(args.nbest, args.beam)
        for chunk in chunks:
            logits, olens = acoustic(chunk)
            pfx, plen, scores = beam_decode_nbest(
                logits, olens, beam=args.beam, lm=lm,
                alpha=args.lm_alpha, beta=args.lm_beta)
            for r, i in enumerate(chunk):
                results[i] = [(k + 1, float(scores[r, k]),
                               vocab.decode(pfx[r, k, : plen[r, k]]))
                              for k in range(n)]
    elif args.beam > 0:
        # streamed 1-best: the grouped-pull bulk path — device→host pull
        # latency amortizes over flush_every chunks instead of one sync
        # pull per chunk (see decode/beam.py beam_decode_stream)
        from ..decode.beam import beam_decode_stream
        stream = beam_decode_stream(
            (acoustic(c) for c in chunks), beam=args.beam, lm=lm,
            alpha=args.lm_alpha, beta=args.lm_beta)
        for chunk, hyps in zip(chunks, stream):
            for r, i in enumerate(chunk):
                results[i] = vocab.decode(hyps[r])
    else:
        for chunk in chunks:
            logits, olens = acoustic(chunk)
            ids, out_lens = greedy_decode(logits, olens)
            ids, out_lens = np.asarray(ids), np.asarray(out_lens)
            for r, i in enumerate(chunk):
                results[i] = vocab.decode(ids[r, : out_lens[r]])

    for w, res in zip(args.wavs, results):       # input order
        if isinstance(res, list):
            for rank, score, text in res:
                print(f"{w}\t{rank}\t{score:.3f}\t{text}")
        else:
            print(f"{w}\t{res}")


if __name__ == "__main__":
    main()
