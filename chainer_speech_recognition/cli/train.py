"""Train CLI (SURVEY.md §2.6 "Train driver" / §3.2).

Example:
  python -m chainer_speech_recognition.cli.train \\
      --data-dir prep_out --preset bigru \\
      --set train.total_steps=20000 parallel.num_devices=4
"""

from __future__ import annotations

import argparse
import os

from ..data.corpus import load_index
from ..train.loop import train
from ..utils.runtime import enable_compilation_cache
from ..vocab import Vocab
from .common import add_config_args, load_config


def main(argv=None):
    enable_compilation_cache()
    p = argparse.ArgumentParser(description=__doc__)
    add_config_args(p)
    p.add_argument("--data-dir", required=True,
                   help="preprocess output dir (indexes + vocab.txt)")
    p.add_argument("--ckpt-dir", default=None, help="override checkpoint dir")
    p.add_argument("--metrics", default=None, help="metrics JSONL path")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--debug-nans", action="store_true",
                   help="enable jax_debug_nans (numeric sanitizer, §5.2)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace of steps 10-14 (§5.1)")
    args = p.parse_args(argv)

    if args.debug_nans:
        import jax
        jax.config.update("jax_debug_nans", True)

    cfg = load_config(args)
    vocab = Vocab.load(os.path.join(args.data_dir, "vocab.txt"))
    cfg = cfg.override({"model.vocab_size": len(vocab)})
    if args.ckpt_dir:
        cfg = cfg.override({"train.checkpoint_dir": args.ckpt_dir})

    loader = None
    pack_prefix = os.path.join(args.data_dir, "train")
    if os.path.exists(pack_prefix + ".pack"):
        # packed binary corpus (preprocess --pack): memmap loader, int16 wire
        from ..data.packed import PackedBatchLoader, PackedCorpus

        packed = PackedCorpus(pack_prefix)
        train_utts = packed.utterances()
        loader = PackedBatchLoader(packed, cfg.buckets)
    else:
        train_utts = load_index(
            os.path.join(args.data_dir, "train_index.jsonl"))
    dev_path = os.path.join(args.data_dir, "dev_index.jsonl")
    dev_utts = load_index(dev_path) if os.path.exists(dev_path) else None

    train(cfg, train_utts, vocab, dev_utts=dev_utts,
          metrics_path=args.metrics, resume=not args.no_resume,
          profile_dir=args.profile_dir, loader=loader)


if __name__ == "__main__":
    main()
