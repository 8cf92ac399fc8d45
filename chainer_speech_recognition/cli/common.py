"""Shared CLI plumbing: config file + dotted overrides (SURVEY.md §5.6)."""

from __future__ import annotations

import argparse
import json

from ..config import Config, preset_config


def add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", help="path to config JSON")
    p.add_argument("--preset", default=None,
                   help="preset config: tiny_conv | bigru | bilstm_deep")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted config overrides, e.g. model.rnn_hidden=512")


def load_config(args) -> Config:
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    elif args.preset:
        cfg = preset_config(args.preset)
    else:
        cfg = Config()
    overrides = {}
    for kv in args.set:
        key, _, val = kv.partition("=")
        try:
            overrides[key] = json.loads(val)
        except json.JSONDecodeError:
            overrides[key] = val
    return cfg.override(overrides) if overrides else cfg
