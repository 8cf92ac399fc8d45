"""Checkpoint / resume: full train-state pytree, atomic, keep-last-N
(SURVEY.md §2.6/§5.4 — replaces Chainer ``save_npz``/``load_npz``).

Format: one ``step_XXXXXXXX.npz`` holding every leaf of the TrainState
pytree under its ``/``-joined tree path (``params/params/conv0/kernel``,
``opt_state/1/0/mu/...``, ``step``, ``rng``), written with numpy only, +
the experiment ``config.json`` frozen beside it, so decode always
reconstructs the exact front-end/model that trained (BASELINE.json:5 "same
feature parameters"). Writes are write-to-temp + rename (atomic on POSIX);
resume is bitwise-exact (tested in tests/test_checkpoint.py).
"""

from __future__ import annotations

import os
import re

import jax
import numpy as np

from ..config import Config
from .state import TrainState

# 8+ digits: step counts past 1e8 widen the zero-padded field; matching
# exactly 8 would silently hide them from latest/prune (review r3)
_CKPT_RE = re.compile(r"^step_(\d{8,})\.npz$")


def save_checkpoint(ckpt_dir: str, state: TrainState, config: Config,
                    keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    if keep < 1:
        # validate BEFORE any I/O: a rejected call must not have already
        # written a checkpoint and overwritten the frozen config
        raise ValueError(f"keep={keep}: must retain at least the checkpoint "
                         "just written ([:-0] would silently disable pruning)")
    state = jax.device_get(state)
    step = int(state.step)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **_flat_leaves(state))
    os.replace(tmp, path)

    # always rewrite atomically: retraining into an existing dir with a
    # different config must not leave a stale frozen config that decode/
    # evaluate would reconstruct the wrong model and front-end from
    cfg_path = os.path.join(ckpt_dir, "config.json")
    tmp = cfg_path + ".tmp"
    with open(tmp, "w") as f:
        f.write(config.to_json())
    os.replace(tmp, cfg_path)

    for old in list_checkpoints(ckpt_dir)[:-keep]:
        os.remove(os.path.join(ckpt_dir, old))
    return path


def list_checkpoints(ckpt_dir: str) -> list[str]:
    if not os.path.isdir(ckpt_dir):
        return []
    # numeric sort on the step field: lexicographic order breaks once
    # digit widths mix (9-digit steps vs the 8-digit zero-padded ones)
    return sorted((f for f in os.listdir(ckpt_dir) if _CKPT_RE.match(f)),
                  key=lambda f: int(_CKPT_RE.match(f).group(1)))


def latest_checkpoint(ckpt_dir: str) -> str | None:
    ckpts = list_checkpoints(ckpt_dir)
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None


def _key(path) -> str:
    """``/``-joined tree path: dict keys, dataclass/namedtuple field names
    and sequence indices."""
    parts = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
        else:
            raise TypeError(f"unsupported tree path entry {k!r}")
    return "/".join(parts)


def _flat_leaves(tree) -> dict:
    return {_key(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, val in flat.items():
        node = out
        *head, last = key.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = val
    return out


def _unnest(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_unnest(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = val
    return out


def _migrate_state_dict(state, target):
    """Forward-migrate old checkpoint layouts into the current pytree.

    Round-4 MHSA fusion: separate ``q``/``k``/``v`` projections became one
    ``qkv`` Dense (kernel [d, 3d] = concat of the three [d, d] kernels on
    the output axis, matching the fused layer's ``[..., :d]`` /
    ``[..., d:2d]`` / ``[..., 2d:]`` slicing; bias likewise). The rule
    applies anywhere in the tree, so optimizer moments (adam mu/nu mirror
    the param structure) migrate too. Unknown mismatches are left intact
    so ``restore_checkpoint`` still fails loudly on genuine corruption."""
    if not isinstance(target, dict) or not isinstance(state, dict):
        return state
    out = dict(state)
    if "qkv" in target and "qkv" not in state \
            and all(k in state for k in ("q", "k", "v")):
        q, k, v = out.pop("q"), out.pop("k"), out.pop("v")
        out["qkv"] = {
            leaf: np.concatenate(
                [np.asarray(q[leaf]), np.asarray(k[leaf]),
                 np.asarray(v[leaf])],
                axis=1 if np.asarray(q[leaf]).ndim == 2 else 0)
            for leaf in q}
    return {key: (_migrate_state_dict(val, target[key])
                  if key in target else val)
            for key, val in out.items()}


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """Restore into a freshly-initialized template state (defines the pytree).

    Old param layouts are migrated forward (``_migrate_state_dict``), so
    checkpoints trained before a compatible refactor keep loading. A leaf
    missing, left over, or of another shape or dtype than the template's
    is an error."""
    with np.load(path) as z:
        raw = {k: z[k] for k in z.files}
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    want = {_key(p): leaf for p, leaf in leaves}
    raw = _unnest(_migrate_state_dict(_nest(raw), _nest(want)))
    if raw.keys() != want.keys():
        raise ValueError(
            f"{path}: checkpoint tree differs from the model's — missing "
            f"{sorted(want.keys() - raw.keys())[:5]}, unexpected "
            f"{sorted(raw.keys() - want.keys())[:5]}")
    for key, leaf in want.items():
        got = raw[key]
        if got.shape != np.shape(leaf) or got.dtype != np.asarray(leaf).dtype:
            raise ValueError(f"{path}: {key} is {got.dtype}{list(got.shape)}, "
                             f"expected {np.asarray(leaf).dtype}"
                             f"{list(np.shape(leaf))}")
    return jax.tree_util.tree_unflatten(treedef, [raw[_key(p)]
                                                  for p, _ in leaves])


def load_config(ckpt_dir: str) -> Config:
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        return Config.from_json(f.read())
