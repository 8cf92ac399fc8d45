"""Train state + optimizer construction (SURVEY.md §2.6).

The full pytree (params, opt state, step, rng) is what gets checkpointed —
resume is bitwise-exact (SURVEY.md §5.3/§5.4).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import optax

from ..config import OptimConfig


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    opt_state: Any
    step: jnp.ndarray          # int32 scalar
    rng: jax.Array             # PRNG key DATA (uint32, serializable); wrap
                               # with jax.random.wrap_key_data before use

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def make_optimizer(cfg: OptimConfig) -> optax.GradientTransformation:
    """optax chain: global-norm clip → adam(w) → warmup+cosine schedule."""
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=cfg.learning_rate,
        warmup_steps=cfg.warmup_steps,
        decay_steps=max(cfg.decay_steps, cfg.warmup_steps + 1),
        end_value=cfg.learning_rate * cfg.end_lr_scale,
    )
    if cfg.optimizer == "adam":
        if cfg.weight_decay:
            opt = optax.adamw(sched, b1=cfg.b1, b2=cfg.b2,
                              weight_decay=cfg.weight_decay)
        else:
            opt = optax.adam(sched, b1=cfg.b1, b2=cfg.b2)
    elif cfg.optimizer == "sgd":
        opt = optax.sgd(sched, momentum=0.9, nesterov=True)
    else:
        raise KeyError(f"unknown optimizer {cfg.optimizer}")
    return optax.chain(optax.clip_by_global_norm(cfg.clip_norm), opt)


def init_state(model, optim_cfg: OptimConfig, rng: jax.Array,
               example_feats, example_lens) -> TrainState:
    p_rng, s_rng = jax.random.split(rng)
    params = jax.jit(model.init)(p_rng, example_feats, example_lens)
    tx = make_optimizer(optim_cfg)
    return TrainState(
        params=params,
        opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32),
        rng=jax.random.key_data(s_rng),
    )
