"""Regenerate the frozen parity fixtures (tests/fixtures/golden.npz and
tests/fixtures/models.npz).

The in-repo NumPy goldens (frontend/golden_np.py, ops/ctc_numpy.py) are the
executable parity spec (SURVEY.md §2.1/§2.4: the reference mount was empty,
so the spec cannot be re-derived later). This file freezes their OUTPUTS for
a pinned input set so a refactor of the golden code cannot silently move
the spec itself (VERDICT.md r1 "What's missing" #4): changing golden output
fails tests/test_fixtures.py until this script is deliberately re-run.

models.npz pins the acoustic models the same way: tiny-width parameters of
every preset with the logits they gave when the file was written (by the
flax.linen implementation the models were first written in), so the
in-repo layer library (models/layers.py) must keep the parameter tree and
the numerics (tests/test_layers.py).

Run from the repo root:  python tests/fixtures/generate.py [golden] [models]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from chainer_speech_recognition.data.synthetic import make_utterance  # noqa: E402
from chainer_speech_recognition.frontend.golden_np import features  # noqa: E402
from chainer_speech_recognition.ops.ctc_numpy import ctc_loss_batch_np  # noqa: E402


def build() -> dict:
    out = {}
    rng = np.random.default_rng(20260816)

    # --- front-end: three deterministic signals of different character ---
    tones, _ = make_utterance(rng, [1, 4, 2, 7], tone_len=1600, noise=0.05)
    noise = rng.standard_normal(5000).astype(np.float32) * 0.3
    ramp = (np.linspace(-0.9, 0.9, 3210).astype(np.float32)
            * np.sin(np.arange(3210, dtype=np.float32) * 0.21))
    for name, sig in (("tones", tones), ("noise", noise), ("ramp", ramp)):
        out[f"sig_{name}"] = sig
        out[f"feat_{name}"] = features(sig, apply_cmvn=True)
        out[f"feat_nocmvn_{name}"] = features(sig, apply_cmvn=False)

    # --- CTC: losses + input grads on a pinned random batch --------------
    B, T, V, L = 4, 20, 8, 6
    logits = (rng.standard_normal((B, T, V)) * 2).astype(np.float32)
    t_len = np.asarray([20, 14, 9, 20])
    labels = rng.integers(1, V, (B, L)).astype(np.int32)
    lab_len = np.asarray([6, 4, 0, 3])
    loss, grad = ctc_loss_batch_np(logits, t_len, labels, lab_len)
    out.update(ctc_logits=logits, ctc_t_len=t_len, ctc_labels=labels,
               ctc_lab_len=lab_len, ctc_loss=loss, ctc_grad=grad)
    return out


MODEL_PRESETS = ("tiny_conv", "bigru", "bilstm_deep", "glu_conv", "conformer",
                 "conformer_stream", "uni_gru")


def tiny_model_config(name: str, compute_dtype: str):
    """A preset's ModelConfig at fixture widths (its own structure kept)."""
    from chainer_speech_recognition.config import preset_config

    cfg = preset_config(name).model
    over = {"rnn_hidden": 16, "glu_channels": 16, "attn_dim": 16,
            "attn_heads": 2, "attn_conv_kernel": 5, "vocab_size": 10,
            "compute_dtype": compute_dtype}
    if cfg.rnn_layers:
        over["rnn_layers"] = 2
    if cfg.glu_blocks:
        over["glu_blocks"] = 2
    if cfg.attn_blocks:
        over["attn_blocks"] = 2
    if cfg.attn_chunk:
        over.update(attn_chunk=4, attn_left_chunks=2)
    return type(cfg)(**{**cfg.__dict__, **over})


def build_models() -> dict:
    """Per preset: tiny-width params, one input batch, and the logits the
    model gives in float32 and in bfloat16 compute. Parameter leaves are
    stored under ``<preset>/params/<path>`` with ``/``-joined tree keys."""
    import jax
    import jax.numpy as jnp

    from chainer_speech_recognition.models.presets import build_model

    out = {}
    rng = np.random.default_rng(20261016)
    x = rng.standard_normal((2, 37, 40, 3)).astype(np.float32)
    lens = np.asarray([37, 21], np.int32)
    out["model_feats"], out["model_lens"] = x, lens
    for i, name in enumerate(MODEL_PRESETS):
        model = build_model(tiny_model_config(name, "float32"))
        params = model.init(jax.random.key(i), jnp.asarray(x),
                            jnp.asarray(lens))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = "/".join(str(p.key) for p in path)
            out[f"{name}/{key}"] = np.asarray(leaf)
        for dt in ("float32", "bfloat16"):
            m = build_model(tiny_model_config(name, dt))
            logits, olens = m.apply(params, jnp.asarray(x), jnp.asarray(lens))
            out[f"{name}#logits_{dt}"] = np.asarray(logits)
            out[f"{name}#olens"] = np.asarray(olens)
    return out


if __name__ == "__main__":
    here = os.path.dirname(__file__)
    which = sys.argv[1:] or ["golden", "models"]
    if "golden" in which:
        path = os.path.join(here, "golden.npz")
        np.savez_compressed(path, **build())
        print(f"wrote {path}")
    if "models" in which:
        path = os.path.join(here, "models.npz")
        np.savez_compressed(path, **build_models())
        print(f"wrote {path}")
