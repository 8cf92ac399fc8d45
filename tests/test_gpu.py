"""On-card checks: the Triton CTC kernel compiled for the GPU (never
interpreted) against the lax.scan CTC and the golden oracle, the device
front-end against the NumPy golden one, and one train step per preset
family. Marked ``gpu``: they skip where JAX finds no GPU. Run on the
machine with the card:

    CSR_GPU_TESTS=1 python -m pytest tests/test_gpu.py -m gpu -q
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def test_ctc_kernel_compiled_matches_scan_and_golden(gpu_device):
    from chainer_speech_recognition.ops.ctc_jax import ctc_loss
    from chainer_speech_recognition.ops.ctc_numpy import ctc_loss_batch_np
    from chainer_speech_recognition.ops.ctc_pallas import ctc_loss_pallas

    rng = np.random.default_rng(0)
    B, T, V, L = 8, 200, 40, 60
    logits = (rng.standard_normal((B, T, V)) * 2).astype(np.float32)
    tl = rng.integers(T // 2, T + 1, B)
    ll = rng.integers(0, L + 1, B)
    labels = rng.integers(1, V, (B, L))
    args = (jnp.asarray(tl), jnp.asarray(labels), jnp.asarray(ll))
    x = jnp.asarray(logits)
    lk = np.asarray(ctc_loss_pallas(x, *args))
    lj = np.asarray(ctc_loss(x, *args))
    np.testing.assert_allclose(lk, lj, rtol=1e-4)
    gk = np.asarray(jax.grad(lambda v: jnp.sum(ctc_loss_pallas(v, *args)))(x))
    _, gg = ctc_loss_batch_np(logits[:2], tl[:2], labels[:2], ll[:2])
    np.testing.assert_allclose(gk[:2], gg, atol=1e-4)


def test_frontend_matches_golden(gpu_device):
    from chainer_speech_recognition.data.synthetic import make_utterance
    from chainer_speech_recognition.frontend.golden_np import features
    from chainer_speech_recognition.frontend.jnp_frontend import (
        batch_features)

    sig, _ = make_utterance(np.random.default_rng(1), [1, 4, 2, 7, 3],
                            tone_len=3200)
    feats, flens = batch_features(jnp.asarray(sig[None]),
                                  jnp.asarray([len(sig)]))
    gold = features(sig, apply_cmvn=True)
    n = int(flens[0])
    assert n == gold.shape[0]
    assert float(np.abs(np.asarray(feats)[0, :n] - gold).max()) < 1e-2


@pytest.mark.parametrize("preset", ["bilstm_deep", "conformer", "glu_conv"])
def test_train_step_finite(gpu_device, preset):
    from chainer_speech_recognition.config import preset_config
    from chainer_speech_recognition.data.synthetic import make_batch
    from chainer_speech_recognition.frontend.jnp_frontend import (
        batch_features)
    from chainer_speech_recognition.models.presets import build_model
    from chainer_speech_recognition.parallel.mesh import (
        make_mesh, shard_batch)
    from chainer_speech_recognition.train.state import init_state
    from chainer_speech_recognition.train.step import make_train_step

    cfg = preset_config(preset).override({"model.vocab_size": 32,
                                          "parallel.num_devices": 1})
    batch = make_batch(np.random.default_rng(2), batch_size=8,
                       vocab_size=32, min_len=4, max_len=12, tone_len=2400)
    model = build_model(cfg.model)
    mesh = make_mesh(cfg.parallel)
    feats, flens = batch_features(jnp.asarray(batch["signals"][:1]),
                                  jnp.asarray(batch["num_samples"][:1]))
    state = init_state(model, cfg.optim, jax.random.key(0), feats, flens)
    state, m = make_train_step(model, cfg, mesh)(state,
                                                 shard_batch(mesh, batch))
    assert np.isfinite(float(m["loss"]))
    assert int(state.step) == 1
