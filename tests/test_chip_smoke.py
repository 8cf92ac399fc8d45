"""chip_smoke.py off the card: the script refuses the CPU (non-zero exit,
no result line) and refuses to run without the package beside it; its
phase functions run end to end at tiny sizes on the CPU backend, the
CTC kernel in interpret mode and the data-parallel check on 4 of the 8
virtual CPU devices."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as S  # noqa: E402

TINY = S.Scale(
    utts=24, min_seconds=1.0, max_seconds=2.4, vocab=12, labels=(4, 12),
    train_steps=4,
    steps_per_dispatch=2,
    sets=("buckets.boundaries=[128,256]", "buckets.batch_sizes=[4,4]",
          "buckets.max_label_len=32", "model.compute_dtype=float32",
          "parallel.num_devices=1"),
    model_over={"rnn_hidden": 16, "rnn_layers": 1, "attn_blocks": 1,
                "attn_dim": 16, "attn_heads": 2, "glu_blocks": 1,
                "glu_channels": 16},
    stream_steps=2, batch=4, frames=128, ctc_shape=(3, 24, 8, 6),
    beam_rows=2, timed_steps=1, interpret=True)


def _no_result(out: subprocess.CompletedProcess):
    assert out.returncode != 0, out.stdout
    assert '"ok": true' not in out.stdout


def test_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    _no_result(out)
    assert "needs a GPU" in out.stderr + out.stdout


def test_refuses_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=300)
    _no_result(out)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("smoke"))
    paths = S.phase_corpus(work, TINY)
    ckpt = S.phase_train(paths, work, TINY)
    return work, paths, ckpt


def test_cli_phases_tiny(trained):
    """corpus → train (+resume) → evaluate/decode → decoder and front-end
    references, through the CLIs' main()."""
    work, paths, ckpt = trained
    S.phase_decode(paths, ckpt)
    S.phase_decoder_reference(ckpt, paths, TINY)
    S.phase_frontend_reference(paths, n=2)


@pytest.mark.parametrize("preset", ["uni_gru", "conformer_stream"])
def test_stream_phase_tiny(trained, preset):
    work, paths, _ = trained
    S.phase_stream(paths, work, TINY, preset)


def test_preset_and_reference_phases_tiny():
    S.phase_presets(("tiny_conv", "glu_conv"), TINY, vocab_size=12)
    S.phase_loss_reference("conformer", TINY, vocab_size=12)


def test_ctc_phases_tiny():
    times = S.phase_ctc_kernel(TINY)
    assert set(times) == {"scan", "kernel", "kernel2", "scan2"}
    out = S.phase_ctc_train_step("tiny_conv", TINY, vocab_size=12)
    assert len(out["jnp"]) == len(out["pallas"]) == 2


def test_dp_phase_on_four_virtual_devices():
    S.phase_dp(4, TINY, vocab_size=12)
