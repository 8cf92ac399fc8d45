"""Runtime helpers: where the compile cache lives, and the peak table that
MFU divides by."""

import os

import pytest

from chainer_speech_recognition.utils import flops as F
from chainer_speech_recognition.utils import runtime as R


def test_cache_dir_from_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert R.compilation_cache_dir() == str(tmp_path / "c")


def test_cache_dir_default_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = R.compilation_cache_dir()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_h100_peaks_known():
    peaks = F.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"bf16_tflops": 989.0, "hbm_tbps": 3.35}
    assert F.mfu(989e12 / 2, "NVIDIA H100 80GB HBM3") == pytest.approx(0.5)


@pytest.mark.parametrize("kind", ["Some Accelerator", "cpu", "NVIDIA A100"])
def test_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        F.device_peaks(kind)
