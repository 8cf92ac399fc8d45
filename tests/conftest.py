"""Test harness config: run everything on CPU with 8 fake devices, except
the on-card checks marked ``gpu`` (tests/test_gpu.py).

SURVEY.md §4.3: distributed (DP mesh / shard_map / psum) paths are exercised
without a cluster by forcing the host platform to expose 8 virtual devices.

``CSR_GPU_TESTS=1`` leaves the real backend in place for the on-card
checks, which are run on the machine with the card by:

    CSR_GPU_TESTS=1 python -m pytest tests/test_gpu.py -m gpu -q

Whether a card exists is decided inside the ``gpu_device`` fixture, never
at import, so every worker collects the same tests.
"""

import os

import pytest

if os.environ.get("CSR_GPU_TESTS") != "1":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX finds none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU (JAX has {devices[0].platform}); run "
                    "with CSR_GPU_TESTS=1 on the machine with the card")
    return devices[0]
