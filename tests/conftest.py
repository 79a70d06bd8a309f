"""Test configuration: two tiers.

Default (CPU) tier: force the CPU backend with 8 virtual devices and x64 —
sharding tests run on a virtual 8-device CPU mesh (SURVEY.md §4c) and
parity tests use the f64 contract.  Tests of the spectra kernel run it in
Pallas interpret mode.

GPU tier (``SDFT_TEST_GPU=1 python -m pytest tests/test_gpu.py``, on a machine
with an NVIDIA GPU): leave platform selection to JAX and keep x64 off, so
the f32 paths run as users run them.  Tests marked ``gpu`` (tests/
test_gpu.py) are the on-card f32 parity gates against the native f64
oracle, the analogue of the reference comparator running on the real
implementation (test/main.py:67-79).  Each decides inside a fixture
whether a GPU is present and skips otherwise, so the CPU tier collects
them and reports them skipped.

This must run before jax is imported by any test module.
"""

import os

GPU_TIER = os.environ.get("SDFT_TEST_GPU", "") not in ("", "0")

if not GPU_TIER:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from sdft_tpu.runtime import setup_compile_cache  # noqa: E402

if not GPU_TIER:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
setup_compile_cache()

import pathlib  # noqa: E402

import pytest  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
REFERENCE_WAV = pathlib.Path("/root/reference/test/test.wav")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: on-card f32 parity gates; run on a GPU machine via "
        "SDFT_TEST_GPU=1 python -m pytest tests/test_gpu.py")


@pytest.fixture(scope="session")
def test_wav():
    """The reference 8-second mono 24-bit 44.1 kHz fixture, loaded once."""
    from sdft_tpu.io.wav import read_wav

    if not REFERENCE_WAV.exists():
        pytest.skip("reference test.wav not available")
    samples, sr = read_wav(str(REFERENCE_WAV))
    return samples, sr
