"""Test configuration: force JAX onto 8 virtual CPU devices.

The platform is steered through jax.config (which works after jax is
imported) rather than environment variables. 8 virtual CPU devices let the
sharding tests exercise a real multi-device mesh without accelerator
hardware, per the multi-device test strategy (SURVEY.md §4/§7 phase 9).

Tests marked `gpu` need an NVIDIA GPU; the `gpu_device` fixture skips them
here. `python chip_smoke.py`, run on the card, runs the same checks.
"""

import os

import jax

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:  # older jax: fall back to XLA flag (read at backend init)
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running statistical tests")
    config.addinivalue_line(
        "markers",
        "heavy: interpret-mode kernel parity / recovery-fit tests (>=10s "
        "each). Fast iteration tier: pytest -m 'not heavy'; the full "
        "suite runs everything")


@pytest.fixture
def gpu_device():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run `python chip_smoke.py` on "
                    "the card)")
    return device
