"""Test configuration: run the suite on CPU with 8 virtual devices and x64.

Tests validate numerics (float64, matching the reference's precision) and
multi-device sharding (8 simulated devices) without an accelerator; the
Triton kernel runs in the Pallas interpreter.  ``chip_smoke.py`` and
``bench.py`` run the same code on the GPU in float32.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere.  Run them on
the card in ONE process (a JAX process reserves most of the card's
memory, so pytest-xdist workers would starve each other):

    ADI_TEST_GPU=1 python -m pytest -m gpu -p no:xdist tests/

``jax.config.update`` is used in addition to the env vars because a pytest
plugin may import jax before this conftest runs; the config update still wins
as long as no backend has been initialized.
"""
import os

import pytest

if os.environ.get("ADI_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless the default device is a GPU (decided
    per test at run time, never at import)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (ADI_TEST_GPU=1 on the card)")
