"""Test configuration: the CPU with 8 virtual devices unless the command
names platforms itself, so the sharding tests run anywhere.

`python -m pytest` runs on the CPU. On a machine with an NVIDIA GPU,
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu` runs the tests marked
`gpu` (card against CPU parity); elsewhere they skip.

Must set env vars BEFORE jax is imported by any test module.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def devices8():
    devs = jax.devices()
    assert len(devs) >= 8, f"expected 8 virtual CPU devices, got {len(devs)}"
    return devs[:8]


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked `gpu` need an NVIDIA GPU; decided here, at run time."""
    if (request.node.get_closest_marker("gpu")
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu")
