"""Test configuration: run JAX on a virtual 8-device CPU mesh, so the
sharding/multi-device paths are exercised without an accelerator.
Kernel tests run the Pallas interpreter; tests that need a GPU carry the
``gpu`` marker and skip elsewhere."""

import os

import pytest

# The GPU tests run on the card with JAX_PLATFORMS=cuda,cpu set outside.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture()
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a CUDA GPU")
    return devs[0]
