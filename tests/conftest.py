"""Test configuration: CPU backend with 8 virtual devices, float64.

Multi-device sharding is tested without hardware by faking an 8-device
mesh on CPU (XLA's host-platform device-count flag), the JAX answer to
"test multi-node without a cluster" (SURVEY.md section 4). float64 is
required for numeric parity with the C double reference.

The platform is the CPU unless JAX_PLATFORMS says otherwise: on a card,
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/` runs the tests
marked `gpu`, which ask for the `gpu` fixture below.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


# The full suite compiles a few hundred XLA CPU programs in one process;
# letting the compiled-executable caches accumulate across all modules
# has produced flaky segfaults INSIDE backend_compile_and_load near the
# end of the run (observed at different tests on different runs — an
# accumulation crash, not a per-program one: either half of the suite
# alone is green, only the union crashes). Dropping the caches between
# modules caps the in-process compiler state; each module recompiles its
# own programs, which it mostly would anyway.
import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first device, when it is a GPU; the test skips otherwise.
    Decided here, when the test runs, never at import."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    yield
    jax.clear_caches()
    gc.collect()
