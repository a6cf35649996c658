import os

import jax
import pytest

# Tests run on a virtual 8-device CPU mesh so sharding paths are exercised
# without accelerators.  JAX_PLATFORMS=cuda,cpu (with ``-m gpu``) runs the
# card-only tests on a GPU instead; the CPU devices stay available to them
# as the reference.
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_num_cpu_devices", 8)

# Persistent compilation cache: XLA compiles dominate test time.
jax.config.update("jax_compilation_cache_dir",
                  os.environ.get("JAX_COMPILATION_CACHE_DIR")
                  or os.path.join(os.path.dirname(__file__), "..",
                                  ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running lowering tests")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one; "
        "run with JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/)")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX sees none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("no GPU visible to JAX")
    return gpus[0]
