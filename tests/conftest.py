"""Test configuration: the CPU with 8 virtual devices, or the card.

By default the tests run on the CPU (Pallas kernels interpreted) with 8
virtual devices for the sharding tests; this must happen before jax
initializes a backend, and pytest imports conftest first. Tests marked
``gpu`` need the card: ``CERES_TEST_PLATFORM=gpu pytest -m gpu`` runs them
there (chip_smoke.py runs them inside its own process, the one process on
the card), and they skip elsewhere.
"""

import os
import sys

if os.environ.get("CERES_TEST_PLATFORM", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    # Persistent compilation cache: XLA-CPU compiles dominate test time.
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                          "/tmp/ceres_tpu_jax_cache")
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

from ceres_tpu.render.scenes import data_dir

DATA_DIR = data_dir()


@pytest.fixture(scope="session")
def bunny():
    from ceres_tpu.io.obj import load_obj

    return load_obj(os.path.join(DATA_DIR, "bunny.obj"))


@pytest.fixture(scope="session")
def dragon():
    from ceres_tpu.io.obj import load_obj

    return load_obj(os.path.join(DATA_DIR, "dragon.obj"))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on the card (decided here, never at import)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU: run with CERES_TEST_PLATFORM=gpu "
                    "pytest -m gpu on the card")
