"""Test harness: the CPU with a virtual 8-device mesh (SURVEY.md §4).

The suite runs on the CPU, where the fused transfers run their XLA
reference and the Triton kernels run in Pallas interpret mode.  Tests
marked ``gpu`` need the card: they skip here, and ``chip_smoke.py`` runs
them on the GPU in its own process, with ``NLPS_TESTS_ON_DEVICE=1`` so
that this file leaves JAX's platform alone.  Whether a card is present is
decided inside the ``gpu`` fixture, never while tests are collected, so
every xdist worker collects the same tests.
"""

import gc
import os
import sys

import jax
import pytest

if os.environ.get("NLPS_TESTS_ON_DEVICE") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` on the card")


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_cache_rss():
    """Release compiled executables between test modules so one pytest
    process stays under ~10 GB RSS (the round-2 full-suite run OOM-crashed
    at ~9 GB with every module's jitted programs resident)."""
    yield
    jax.clear_caches()
    gc.collect()
