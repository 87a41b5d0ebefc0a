"""Test configuration: JAX on the CPU with 8 virtual devices unless
``JAX_PLATFORMS`` names another platform.

Unit tests exercise the same jitted code paths on the CPU, so they are
hermetic and can validate multi-device sharding. Tests marked ``chip`` need
a GPU: run them on one with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m chip
-p no:xdist``; elsewhere the ``gpu`` fixture skips them.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "XLA_FLAGS",
    (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip(),
)

import jax

jax.config.update("jax_num_cpu_devices", 8)

from flo_tpu import compile_cache

# Repeat suite runs skip XLA compiles, which both cuts minutes of wall time
# and avoids a rare XLA CPU compiler segfault observed under long
# single-process runs.
compile_cache.configure()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import pathlib

import pytest

from flo_tpu import corpus

#: Conformance corpus: the committed copy (tests/vectors/README.md), or
#: FLO_TPU_EXAMPLES_DIR.
EXAMPLES_DIR = corpus.examples_dir()


@pytest.fixture(scope="session")
def examples_dir():
    if not EXAMPLES_DIR.is_dir():
        pytest.skip("conformance corpus not available")
    return EXAMPLES_DIR


@pytest.fixture(scope="session")
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {devices[0].platform}")
    return devices[0]


@pytest.fixture(autouse=True)
def _reset_spec_caches():
    """Clear the speculative-sizing caches before every test.

    The bulk pipelines learn payload/entry sizes in module-global dicts
    (`blockspread._SPEC_BYTES`, `lossy.encoder._ENTRIES_SPEC`). The values
    are correctness-neutral size hints, but tests that count dispatches
    (tests/test_bulk.py speculative-bucket contracts) depend on a cold
    cache, so isolate every test."""
    from flo_tpu.lossy import encoder as _loe
    from flo_tpu.ops import blockspread as _bs

    _bs.reset_spec_cache()
    _loe.reset_spec_cache()
    yield


@pytest.fixture(scope="module", autouse=True)
def _bound_xla_executable_accumulation():
    """Clear jit caches between test modules.

    A single pytest process compiles ~300 XLA CPU programs; past ~200 the
    XLA CPU compiler has been observed to crash (SIGSEGV in compile /
    SIGABRT in cache serialization). Dropping live executables per module
    bounds that accumulation; the persistent compilation cache makes any
    recompile a cheap deserialization."""
    yield
    import jax as _jax

    _jax.clear_caches()
