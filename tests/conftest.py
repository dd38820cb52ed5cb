"""Test harness config: force an 8-virtual-device CPU mesh.

Multi-card hardware is not available in CI, so every test runs on the CPU
backend with 8 virtual devices (`--xla_force_host_platform_device_count=8`),
exercising the same jit/shard_map code paths a multi-GPU mesh uses. This must run
before any JAX backend initialization — conftest import time is early enough
because the framework initializes backends lazily.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import pytest  # noqa: E402

# The CPU backend unless JAX_PLATFORMS says otherwise: the card's own tests
# run as `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` on the card.
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

# Persistent compile cache for the suite: the default run's wall time is
# dominated by XLA CPU compiles, and they repeat identically across runs
# (and across the per-module clear_caches below, which only drops the
# in-memory executables). The cache lives where every entry point keeps it
# (core/compile_cache.py: JAX_COMPILATION_CACHE_DIR, else .jax_cache/ in
# the checkout). ORT_TEST_CACHE=0 disables it.
if os.environ.get("ORT_TEST_CACHE") != "0":
    from optix_raytracer_tpu.core.compile_cache import enable_compile_cache
    enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_enable_xla_caches", "all")


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU. Tests that
    need the card take this fixture; the decision is made here, when the
    test runs, never while a module is imported."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu "
                    "on a machine with the card)")
    return jax.devices()[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules.

    ROOT CAUSE (captured round 5, no longer folklore): running the full
    suite with this workaround disabled (ORT_TEST_CLEARCACHES=0,
    PYTHONFAULTHANDLER=1) reproduces a hard SIGSEGV at ~87% of the suite
    — faulthandler stack: `jax/_src/compiler.py:362
    backend_compile_and_load` -> native XLA:CPU compile/load, reached
    from a trivial `lax.slice` compile in
    test_texture_maps.py::test_bundle_matches_per_map after ~1600
    executables (many huge interpret-mode Pallas programs) are live in
    one process (jax/jaxlib 0.9.0, CPU backend, persistent cache on).
    The same runs log `cpu_aot_loader.cc` machine-feature-mismatch
    errors ("could lead to execution errors such as SIGILL") when
    loading persistent-cache AOT results, so the crash sits in XLA:CPU's
    compile/AOT-load path under executable-count pressure — an upstream
    jaxlib issue, not a framework bug. Reproducer:
        ORT_TEST_CLEARCACHES=0 PYTHONFAULTHANDLER=1 \
            python -m pytest tests/ -q     # segfaults; rc=139
    Per-module cache clearing keeps the resident compiled-code footprint
    bounded (the suite passes 400+ tests reliably with it); cross-module
    recompiles are rare because fixtures don't cross modules either."""
    yield
    if os.environ.get("ORT_TEST_CLEARCACHES", "1") != "0":
        # ORT_TEST_CLEARCACHES=0 disables the workaround (reproducer runs
        # chasing the root cause keep every executable live).
        jax.clear_caches()
