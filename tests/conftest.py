"""Shared test fixtures.

The suite compiles hundreds of XLA CPU executables; without releasing
them the CPU JIT eventually fails late in the run with "Failed to
materialize symbols … Cannot allocate memory". Dropping the compilation
cache between modules keeps the JIT arena bounded (each module pays its
own compiles; cross-module reuse is negligible here).

When ``hypothesis`` is not installed, a minimal deterministic fallback
(repro.testing.hypothesis_fallback) is registered under that name so
the property-test modules still collect and run as smoke tests.
"""
import sys

import jax
import pytest

try:
    import hypothesis  # noqa: F401 — real package wins when present
except ImportError:
    from repro.testing import hypothesis_fallback

    sys.modules["hypothesis"] = hypothesis_fallback
    sys.modules["hypothesis.strategies"] = hypothesis_fallback.strategies


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
