"""Shared fixtures.  NOTE: no XLA_FLAGS device-count override here — tests
run single-device by design; mesh/dry-run integration tests spawn
subprocesses with their own flags (see test_dryrun_smoke.py)."""
import jax
import pytest


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
