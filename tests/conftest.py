"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests run on the default
single device; only the dry-run entrypoint forces 512 placeholder devices.
"""
import jax
import pytest


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "gpu: runs the port's CUDA kernels; needs a Hopper card "
                   "and nvcc, and skips without them")
