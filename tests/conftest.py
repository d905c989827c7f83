"""Shared fixtures + the tier-1/slow split.  NOTE: no XLA_FLAGS here — smoke
tests must see the real single CPU device; only launch/dryrun.py forces 512
placeholder devices.

Tier-1 (default) excludes tests marked ``slow`` — the multi-device subprocess
suites and the heaviest smoke compiles — so `pytest -q` stays under ~2 min on
a laptop CPU.  Run everything with ``pytest --runslow``.
"""

import jax
import numpy as np
import pytest

# Shared by the subprocess multi-device suites (test_distributed, test_halo,
# test_louvain_arch, test_sharded_ce).  Those tests run their workload in a
# subprocess that forces N host CPU devices via XLA_FLAGS, so a single-CPU
# machine can execute them; skip only when neither real devices nor a CPU
# backend that can fake them exists.
N_SUBPROCESS_DEVICES = 8
multi_device = pytest.mark.skipif(
    jax.device_count() < N_SUBPROCESS_DEVICES
    and jax.default_backend() != "cpu",
    reason=f"needs {N_SUBPROCESS_DEVICES} devices or a CPU backend able to "
           "force host devices")


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (subprocess/multi-device suites)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: excluded from tier-1; run with --runslow")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow: needs --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
