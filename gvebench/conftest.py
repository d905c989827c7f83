"""Fixtures of the benchmark's own CPU tests: small sizes of every cell, so
a whole run (set-up, window, check) takes a second or two on the CPU."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


#: Per configuration and mix, the parameters that cut a cell to a CPU test.
SMALL = {
    "graph500-22": {"sizes": {"scale": 11}},
    "ds-stream": {"batch_frac": 0.002, "max_batches": 300,
                  "e_headroom": 1 << 14},
    "df-stream": {"batch_frac": 0.002, "max_batches": 300,
                  "e_headroom": 1 << 14},
}


def small(bench, workload: str) -> dict:
    """The overrides that run ``workload`` at a CPU test's size."""
    cell = bench.cell(workload)
    return {"config": SMALL.get(cell["config"], {}),
            "traffic": SMALL.get(cell["traffic"], {})}


@pytest.fixture(scope="session")
def bench():
    from gvebench.harness import Bench, checkout_root
    return Bench(checkout_root())


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
