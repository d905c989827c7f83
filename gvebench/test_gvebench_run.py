"""Whole runs on the CPU at small sizes (the harness's look for a card
skipped): the result line's keys, and ``correct`` false for the control
and for each fault a cell can have.  ``run.py`` refuses to run without a
card."""

import json
import subprocess
import sys
import time

import pytest
import torch

from gvebench.standins import ReferenceSystem, STAND_INS
from gvebench.conftest import small
from gvebench.harness import checkout_root, run_cell

CELLS = ["graph500-22.cold", "graph500-22.ds-stream", "graph500-22.df-stream"]


def _run(bench, cell, trace=False, system=None, seed=2 ** 31 + 101,
         device="cpu", overrides=None):
    return run_cell(bench, cell, seed, 0.3, trace, t_start=time.perf_counter(),
                    device=device, system_factory=system,
                    overrides=small(bench, cell) if overrides is None
                    else overrides, log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(bench, cell):
    for trace in (False, True):
        res = _run(bench, cell, trace)
        keys = list(res)
        assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                            "device"]
        assert keys[-1] == "checks"
        assert res["correct"] is True and res["failed"] == 0
        assert res["attempted"] >= 1
        assert json.loads(json.dumps(res)) == res
        dev = res["device"]
        assert {"platform", "kind", "count",
                "memory_peak_bytes"} <= set(dev)
        want = {m["name"] for m in bench.metrics(
            cell, "per_layer" if trace else "end_to_end")}
        got = set(res["metrics"])
        if trace:
            # The CPU trace has no card, so no roofline share is read.
            assert got == {m for m in want if "roofline" not in m}
            assert {"busy_s", "window_s"} <= set(dev)
            assert len(res["breakdown"]["idle_gaps"]) <= 10
        else:
            assert got == want
        for m in res["metrics"].values():
            assert set(m) == {"value", "unit"}
        for c in res["checks"].values():
            assert c["value"] <= c["limit"] == 0


FAULTS = [(cell, name) for cell in CELLS for name in STAND_INS
          if not (name == "half_batch" and cell.endswith(".cold"))]


@pytest.mark.parametrize("cell,stand_in", FAULTS)
def test_control_and_faults_are_not_correct(bench, cell, stand_in):
    res = _run(bench, cell, system=STAND_INS[stand_in])
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(checkout_root() / "gvebench" / "run.py"),
         "--workload", "graph500-22.cold", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=checkout_root())
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "CUDA" in out.stderr


@pytest.mark.gpu
def test_program_equals_the_reference_on_the_card(bench, cuda):
    over = {"config": {"sizes": {"scale": 16}}}
    res = _run(bench, "graph500-22.cold", device=cuda, overrides=over)
    assert res["correct"] is True
    res = _run(bench, "graph500-22.cold", device=cuda, overrides=over,
               system=ReferenceSystem)
    assert res["correct"] is False
