"""BENCHMARK.json against the benchmark's contract, the files it names,
the import rule, and that a new configuration, mix and metric are picked
up from new files alone."""

import ast
import json
import re
import shutil
import sys
import time
import types
from pathlib import Path

import pytest

from gvebench.conftest import small
from gvebench.harness import (FORBIDDEN, Bench, checkout_root,
                               forbidden_modules, run_cell)

ROOT = checkout_root()
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "gvebench/run.py"]
    assert SPEC["paths"] == ["gvebench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_entries_have_the_contract_keys(section):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[section]
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        assert keys <= set(e) <= keys | {"workloads"}, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
                assert "\t" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


def test_configs_files_and_reductions():
    for c in SPEC["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"] == []
        assert data["assumed"] and data["guarantees"]
        gen = ROOT / "gvebench" / "gen"
        assert (gen / f"{data['generator']}.py").is_file()
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_cells_report_what_their_metrics_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e[
        "setup_s"]
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in SPEC["workloads"]}
    for w in cells.values():
        assert w["chips"] == 1
        assert (ROOT / "gvebench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        mine = [m for m in SPEC["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in SPEC["per_layer"])
    for m in SPEC["per_layer"]:
        assert (ROOT / "gvebench" / "metrics" / f"{m['name']}.py").is_file()
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", [cell])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "gvebench").rglob("*.py"))
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flax",
                                             "repro"), (path, mod)
            assert not mod.startswith("benchmarks"), (path, mod)
    for path in (ROOT / "gvebench" / "reference").rglob("*.py"):
        assert all(m.split(".")[0] != "repro_torch"
                   for m in _imports(path)), path


def test_new_files_are_picked_up(tmp_path):
    """A configuration, a mix and a per-layer metric added as files and
    entries of a copy of the benchmark, with no file edited, run."""
    shutil.copytree(ROOT / "gvebench", tmp_path / "gvebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    gdir = tmp_path / "gvebench"
    (gdir / "configs" / "tiny-rmat.json").write_text(json.dumps(dict(
        json.loads((gdir / "configs" / "graph500-22.json").read_text()),
        name="tiny-rmat", sizes={"scale": 9, "edge_factor": 8, "a": 0.45,
                                 "b": 0.15, "c": 0.15})))
    (gdir / "traffic" / "cold-again.json").write_text(json.dumps(
        {"loop": "cold"}))
    (gdir / "metrics" / "passes.cold.py").write_text(
        "def read(record):\n"
        "    calls = record.get('calls')\n"
        "    return len(calls[0]['passes']) if calls else None\n")
    spec["configs"].append({"name": "tiny-rmat", "source": "a test",
                            "file": "gvebench/configs/tiny-rmat.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny-rmat.cold-again",
                              "config": "tiny-rmat",
                              "traffic": "cold-again", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "passes.cold", "unit": "passes",
                              "better": "lower", "source": "program_counter",
                              "layer": "pass loop", "moves": "edges_per_s",
                              "workloads": ["tiny-rmat.cold-again"]})
    for m in spec["end_to_end"]:
        if m["name"] in ("edges_per_s", "modularity"):
            m["workloads"].append("tiny-rmat.cold-again")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    b = Bench(tmp_path)
    res = run_cell(b, "tiny-rmat.cold-again", 7, 0.2, True,
                   t_start=time.perf_counter(), device="cpu",
                   log=lambda m: None)
    assert res["correct"]
    assert res["metrics"]["passes.cold"]["value"] >= 1
    assert res["metrics"]["passes.cold"]["unit"] == "passes"
    res = run_cell(b, "tiny-rmat.cold-again", 7, 0.2, False,
                   t_start=time.perf_counter(), device="cpu",
                   log=lambda m: None)
    assert set(res["metrics"]) == {"edges_per_s", "modularity", "setup_s"}


def test_small_overrides_cover_every_cell(bench):
    for w in SPEC["workloads"]:
        over = small(bench, w["name"])
        assert over["config"], w["name"]


def test_forbidden_modules_are_named_by_their_top_level_name(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_extra",
                        types.ModuleType("repro_torch_extra"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert forbidden_modules() == ["jaxlib", "repro"]
