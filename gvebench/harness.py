"""One run of one cell: set-up, the measured window (traced with
``--trace 1``), the check against the reference, and the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
the configuration ``configs/<config>.json`` (its ``generator`` is
``gen/<generator>.py``), the mix ``traffic/<traffic>.json`` (its ``loop``
is ``loops/<loop>.py``) and each per-layer metric's reader
``metrics/<metric>.py`` (``read(record) -> number or None``).
"""

from __future__ import annotations

import contextlib
import copy
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Callable, Optional

import torch

from gvebench.loops import now, sync
from gvebench.reference.louvain import Params

#: Top-level module names that must not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root`` (the
    checkout's root)."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.spec["paths"][0]

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, section: str) -> list:
        """The cell's metrics of ``section`` ("end_to_end" or
        "per_layer")."""
        return [m for m in self.spec[section]
                if cell in m.get("workloads", [cell])]

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py`` under the benchmark's folder, loaded from
        its path (names may hold dots and dashes)."""
        path = self.dir / kind / f"{name}.py"
        mod_name = f"gvebench_{kind}_" + "".join(
            ch if ch.isalnum() else "_" for ch in name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or not path.is_file():
            raise SystemExit(f"no {kind} module {name!r} at {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        return self.module("metrics", metric).read


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, *, t_start: float, device="cuda",
             system_factory=None, overrides: Optional[dict] = None,
             log=None) -> dict:
    """One run; returns the result object.  ``system_factory(louvain
    params, device)`` builds the system under test (the program when
    None); ``overrides`` ({"config": {...}, "traffic": {...}}) change a
    configuration's or mix's parameters, for the CPU tests' small sizes."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = bench.cell(workload)
    overrides = overrides or {}
    config = _merge(bench.config(cell["config"]), overrides.get("config"))
    traffic = _merge(bench.traffic(cell["traffic"]), overrides.get("traffic"))
    gen = bench.module("gen", config["generator"])
    loop_mod = bench.module("loops", traffic["loop"])
    if system_factory is None:
        from gvebench.system import Program as system_factory
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    parts = {"imports_s": now() - t_start}
    t = now()
    system = system_factory(config["louvain"], dev)
    n, us, ud = gen.generate(config["sizes"], seed, dev)
    sync(dev)
    parts["program_and_graph_s"] = now() - t
    t = now()
    loop = loop_mod.Loop(system, n, us, ud, traffic, seed, dev)
    del us, ud
    sync(dev)
    parts["loop_s"] = now() - t
    setup_s = now() - t_start
    parts.update(getattr(loop, "setup_parts", {}))
    log(f"set-up {setup_s:.3f} s: {n} vertices; "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=activities)
        span = record_function
    else:
        span = lambda name: contextlib.nullcontext()     # noqa: E731
    with prof if prof is not None else contextlib.nullcontext():
        loop.window(seconds, span)
        sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    record = dict(loop.record(), device_kind=(
        torch.cuda.get_device_name(dev) if on_card else "cpu"))
    if prof is not None:
        from gvebench.trace import summarize
        record["trace"] = summarize(prof)
        del prof
    e2e = loop.end_to_end()
    for k, v in record.items():
        if k not in ("calls", "batches", "trace"):
            log(f"{k}: {v}")

    loop.release()
    if on_card:
        torch.cuda.empty_cache()
    t_check = now()
    attempted, failed, checks, extra = loop.check(Params.of(
        config["louvain"]))
    log(f"check against the reference: {now() - t_check:.3f} s")
    e2e.update(extra, setup_s=setup_s)

    metrics = {}
    if not trace:
        for m in bench.metrics(workload, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in bench.metrics(workload, "per_layer"):
            value = bench.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": record["device_kind"],
                   "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and record.get("trace"):
        tr = record["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v} (limit {lim})")
    return result


def checkout_root() -> Path:
    return Path(__file__).resolve().parents[1]


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its kernels under ``build/kernels`` itself)."""
    cache = root / "build" / "gvebench-cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)
