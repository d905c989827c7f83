"""Rules the PyTorch port keeps: it imports neither JAX, nor the JAX package
``repro``, nor networkx; its entry points run on the card unless the caller
asks for the CPU, and raise without one; options a later slice ported run
and equal the reference."""

import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys

import jax  # noqa: F401  (the parity files import both frameworks)
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import (LouvainConfig, ShardGroup, apply_edge_batch,
                         build_csr, distributed_louvain, louvain,
                         louvain_batched, louvain_dynamic,
                         louvain_dynamic_batched, make_edge_batch, sbm_graph,
                         sbm_holdout_stream, stack_graphs)
from repro_torch.interop import config_from_dict, graph_from_numpy

from repro.core.louvain import LouvainConfig as JConfig, louvain as jlouvain
from repro.data import sbm_graph as jsbm_graph

PORT_DIR = os.path.dirname(repro_torch.__file__)
SRC_DIR = os.path.dirname(PORT_DIR)
FORBIDDEN = ("jax", "repro", "networkx")


def _modules():
    return [m.name for m in pkgutil.walk_packages([PORT_DIR], "repro_torch.")]


def test_every_module_imports_with_jax_blocked():
    code = ("import importlib, sys\n"
            "for name in ('jax', 'jaxlib', 'repro', 'networkx'):\n"
            "    sys.modules[name] = None\n"
            "import repro_torch\n"
            f"for name in {_modules()!r}:\n"
            "    importlib.import_module(name)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC_DIR)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_forbidden_import_anywhere_in_the_port():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT_DIR)
             for f in fs if f.endswith(".py")]
    assert len(files) >= 19
    for module in ("core/delta.py", "core/dynamic.py",
                   "kernels/batch_apply/resolve.py", "core/comm.py",
                   "core/collectives.py", "core/distributed.py",
                   "core/distributed_dynamic.py"):
        assert os.path.join(PORT_DIR, module) in files
    files.append(os.path.join(os.path.dirname(SRC_DIR), "chip_smoke.py"))
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_csr(np.array([0]), np.array([1]), np.ones(1, np.float32), 2,
                  symmetrize=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sbm_graph(2, 4, 0.5, 0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_edge_batch([0], [1], [1.0], 8)
    g, _ = sbm_graph(2, 4, 0.5, 0.1, device="cpu")
    assert g.device.type == "cpu"
    assert louvain(g).membership.shape == (8,)
    batch = make_edge_batch([0], [5], [2.0], g.n_cap, device="cpu")
    assert batch.src.device.type == "cpu"
    g2, touched = apply_edge_batch(g, batch, grow=True)
    assert touched.device.type == "cpu" and bool(touched[0])
    dyn = louvain_dynamic(g, [batch])
    assert dyn.membership.shape == (8,) and dyn.graph.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sbm_holdout_stream(0, n_hold=4)
    fleet = stack_graphs([g, g])
    res = louvain_batched(fleet)
    assert res.membership.shape == (2, 8)
    assert res.membership.device.type == "cpu"
    bat = louvain_dynamic_batched([g, g], [[batch], [batch]])
    assert bat.membership.shape == (2, 8)
    assert bat.graphs.device.type == "cpu"
    # The sharded driver runs where its group's ranks are: a group needs a
    # card unless it is asked for the CPU.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed_louvain(g, ShardGroup.single())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardGroup.init("gloo", 0, 1, "file:///nonexistent")
    mem, n_comms, stats = distributed_louvain(g, ShardGroup.single("cpu"))
    assert mem.shape == (8,) and n_comms == len(np.unique(mem)) and stats


def test_config_keeps_the_reference_fields_and_defaults():
    want = {f.name: f.default for f in dataclasses.fields(JConfig)}
    got = {f.name: f.default for f in dataclasses.fields(LouvainConfig)}
    assert got == want
    cfg = config_from_dict(dataclasses.asdict(JConfig(agg_backend="pallas")))
    assert cfg.agg_backend == "kernel"


def _jax_and_port_sbm():
    jg, _ = jsbm_graph(4, 8, 0.5, 0.02, seed=1)
    tg = graph_from_numpy(np.asarray(jg.indptr), np.asarray(jg.indices),
                          np.asarray(jg.weights), np.asarray(jg.src),
                          int(jg.n_valid), int(jg.e_valid), device="cpu")
    return jg, tg


@pytest.mark.parametrize("kwargs", [{"refine": "leiden"},
                                    {"scan_backend": "compact"}])
def test_options_outside_the_slice_raise(kwargs):
    """Both options were outside the first slice and raised; Leiden
    refinement and the compact scanner are ported now, so each is accepted
    (also through ``config_from_dict``) and runs like the reference."""
    assert config_from_dict(kwargs) == LouvainConfig(**kwargs)
    jg, tg = _jax_and_port_sbm()
    frontier = np.arange(tg.n_cap + 1) % 12 == 0
    want = jlouvain(jg, JConfig(**kwargs), init_frontier=frontier)
    got = louvain(tg, LouvainConfig(**kwargs), init_frontier=frontier)
    np.testing.assert_array_equal(got.membership, want.membership)
    assert ([(p.n_communities, p.n_refined, p.refine_iterations)
             for p in got.passes]
            == [(p.n_communities, p.n_refined, p.refine_iterations)
                for p in want.passes])
    if kwargs == {"scan_backend": "compact"}:
        assert got.passes[0].scan_backend == "compact"


@pytest.mark.parametrize("kwargs", [{"init_membership": np.zeros(8, int)},
                                    {"init_frontier": np.ones(8, bool)}])
def test_warm_starts_raise(kwargs):
    """Warm starts were outside the first slice and raised; they are ported
    now, so the same calls run and equal the reference's."""
    jg, tg = _jax_and_port_sbm()
    want = jlouvain(jg, **kwargs)
    got = louvain(tg, **kwargs)
    np.testing.assert_array_equal(got.membership, want.membership)
    assert ([p.frontier_size for p in got.passes]
            == [p.frontier_size for p in want.passes])


def test_sharded_only_fields_are_accepted_and_ignored():
    g, _ = sbm_graph(4, 8, 0.5, 0.02, seed=1, device="cpu")
    base = louvain(g).membership
    cfg = LouvainConfig(comm_backend="delta", reshard="auto",
                        pipeline_fetch=True, state_layout="hybrid")
    np.testing.assert_array_equal(louvain(g, cfg).membership, base)
