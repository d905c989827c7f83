"""Rules the PyTorch port keeps: it imports neither JAX, nor the JAX package
``repro``, nor networkx; its entry points run on the card unless the caller
asks for the CPU, and raise without one; options outside the ported slice
raise ``NotImplementedError``."""

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
from repro_torch import LouvainConfig, build_csr, louvain, sbm_graph
from repro_torch.interop import config_from_dict

from repro.core.louvain import LouvainConfig as JConfig

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
    assert len(files) >= 15
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
    g, _ = sbm_graph(2, 4, 0.5, 0.1, device="cpu")
    assert g.device.type == "cpu"
    assert louvain(g).membership.shape == (8,)


def test_config_keeps_the_reference_fields_and_defaults():
    want = {f.name: f.default for f in dataclasses.fields(JConfig)}
    got = {f.name: f.default for f in dataclasses.fields(LouvainConfig)}
    assert got == want
    cfg = config_from_dict(dataclasses.asdict(JConfig(agg_backend="pallas")))
    assert cfg.agg_backend == "kernel"


@pytest.mark.parametrize("kwargs", [{"refine": "leiden"},
                                    {"scan_backend": "compact"}])
def test_options_outside_the_slice_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LouvainConfig(**kwargs)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        config_from_dict(kwargs)


@pytest.mark.parametrize("kwargs", [{"init_membership": np.zeros(8, int)},
                                    {"init_frontier": np.ones(8, bool)}])
def test_warm_starts_raise(kwargs):
    g, _ = sbm_graph(2, 4, 0.5, 0.1, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        louvain(g, **kwargs)


def test_sharded_only_fields_are_accepted_and_ignored():
    g, _ = sbm_graph(4, 8, 0.5, 0.02, seed=1, device="cpu")
    base = louvain(g).membership
    cfg = LouvainConfig(comm_backend="delta", reshard="auto",
                        pipeline_fetch=True, state_layout="hybrid")
    np.testing.assert_array_equal(louvain(g, cfg).membership, base)
