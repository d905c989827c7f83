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
                   "core/distributed_dynamic.py", "core/partition.py",
                   "core/gnn_halo.py", "optim/adamw.py",
                   "models/gnn/common.py", "models/gnn/gin.py",
                   "models/gnn/gat.py", "models/gnn/sampler.py",
                   "sharding/rules.py", "configs/gnn_common.py",
                   "configs/gin_tu.py", "configs/gat_cora.py",
                   "models/gnn/wigner.py", "models/gnn/equiformer.py",
                   "models/gnn/dimenet.py", "configs/equiformer_v2.py",
                   "configs/dimenet_cfg.py", "data/recsys.py",
                   "models/recsys.py", "configs/fm.py",
                   "optim/compression.py", "train/checkpoint.py",
                   "train/loop.py", "data/graphs.py", "interop.py",
                   "models/layers.py", "models/moe.py", "models/mla.py",
                   "models/transformer.py", "data/tokens.py",
                   "configs/lm_common.py", "configs/qwen2_1p5b.py",
                   "configs/internlm2_20b.py", "configs/gemma3_12b.py",
                   "configs/mixtral_8x22b.py",
                   "configs/deepseek_v2_236b.py", "configs/registry.py",
                   "launch/__init__.py", "launch/train.py"):
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


def test_graph_workload_entry_points_need_a_card_unless_asked_for_the_cpu():
    """The partitioner runs where its graph is; the GNN models, batches,
    converters and build_halo_inputs default to the card and raise
    without one."""
    from repro_torch import (GAT_CORA, GIN_TU, build_halo_inputs,
                             louvain_partition, random_partition)
    from repro_torch.core.gnn_halo import HaloSpec, halo_counts
    from repro_torch.interop import gnn_params_from_numpy
    from repro_torch.models.gnn.gat import GAT, GATConfig
    from repro_torch.models.gnn.gin import GIN, GINConfig
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g, _ = sbm_graph(2, 4, 0.5, 0.1, device="cpu")
    assert louvain_partition(g, 2).assignment.shape == (8,)
    assert random_partition(g, 2).order.shape == (8,)
    for call in (lambda: GIN(GINConfig()), lambda: GAT(GATConfig()),
                 lambda: GIN_TU.init_model("molecule", smoke=True),
                 lambda: GAT_CORA.make_batch("molecule", 0, smoke=True),
                 lambda: gnn_params_from_numpy("gin-tu", {}),
                 lambda: build_halo_inputs([0], [1], [0, 1], 1, 2, 2,
                                           HaloSpec(1, 2, 2, 1)),
                 lambda: halo_counts([0], [1], [0, 1], 1, 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    model = GIN_TU.init_model("molecule", smoke=True, device="cpu")
    batch = GIN_TU.make_batch("molecule", 0, smoke=True, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    step = GIN_TU.build_step("molecule", ShardGroup.single("cpu"), smoke=True)
    loss, _ = step.loss_and_grads(model, batch)
    assert loss.device.type == "cpu" and bool(torch.isfinite(loss))


def test_geometric_model_entry_points_need_a_card_unless_asked_for_the_cpu():
    """Equiformer-v2 and DimeNet: the modules, configs' models and batches
    and the Equiformer halo step default to the card and raise without
    one; asked for the CPU, every step runs there."""
    from repro_torch import DIMENET, EQUIFORMER_V2, build_halo_step
    from repro_torch.models.gnn.dimenet import DimeNet, DimeNetConfig
    from repro_torch.models.gnn.equiformer import (Equiformer,
                                                   EquiformerConfig)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: Equiformer(EquiformerConfig()),
                 lambda: DimeNet(DimeNetConfig()),
                 lambda: EQUIFORMER_V2.init_model("molecule", smoke=True),
                 lambda: DIMENET.init_model("molecule", smoke=True),
                 lambda: EQUIFORMER_V2.make_batch("molecule", 0, smoke=True),
                 lambda: DIMENET.make_batch("molecule", 0, smoke=True),
                 lambda: build_halo_step("equiformer-v2", "full_graph_sm",
                                         ShardGroup.single(), n_valid=8,
                                         smoke=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    cpu = ShardGroup.single("cpu")
    for arch, shape, variant in ((EQUIFORMER_V2, "molecule", ()),
                                 (EQUIFORMER_V2, "full_graph_sm", ()),
                                 (DIMENET, "molecule", ()),
                                 (DIMENET, "full_graph_sm", ())):
        model = arch.init_model(shape, smoke=True, device="cpu")
        batch = arch.make_batch(shape, 0, smoke=True, device="cpu")
        assert next(model.parameters()).device.type == "cpu"
        assert all(x.device.type == "cpu" for x in batch.values())
        step = arch.build_step(shape, cpu, smoke=True, variant=variant)
        loss, _ = step.loss_and_grads(model, batch)
        assert loss.device.type == "cpu" and bool(torch.isfinite(loss))
    step = build_halo_step("equiformer-v2", "full_graph_sm", cpu, n_valid=8,
                           smoke=True)
    assert step.group.device.type == "cpu"


def test_recsys_and_training_entry_points_need_a_card_unless_asked_for_the_cpu(
        tmp_path):
    """The FM, its batches, configs and converter, the generators and the
    loop's elastic controller default to the card and raise without one;
    asked for the CPU, the FM trains through the loop and a checkpoint
    restores onto its leaves' device."""
    from repro_torch import FM, save_checkpoint, restore_checkpoint
    from repro_torch.train import train
    from repro_torch.data import (lfr_graph, powerlaw_cluster,
                                  synthetic_click_batches)
    from repro_torch.interop import fm_params_from_numpy
    from repro_torch.models import recsys
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import ElasticController, TrainLoopConfig
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = FM.smoke_config()
    for call in (lambda: recsys.init_params(cfg),
                 lambda: recsys.FM(cfg),
                 lambda: FM.init_model("train_batch", smoke=True),
                 lambda: FM.make_batch("serve_p99", 0, smoke=True),
                 lambda: synthetic_click_batches(cfg.vocab_sizes, 4),
                 lambda: fm_params_from_numpy({"w0": 0.0, "w": np.zeros(2),
                                               "v": np.zeros((2, 1))}),
                 lambda: lfr_graph(200),
                 lambda: powerlaw_cluster(50, 2, 0.3),
                 lambda: ElasticController()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    params = recsys.init_params(cfg, device="cpu")
    batches = synthetic_click_batches(cfg.vocab_sizes, 8, device="cpu")
    out, metrics = train(lambda p, b: recsys.loss_fn(cfg, p, b), params,
                         batches, AdamWConfig(), TrainLoopConfig(
                             total_steps=2),
                         elastic=ElasticController("cpu"))
    assert all(v.device.type == "cpu" for v in out.values())
    assert len(metrics["history"]) == 2
    save_checkpoint(str(tmp_path), 2, {"params": out})
    back = restore_checkpoint(str(tmp_path), 2, {"params": params})
    assert all(v.device.type == "cpu" and torch.equal(v, out[k])
               for k, v in back["params"].items())
    g, comm = lfr_graph(200, device="cpu")
    assert g.device.type == "cpu" and comm.shape == (200,)
    assert powerlaw_cluster(50, 2, 0.3, device="cpu").device.type == "cpu"


def test_lm_entry_points_need_a_card_unless_asked_for_the_cpu():
    """The LM's weights, caches, token batches and converters
    default to the card and raise without one; asked for the CPU, the
    registry's train step runs there."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import synthetic_token_batches
    from repro_torch.interop import lm_cache_from_numpy, lm_params_from_numpy
    from repro_torch.models import mla, transformer as tf
    from repro_torch.optim import adamw_init
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    arch = get_arch("deepseek-v2-236b")
    cfg = arch.smoke_config()
    for call in (lambda: tf.init_params(cfg),
                 lambda: tf.init_cache(cfg, 1, 4),
                 lambda: mla.mla_init(cfg.mla, 8, 2),
                 lambda: synthetic_token_batches(16, 2, 4),
                 lambda: lm_params_from_numpy({"layers": []}),
                 lambda: lm_cache_from_numpy({"slots": []})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    params = tf.init_params(cfg, device="cpu")
    batch = next(synthetic_token_batches(cfg.vocab, 2, 16, device="cpu"))
    step = arch.build_step("train_4k", ShardGroup.single("cpu"), smoke=True)
    params, opt, loss = step(params, adamw_init(tf.flat_params(params)),
                             batch)
    assert loss.device.type == "cpu" and bool(torch.isfinite(loss))
    assert all(x.device.type == "cpu" for x in tf.flat_params(params).values())


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
