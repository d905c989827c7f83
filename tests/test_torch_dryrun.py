"""The dry run of the PyTorch port (``repro_torch.compat``,
``launch/mesh.py``, ``launch/analysis.py``, ``launch/dryrun.py`` and the
dry ``ShardGroup``) against the reference's arithmetic and against real
gloo ranks.

* ``model_flops`` equals the reference's for every cell, smoke and full
  (exactly: the same arithmetic in float64).
* The dry group's collectives give the real group's shapes, types and
  counters (one spawned launch of 4 gloo CPU ranks); on a (2, 2) grid the
  dry trace of the qwen2-1.5b and mixtral-8x22b smoke train steps counts
  the collective output bytes by kind, the argument bytes and the FLOPs
  (``FlopCounterMode``) that each real rank counts on the same step:
  all exactly.
* The Louvain arch's ``web_3.8B_aggregate`` on the 16 x 16 mesh counts
  45,600,000,000 B of all-gather output a rank (gather) and 712,495,104 B
  of all-to-all (a2a); every Louvain shape and variant runs green on both
  production meshes.
* ``--all`` on the 16 x 16 mesh (``slow``: ~6 minutes on the CPU).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro.configs.registry import (ALL_ARCHS as J_ARCHS,
                                    EXTRA_ARCHS as J_EXTRA)
from repro.launch import analysis as janalysis

from repro_torch import compat
from repro_torch.configs import lm_common
from repro_torch.configs.registry import EXTRA_ARCHS, all_cells, get_arch
from repro_torch.core import collectives
from repro_torch.core.collectives import COLLECTIVE_KINDS, RankGrid, ShardGroup
from repro_torch.launch import analysis, dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw_init

CPU = "cpu"
RANKS = 4
GRID = (2, 2)
RANK_TIMEOUT = 240.0
LM_ARCHS = ("qwen2-1.5b", "mixtral-8x22b")
#: A model axis that divides neither the query nor the KV heads of
#: internlm2-20b's smoke config (6 and 2): the attention's all-heads path.
HEADS_GRID = (1, 4)


# ---------------------------------------------------------------------------
# Analytic FLOPs and the roofline.
# ---------------------------------------------------------------------------

_CELLS = all_cells() + [("louvain", s) for s in EXTRA_ARCHS["louvain"].shapes]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("cell", _CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_model_flops_equal_the_reference(cell, smoke):
    aid, shape = cell
    jarch = J_ARCHS.get(aid) or J_EXTRA[aid]
    assert (analysis.model_flops(get_arch(aid), shape, smoke)
            == janalysis.model_flops(jarch, shape, smoke))


def test_roofline_arithmetic_and_bottleneck():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    coll = dict.fromkeys(COLLECTIVE_KINDS, 0)
    coll["all-gather"] = 900
    r = analysis.Roofline(flops_per_chip=989e12, bytes_per_chip=6.7e12,
                          coll_bytes_per_chip=450e9, coll_by_kind=coll)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 2.0, 1.0)
    assert r.bottleneck == "memory" and r.bound_time == 2.0
    d = r.as_dict()
    assert list(d) == list(janalysis.Roofline(1.0, 1.0, 1.0, {}).as_dict())
    assert d["t_memory_s"] == 2.0 and d["coll_by_kind"] is coll
    for big, name in ((1e18, "compute"), (1e18 * 3.35e12 / 989e12,
                                          "memory")):
        r = analysis.Roofline(1e18 if name == "compute" else 0.0,
                              big if name == "memory" else 0.0, 1.0, {})
        assert r.bottleneck == name
    rec = {"flops": 2.0, "bytes": 3.0, "coll": coll, "arg_bytes": 5,
           "out_bytes": 7, "temp_peak": 11}
    r = analysis.roofline_from_trace(rec)
    assert (r.flops_per_chip, r.bytes_per_chip, r.coll_bytes_per_chip) == (
        2.0, 3.0, 900.0)
    assert analysis.memory_stats(rec) == {
        "argument_size_in_bytes": 5, "output_size_in_bytes": 7,
        "temp_size_in_bytes": 11, "peak_memory_in_bytes": 16}


# ---------------------------------------------------------------------------
# Meshes and capabilities.
# ---------------------------------------------------------------------------

def test_production_and_host_meshes():
    g = make_production_mesh()
    assert g.axis_names == ("data", "model")
    assert g.shape == {"data": 16, "model": 16}
    assert g.coords == {"data": 0, "model": 0}
    assert g.group.backend == "dry" and g.group.world_size == 256
    assert (g.dp.world_size, g.model.world_size) == (16, 16)
    assert compat.axis_size(g, "model") == 16
    g = make_production_mesh(multi_pod=True)
    assert g.axis_names == ("pod", "data", "model")
    assert g.group.world_size == 512 and g.dp_axes == ("pod", "data")
    host = make_host_mesh(ShardGroup.single(CPU))
    assert host.shape == {"data": 1, "model": 1}
    assert host.group.backend == "single"
    caps = compat.capabilities()
    assert set(caps) == {"torch", "cuda", "card", "name", "capability",
                         "sm_90a", "bf16", "nvcc", "flop_counter"}
    assert caps["flop_counter"] and caps["torch"] == torch.__version__
    assert caps["card"] == torch.cuda.is_available()
    x = torch.empty(3, device="meta")
    assert compat.is_dry(x) and not compat.is_dry(torch.zeros(3))


def test_dry_subgroups_make_no_process_group():
    grid = compat.make_mesh((2, 4, 2), ("pod", "data", "model"),
                            ShardGroup.dry(13, 16))
    assert grid.coords == {"pod": 1, "data": 2, "model": 1}
    assert grid.model.backend == grid.dp.backend == "dry"
    assert grid.dp.world_size == 8 and grid.dp.rank == 6
    assert grid.everyone.rank == 13
    one = compat.make_mesh((16, 1), ("data", "model"), ShardGroup.dry(3, 16))
    assert one.model.backend == "single" and one.model.group is None


# ---------------------------------------------------------------------------
# The dry group against real gloo ranks.
# ---------------------------------------------------------------------------

def _collective_calls(g: ShardGroup):
    """Every collective once, on small CPU tensors; the outputs' shapes
    and types."""
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    i = torch.arange(8, dtype=torch.int32)
    outs = [g.all_gather(x), g.all_gather(x, tiled=False),
            g.all_gather(x, dim=1), g.all_gather(i > 3),
            g.all_to_all(x), g.all_to_all(i), g.psum(x), g.psum(i),
            g.reduce_scatter(x), g.reduce_scatter(i.view(2, 4), dim=1),
            g.pmax(i)]
    return [(tuple(o.shape), str(o.dtype)) for o in outs]


def _counters(g) -> dict:
    s = g.stats() if isinstance(g, RankGrid) else {
        k: getattr(g, k) for k in ("collectives", "wire_bytes")} | {
        "coll_bytes": dict(g.coll_bytes)}
    return {"collectives": s["collectives"], "wire_bytes": s["wire_bytes"],
            "coll_bytes": dict(s["coll_bytes"])}


def _lm_train_inputs(arch_id: str, grid: RankGrid, seed: int = 0):
    cfg = get_arch(arch_id).config(True)
    params = lm_common.init_param_shares(cfg, grid, seed, CPU)
    opt = adamw_init(tf.flat_params(params))
    seq, b, _ = lm_common._shape_dims("train_4k", True)
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, seq))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    return cfg, params, opt, batch


def _split_heads_run(group: ShardGroup) -> dict:
    """internlm2-20b's smoke config (6 query heads, 2 KV heads) on a
    (1, 4) grid, whose model axis divides no head count: the loss and
    gradients of a train batch and a prefill's last logits."""
    grid = RankGrid(group, HEADS_GRID)
    cfg, params, _, batch = _lm_train_inputs("internlm2-20b", grid)
    step = lm_common.build_lm_step(cfg, "train_4k", grid, smoke_shapes=True)
    loss, grads = step.loss_and_grads(params, batch)
    prefill = lm_common.build_lm_step(cfg, "prefill_32k", grid,
                                      smoke_shapes=True)
    return {"loss": float(loss),
            "grads": {k: g.float().numpy() for k, g in grads.items()},
            "logits": prefill(params, {"tokens": batch["tokens"]}).numpy()}


def rank_dry_checks(group: ShardGroup) -> dict:
    """One real gloo rank: every collective's shapes and counters, then
    one smoke train step of each LM on a (2, 2) grid under the counters
    (FLOPs, collective bytes by kind, argument bytes)."""
    from torch.utils.flop_counter import FlopCounterMode

    out = {"shapes": _collective_calls(group), "counters": _counters(group),
           "heads": _split_heads_run(group)}
    grid = RankGrid(group, GRID)
    for aid in LM_ARCHS:
        cfg, params, opt, batch = _lm_train_inputs(aid, grid)
        step = lm_common.build_lm_step(cfg, "train_4k", grid,
                                       smoke_shapes=True)
        arg_bytes = analysis.tensor_bytes(
            (params, opt, lm_common.local_batch(batch, grid)))
        before = _counters(grid)
        flops = FlopCounterMode(display=False)
        with flops:
            step(params, opt, batch)
        after = _counters(grid)
        out[aid] = {"flops": float(flops.get_total_flops()),
                    "arg_bytes": arg_bytes,
                    "coll": {k: after["coll_bytes"][k]
                             - before["coll_bytes"][k]
                             for k in COLLECTIVE_KINDS}}
    return out


@pytest.fixture(scope="module")
def real_ranks():
    return collectives.launch(rank_dry_checks, RANKS,
                              devices=[CPU] * RANKS, timeout=RANK_TIMEOUT)


def test_dry_group_collectives_equal_a_real_groups(real_ranks):
    for r, real in enumerate(real_ranks):
        dry = ShardGroup.dry(r, RANKS)
        assert _collective_calls(dry) == real["shapes"]
        assert _counters(dry) == real["counters"]


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_dry_grid_counts_what_real_ranks_count(real_ranks, arch_id):
    for r, real in enumerate(real_ranks):
        grid = RankGrid(ShardGroup.dry(r, RANKS), GRID)
        rec = dryrun.trace_cell(get_arch(arch_id), "train_4k", grid,
                                smoke=True)
        assert rec["coll"] == real[arch_id]["coll"]
        assert rec["arg_bytes"] == real[arch_id]["arg_bytes"]
        assert rec["flops"] == real[arch_id]["flops"] > 0


def test_heads_that_do_not_split_over_model_equal_one_rank(real_ranks):
    """The all-heads attention (``transformer._attention_all_heads``) on 4
    ranks against the model on one rank: loss within 1e-5 relative, each
    rank's gradient shares within 1e-4 of the largest gradient entry,
    prefill logits within 1e-4."""
    from repro_torch.sharding.rules import share
    one = RankGrid(ShardGroup.dry(0, RANKS), HEADS_GRID)
    cfg, _, _, batch = _lm_train_inputs("internlm2-20b", one)
    params = tf.init_params(cfg, 0, CPU)
    single = ShardGroup.single(CPU)
    loss, grads = lm_common.build_lm_step(
        cfg, "train_4k", single, smoke_shapes=True).loss_and_grads(
        params, batch)
    logits = lm_common.build_lm_step(cfg, "prefill_32k", single,
                                     smoke_shapes=True)(
        params, {"tokens": batch["tokens"]})
    split = lm_common.flat_split(cfg, one)
    top = max(float(g.abs().max()) for g in grads.values())
    for r, real in enumerate(real_ranks):
        got = real["heads"]
        grid = RankGrid(ShardGroup.dry(r, RANKS), HEADS_GRID)
        assert got["loss"] == pytest.approx(float(loss), rel=1e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(
                got["grads"][k], share(g, split[k], grid).float().numpy(),
                rtol=1e-4, atol=1e-4 * top, err_msg=k)
        np.testing.assert_allclose(got["logits"], logits.numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch_id,shape", [("gin-tu", "full_graph_sm"),
                                           ("dimenet", "molecule")])
def test_dry_gnn_flops_equal_a_real_step(arch_id, shape):
    """A one-rank smoke train step: the dry trace's FLOPs equal
    ``FlopCounterMode`` on the step run for real on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    arch = get_arch(arch_id)
    grid = compat.make_mesh((1, 1), ("data", "model"), ShardGroup.dry(0, 1))
    rec = dryrun.trace_cell(arch, shape, grid, smoke=True)
    step = arch.build_step(shape, ShardGroup.single(CPU), smoke=True)
    model = arch.init_model(shape, 0, True, device=CPU)
    flops = FlopCounterMode(display=False)
    with flops:
        step(model, adamw_init(model), arch.make_batch(shape, 0, True, CPU))
    assert rec["flops"] == float(flops.get_total_flops()) > 0


# ---------------------------------------------------------------------------
# The Louvain arch on the production meshes.
# ---------------------------------------------------------------------------

def test_web_aggregate_collective_bytes():
    """Gather: 3 arrays x 256 ranks x e_l 14,843,750 x 4 B of all-gather
    output; a2a: 3 arrays x 256 x cap 231,932 x 4 B of all-to-all."""
    base = dryrun.run_cell("louvain", "web_3.8B_aggregate", multi_pod=False,
                           verbose=False)
    a2a = dryrun.run_cell("louvain", "web_3.8B_aggregate", multi_pod=False,
                          verbose=False, variant=("a2a",))
    assert base["ok"] and a2a["ok"]
    e_l = 3_800_000_000 // 256
    cap = 4 * (e_l // 256)
    assert 3 * 256 * e_l * 4 == 45_600_000_000
    assert 3 * 256 * cap * 4 == 712_495_104
    assert base["roofline"]["coll_by_kind"]["all-gather"] == 45_600_000_000
    assert base["roofline"]["coll_by_kind"]["all-to-all"] == 0
    assert a2a["roofline"]["coll_by_kind"]["all-to-all"] == 712_495_104
    assert a2a["roofline"]["coll_by_kind"]["all-gather"] == 0
    assert base["model_flops"] is None


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("variant", [(), ("a2a",), ("delta_c",)])
@pytest.mark.parametrize("shape", sorted(EXTRA_ARCHS["louvain"].shapes))
def test_louvain_cells_run_green(shape, variant, multi_pod):
    rec = dryrun.run_cell("louvain", shape, multi_pod=multi_pod,
                          verbose=False, variant=variant)
    assert rec["ok"], rec.get("error")
    assert rec["n_devices"] == (512 if multi_pod else 256)
    assert rec["memory"]["argument_size_in_bytes"] > 0


def test_cli_writes_the_reference_record(tmp_path):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "louvain", "--shape", "road_108M_aggregate",
                     "--variant", "a2a", "--out", str(tmp_path)])
    assert done.value.code == 0
    (path,) = tmp_path.iterdir()
    assert path.name == "louvain_road_108M_aggregate_16x16_a2a.json"
    rec = json.loads(path.read_text())
    for key in ("arch", "shape", "mesh", "n_devices", "ok", "variant",
                "trace_s", "memory", "cost", "roofline", "model_flops"):
        assert key in rec
    assert rec["ok"] and rec["variant"] == ["a2a"]
    with pytest.raises(KeyError, match="unknown arch 'nope'"):
        dryrun.main(["--arch", "nope", "--shape", "x", "--out",
                     str(tmp_path)])


@pytest.mark.slow
def test_all_cells_run_green_on_the_production_mesh(tmp_path):
    """``--all`` on 16 x 16: every cell green (~6 minutes on the CPU; the
    LM cells trace two stacks each)."""
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--all", "--out", str(tmp_path)])
    assert done.value.code == 0
    assert len(os.listdir(tmp_path)) == len(all_cells())
