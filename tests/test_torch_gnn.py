"""The GNN slice of the PyTorch port (``repro_torch.models.gnn``,
``repro_torch.configs.gin_tu`` / ``gat_cora`` / ``gnn_common``) against the
JAX package, on the CPU at the smoke shapes.

The same weights (carried by ``interop.gnn_params_from_numpy``) and the
same batches (``make_batch`` from the same numpy seed) go through both.
Tolerances: logits rtol 1e-5 / atol 1e-6; loss rtol 1e-5; gradients rtol
1e-4 with an atol of 1e-4 times the largest entry of the reference
gradient (entries that cancel to near zero carry the float32 error of the
larger terms); a 6-step train-step loss trajectory rtol 1e-4 (float32 sums in
another order on each side).  The sampler and the tables must be
equal exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gat_cora as jgat_cora, gin_tu as jgin_tu
from repro.configs import gnn_common as jcommon
from repro.models.gnn import gat as jgat, gin as jgin
from repro.models.gnn import sampler as jsampler
from repro.models.gnn.common import (GraphBatch as JGraph,
                                     segment_softmax as jsoftmax)
from repro.optim import (AdamWConfig as JAdamWConfig, adamw_init as jinit,
                         adamw_update as jupdate)
from repro.sharding import rules as jrules

from repro_torch import ShardGroup
from repro_torch.configs import gat_cora, gin_tu, gnn_common
from repro_torch.configs.gnn_common import GNN_SMOKE_SHAPES, merged_graph
from repro_torch.interop import adamw_state_from_numpy, gnn_params_from_numpy
from repro_torch.models.gnn import common, sampler
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.sharding import rules

ARCHS = {"gin-tu": (jgin_tu, gin_tu), "gat-cora": (jgat_cora, gat_cora)}
SHAPES = list(GNN_SMOKE_SHAPES)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class Case:
    """One (arch, smoke shape): the JAX params, batch and loss, and the
    port's model (same weights), batch (same seed) and train step."""

    def __init__(self, arch_id, shape):
        jmod, tmod = ARCHS[arch_id]
        self.arch_id, self.shape = arch_id, shape
        self.jarch, self.arch = jmod.ARCH, tmod.ARCH
        self.sh = GNN_SMOKE_SHAPES[shape]
        self.jcfg = self.jarch.make_config(self.sh, True)
        self.jloss = self.jarch.make_loss(self.jcfg, self.sh, shape)
        key = jax.random.PRNGKey(0)
        self.params = self.jarch.init_params(shape, key, smoke=True)
        self.jbatch = self.jarch.make_batch(shape, key, smoke=True)
        seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
        self.batch = self.arch.make_batch(shape, seed, smoke=True,
                                          device="cpu")
        self.model = self.arch.init_model(shape, smoke=True, device="cpu")
        self.model.load_state_dict(
            gnn_params_from_numpy(arch_id, _np(self.params), device="cpu"))
        cfg = self.arch.make_config(self.sh, True)
        self.share = self.arch.make_loss(cfg, self.sh, shape)

    def jax_logits(self):
        sh, b = self.sh, self.jbatch
        fwd = (jgin if self.arch_id == "gin-tu" else jgat).forward
        if sh.kind == "full":
            n_pad = b["node_feat"].shape[0]
            g = JGraph(node_feat=b["node_feat"], edge_src=b["edge_src"],
                       edge_dst=b["edge_dst"], n_nodes=jnp.int32(sh.n_nodes),
                       labels=b["labels"],
                       graph_id=jnp.zeros((n_pad,), jnp.int32),
                       n_graphs=jnp.int32(1))
            return np.asarray(jax.jit(lambda p: fwd(self.jcfg, p, g))(
                self.params))
        cfg = self.jcfg
        graph_level = self.arch_id == "gin-tu" and sh.kind == "molecule"
        if graph_level:
            cfg = dataclasses.replace(cfg, graph_level=True)

        def one(nf, es, ed):
            g = JGraph(node_feat=nf, edge_src=es, edge_dst=ed,
                       n_nodes=jnp.int32(sh.n_nodes),
                       labels=jnp.zeros((sh.n_nodes,), jnp.int32),
                       graph_id=jnp.zeros((sh.n_nodes,), jnp.int32),
                       n_graphs=jnp.int32(1))
            out = fwd(cfg, self.params, g)
            return out[0] if graph_level else out
        return np.asarray(jax.jit(jax.vmap(one))(
            b["node_feat"], b["edge_src"], b["edge_dst"]))

    def port_logits(self):
        sh, b = self.sh, self.batch
        if sh.kind == "full":
            g = GraphBatch(node_feat=b["node_feat"], edge_src=b["edge_src"],
                           edge_dst=b["edge_dst"], n_nodes=sh.n_nodes,
                           labels=b["labels"],
                           graph_id=torch.zeros(b["node_feat"].shape[0],
                                                dtype=torch.int32),
                           n_graphs=1)
            return self.model(g).detach().numpy()
        g = merged_graph(b)
        if self.arch_id == "gin-tu" and sh.kind == "molecule":
            pooled = common.segment_sum(self.model.embed(g), g.graph_id,
                                        g.n_graphs)
            return self.model.head(pooled).detach().numpy()
        return self.model(g).detach().numpy().reshape(
            sh.batch, sh.n_nodes, -1)


@pytest.fixture(scope="module")
def cases():
    return {(a, s): Case(a, s) for a in ARCHS for s in SHAPES}


PAIRS = [(a, s) for a in ARCHS for s in SHAPES]


def test_batches_equal_the_reference(cases):
    for case in cases.values():
        assert list(case.batch) == list(case.jbatch)
        for k, v in case.batch.items():
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(case.jbatch[k]))


@pytest.mark.parametrize("arch_id,shape", PAIRS)
def test_logits_loss_and_gradients_equal_the_reference(cases, arch_id,
                                                       shape):
    case = cases[(arch_id, shape)]
    np.testing.assert_allclose(case.port_logits(), case.jax_logits(),
                               rtol=1e-5, atol=1e-6)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: case.jloss(p, case.jbatch)))(case.params)
    loss, grads = gnn_common.loss_and_grads(case.model, case.share,
                                            case.batch, ShardGroup.single(CPU))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = gnn_params_from_numpy(arch_id, _np(jg), device="cpu")
    assert set(grads) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)


@pytest.mark.parametrize("arch_id,shape", PAIRS)
def test_train_step_trajectory_equals_the_reference(cases, arch_id, shape):
    """Six AdamW steps (lr 3e-3), as ``tests/test_models_gnn.py`` runs the
    reference: the losses agree step by step and fall."""
    case = cases[(arch_id, shape)]
    ocfg = JAdamWConfig(lr=3e-3)

    @jax.jit
    def jstep(p, o):
        loss, g = jax.value_and_grad(lambda q: case.jloss(q, case.jbatch))(p)
        p, o, _ = jupdate(ocfg, p, g, o)
        return p, o, loss

    params, opt = case.params, jinit(case.params)
    want = []
    for _ in range(6):
        params, opt, loss = jstep(params, opt)
        want.append(float(loss))

    model = case.arch.init_model(shape, smoke=True, device="cpu")
    model.load_state_dict(case.model.state_dict())
    step = case.arch.build_step(shape, ShardGroup.single(CPU), smoke=True,
                                opt_cfg=AdamWConfig(lr=3e-3))
    state = adamw_init(model)
    got = []
    for _ in range(6):
        state, loss = step(model, state, case.batch)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0] + 1e-6
    # The optimizer state after the steps, converted from the reference.
    jstate = adamw_state_from_numpy(arch_id, int(opt.step), _np(opt.mu),
                                    _np(opt.nu), device="cpu")
    assert int(state.step) == int(jstate.step) == 6
    for k in jstate.mu:
        np.testing.assert_allclose(state.mu[k].numpy(), jstate.mu[k].numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


def test_out_of_range_gather_clamps_like_jax():
    """JAX clamps ``x[N_pad]`` to row N_pad - 1; the port's gathers clamp
    the same way, so a padding edge's message equals the reference's."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    idx = np.array([0, 3, 5], np.int32)
    want = np.asarray(jnp.asarray(x)[jnp.asarray(idx)])
    got = torch.from_numpy(x)[common.clamp_src(torch.from_numpy(idx), 3)]
    np.testing.assert_array_equal(got.numpy(), want)
    # And the padding segment of a GIN sum is dropped either way.
    src = torch.tensor([0, 3, 3]), torch.tensor([1, 3, 3])
    agg = common.gather_scatter_sum(torch.from_numpy(x),
                                    common.clamp_src(src[0], 3), src[1], 4)
    np.testing.assert_array_equal(agg[:3].numpy()[1], x[0])


def test_segment_softmax_empty_segments_match_jax():
    """Empty segments and all -inf segments: segment_max gives -inf there,
    which maps to 0; every weight is finite and each non-empty segment's
    weights sum to one."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((12, 2)).astype(np.float32)
    logits[5:7] = -np.inf
    seg = np.array([0, 0, 2, 2, 2, 4, 4, 1, 1, 6, 6, 6], np.int32)
    want = np.asarray(jsoftmax(jnp.asarray(logits), jnp.asarray(seg), 8))
    got = common.segment_softmax(torch.from_numpy(logits),
                                 torch.from_numpy(seg), 8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.all(np.isfinite(got)) and np.all(got[5:7] == 0)


def test_scatter_mean_matches_jax():
    from repro.models.gnn.common import scatter_mean as jscatter_mean
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((10, 3)).astype(np.float32)
    seg = rng.integers(0, 6, 10).astype(np.int32)
    for v in (vals, vals[:, 0]):
        want = np.asarray(jscatter_mean(jnp.asarray(v), jnp.asarray(seg), 6))
        got = common.scatter_mean(torch.from_numpy(np.ascontiguousarray(v)),
                                  torch.from_numpy(seg), 6).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_chunked_gather_scatter_equals_one_block(monkeypatch):
    """``gather_scatter_sum`` in blocks of a few edges gives the sums and
    gradients of one block (float64: exact up to association)."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((20, 3)), requires_grad=True)
    src = torch.from_numpy(rng.integers(0, 20, 77).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, 21, 77).astype(np.int32))
    w = torch.tensor(rng.standard_normal((21, 3)))
    whole = common.gather_scatter_sum(x, src, dst, 21)
    (gw,) = torch.autograd.grad((whole * w).sum(), x)
    monkeypatch.setattr(common, "EDGE_CHUNK", 8)
    part = common.gather_scatter_sum(x, src, dst, 21)
    (gp,) = torch.autograd.grad((part * w).sum(), x)
    np.testing.assert_allclose(part.detach().numpy(), whole.detach().numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(gp.numpy(), gw.numpy(), rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampler_is_byte_identical(seed):
    rng0 = np.random.default_rng(seed)
    n, deg = 300, 9
    indptr = np.arange(0, deg * n + 1, deg)
    indices = rng0.integers(0, n, deg * n)
    indices[:deg] = 0                                   # a self-loop row
    seeds = rng0.choice(n, 12, replace=False)
    want = jsampler.sample_block(indptr, indices, seeds, (4, 3),
                                 np.random.default_rng(seed + 10))
    got = sampler.sample_block(indptr, indices, seeds, (4, 3),
                               np.random.default_rng(seed + 10))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name
    assert (sampler.block_capacity(32, (15, 10))
            == jsampler.block_capacity(32, (15, 10)) == (5312, 5280))


def test_tables_equal_the_reference():
    for port, ref in ((gnn_common.GNN_SHAPES, jcommon.GNN_SHAPES),
                      (gnn_common.GNN_SMOKE_SHAPES, jcommon.GNN_SMOKE_SHAPES)):
        assert list(port) == list(ref)
        for k in ref:
            assert dataclasses.asdict(port[k]) == dataclasses.asdict(ref[k])
            assert (gnn_common.triplet_cap(k, port[k])
                    == jcommon.triplet_cap(k, ref[k]))
    for x in (0, 1, 511, 512, 513, 2449029, 61859140):
        assert gnn_common.pad512(x) == jcommon.pad512(x)


@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_input_specs_and_splits_equal_the_reference(arch_id):
    from repro.compat import make_mesh
    jarch, arch = ARCHS[arch_id][0].ARCH, ARCHS[arch_id][1].ARCH
    mesh = make_mesh((1, 1), ("data", "model"))
    for smoke in (False, True):
        for shape in SHAPES:
            want = jarch.input_specs(shape, smoke=smoke)
            got = arch.input_specs(shape, smoke=smoke)
            assert list(got) == list(want)
            for k, (s, dt) in got.items():
                assert s == want[k].shape
                assert str(dt).split(".")[-1] == str(want[k].dtype)
            pspecs = jcommon.gnn_batch_pspecs(shape, mesh, want)
            split = gnn_common.gnn_batch_split(shape, got)
            for k, p in pspecs.items():
                assert split[k] == (None if p[0] is None else 0), (shape, k)
    # The rule's one owner, at the reference's GraphBatch-level pspecs: a
    # node-sharded full graph splits each field it has on dim 0, a leading
    # batch splits dim 0 of every field.
    for ns in (True, False):
        want = jrules.gnn_batch_pspecs(mesh, node_sharded=ns,
                                       leading_batch=not ns)
        specs = {k: ((2,) * len(p), "float32") for k, p in want.items()
                 if p is not None and len(p)}
        got = rules.graph_batch_split(specs, node_sharded=ns)
        for k in specs:
            assert got[k] == (None if want[k][0] is None else 0), k
    assert rules.graph_batch_split({"labels": ((1,), "float32")},
                                   node_sharded=True) == {"labels": None}


def test_halo_variant_dispatches_to_the_halo_step():
    from repro_torch.core import gnn_halo
    step = gin_tu.ARCH.build_step("full_graph_sm", ShardGroup.single(CPU),
                                  smoke=True, variant=("halo",))
    assert tuple(step.split) == gnn_halo.HALO_FIELDS["gin-tu"]
    # gat-cora and the batched shapes keep the plain step.
    for arch, shape in ((gat_cora.ARCH, "full_graph_sm"),
                        (gin_tu.ARCH, "molecule")):
        s = arch.build_step(shape, ShardGroup.single(CPU), smoke=True,
                            variant=("halo",))
        assert tuple(s.split) == tuple(arch.input_specs(shape, smoke=True))
    with pytest.raises(ValueError, match="gin-tu"):
        gnn_halo.build_halo_step("gat-cora", "full_graph_sm",
                                 ShardGroup.single(CPU), n_valid=8,
                                 smoke=True)


def test_converter_refuses_other_architectures():
    """The four GNN architectures are ported; any other id is refused with
    the list of the ported ones."""
    with pytest.raises(ValueError, match="gemma3-12b.*dimenet"):
        gnn_params_from_numpy("gemma3-12b", {}, device="cpu")
