"""The GIN half of the port's halo exchange (``repro_torch.core.gnn_halo``)
and the multi-rank train steps, on the CPU.

``build_halo_inputs`` (vectorised) must equal ``repro.core.gnn_halo.
build_halo_inputs`` array for array on a Louvain-ordered caveman graph for
2, 4 and 8 shards, and raise where the reference raises.  The halo GIN loss
at world size 1 and on 4 gloo CPU ranks (one spawned launch for the
module, ``collectives.launch`` under ``RANK_TIMEOUT``) must equal the JAX
single-device ``gin`` loss on the same Louvain-ordered graph (rtol 1e-5),
the check ``tests/test_halo.py`` makes on 8 forced host devices; the 4-rank
summed gradients and step losses must equal world size 1 (gradients rtol
1e-4 with an atol of 1e-4 times the largest entry, losses rtol 1e-5),
with ``bf16_msgs`` too (bf16 against bf16 at rtol 1e-2 for gradients and
1e-3 for losses, since on 4 ranks the halo rows' gradients travel and add
up in bf16; against float32 within 2e-2);
and ``build_gnn_step``'s all-gather layout on 4 ranks (GIN, GAT and
Equiformer on a full graph, the molecule batch split over the ranks, for
DimeNet too) must equal world size 1 the same way.

The Equiformer halo step (l_max 3, m_max 1, ``tests/test_halo.py``'s
config) rides the same launch: at world size 1 its loss equals the JAX
package's ``equiformer_halo_loss_shard`` on a one-device mesh and the JAX
single-device forward (rtol 1e-5); ``m_truncate`` equals the untruncated
step (loss rtol 1e-5, gradients rtol 1e-4 with an atol of 1e-4 times the
largest entry); ``bf16_edges`` is within 1e-3 of the float32 loss and of
JAX's bf16 loss; and 4 ranks equal world size 1 as the GIN runs do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from repro.core import gnn_halo as jhalo
from repro.core.graph import from_networkx as jfrom_networkx
from repro.core.partition import louvain_partition as jlouvain_partition
from repro.models.gnn import equiformer as jequiformer, gin as jgin
from repro.models.gnn.common import GraphBatch as JGraph, node_ce_loss

from repro_torch import ShardGroup
from repro_torch.configs import dimenet_cfg, equiformer_v2, gat_cora, gin_tu
from repro_torch.core import collectives, gnn_halo
from repro_torch.core.partition import louvain_partition
from repro_torch.interop import gnn_params_from_numpy, graph_from_numpy
from repro_torch.models.gnn.common import GraphBatch

RANK_TIMEOUT = 240
RANKS = 4
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _port_graph(jg):
    return graph_from_numpy(np.asarray(jg.indptr), np.asarray(jg.indices),
                            np.asarray(jg.weights), np.asarray(jg.src),
                            int(jg.n_valid), int(jg.e_valid), device="cpu")


def _edges(jg):
    e = int(jg.e_valid)
    return np.asarray(jg.src)[:e], np.asarray(jg.indices)[:e]


@pytest.fixture(scope="module")
def caveman():
    jg = jfrom_networkx(nx.connected_caveman_graph(24, 12))
    return jg, _port_graph(jg)


# ---------------------------------------------------------------------------
# build_halo_inputs
# ---------------------------------------------------------------------------

def _specs(n, e, p):
    v_l = n // p
    return [jhalo.HaloSpec(p, v_l, e, v_l),
            jhalo.make_halo_spec(n, e * p, p, 0.25)]


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_build_halo_inputs_equals_the_reference(caveman, n_shards):
    jg, tg = caveman
    order = louvain_partition(tg, n_shards).order
    np.testing.assert_array_equal(order,
                                  jlouvain_partition(jg, n_shards).order)
    src, dst = _edges(jg)
    n = int(jg.n_valid)
    built = 0
    for jspec in _specs(n, len(src), n_shards):
        spec = gnn_halo.HaloSpec(**dataclasses.asdict(jspec))
        args = (src, dst, order, n_shards, n, len(src) * n_shards)
        try:
            want = jhalo.build_halo_inputs(*args, jspec)
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                gnn_halo.build_halo_inputs(*args, spec, device="cpu")
            assert str(got.value) == str(exc)
            continue
        got = gnn_halo.build_halo_inputs(*args, spec, device="cpu")
        built += 1
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        counts = gnn_halo.halo_counts(src, dst, order, n_shards,
                                      spec.v_per_shard, device="cpu")
        assert counts.shape == (n_shards, n_shards)
        assert counts.max() <= spec.send_cap and np.all(np.diag(counts) == 0)
    assert built >= 1


@pytest.mark.parametrize("what", ["halo", "edge"])
def test_build_halo_inputs_raises_where_the_reference_raises(caveman, what):
    jg, _ = caveman
    src, dst = _edges(jg)
    n = int(jg.n_valid)
    rng = np.random.default_rng(3)
    order = rng.permutation(n).astype(np.int32)     # a bad order: big halo
    p = 4
    spec = (jhalo.HaloSpec(p, n // p, len(src), 2) if what == "halo"
            else jhalo.HaloSpec(p, n // p, len(src) // p - 1, n // p))
    with pytest.raises(ValueError) as want:
        jhalo.build_halo_inputs(src, dst, order, p, n, len(src), spec)
    with pytest.raises(ValueError) as got:
        gnn_halo.build_halo_inputs(src, dst, order, p, n, len(src),
                                   gnn_halo.HaloSpec(**dataclasses.asdict(
                                       spec)), device="cpu")
    assert str(got.value) == str(want.value)
    assert f"{what} cap" in str(got.value)


# ---------------------------------------------------------------------------
# The halo GIN against the JAX model; 4 gloo ranks against world size 1
# ---------------------------------------------------------------------------

class HaloCase:
    """connected_caveman_graph(8, 8) in its Louvain order for RANKS
    shards, the reference's halo test inputs (features, labels, GIN
    config, weights), laid out for 1 and for RANKS shards."""

    def __init__(self):
        nxg = nx.connected_caveman_graph(8, 8)
        jg = jfrom_networkx(nxg)
        self.n = n = int(jg.n_valid)
        self.order = order = louvain_partition(_port_graph(jg), RANKS).order
        self.src, self.dst = src, dst = _edges(jg)
        rng = np.random.default_rng(0)
        feat = rng.standard_normal((n, 8)).astype(np.float32)
        labels = rng.integers(0, 4, n).astype(np.int32)
        inv = np.argsort(order)
        self.feat_p, self.labels_p = feat[order], labels[order]
        self.src_p = inv[src].astype(np.int32)
        self.dst_p = inv[dst].astype(np.int32)
        self.jcfg = jgin.GINConfig(n_layers=2, d_hidden=16, d_feat=8,
                                   n_classes=4)
        self.params = jgin.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.cfg = gin_tu.gin.GINConfig(**dataclasses.asdict(self.jcfg))
        self.state = {k: v.numpy() for k, v in gnn_params_from_numpy(
            "gin-tu", jax.tree.map(np.asarray, self.params),
            device="cpu").items()}
        # Equiformer: positions, config and weights of tests/test_halo.py.
        self.pos_p = np.random.default_rng(1).standard_normal(
            (n, 3)).astype(np.float32)[order]
        self.ecfg = jequiformer.EquiformerConfig(
            n_layers=2, d_hidden=8, l_max=3, m_max=1, n_heads=2, d_feat=8,
            out_dim=4, node_level=True)
        self.eparams = jequiformer.init_params(self.ecfg,
                                               jax.random.PRNGKey(1))
        self.tcfg = equiformer_v2.equiformer.EquiformerConfig(
            **dataclasses.asdict(self.ecfg))
        self.estate = {k: v.numpy() for k, v in gnn_params_from_numpy(
            "equiformer-v2", jax.tree.map(np.asarray, self.eparams),
            device="cpu").items()}

    def jax_loss(self):
        g = JGraph(node_feat=jnp.asarray(self.feat_p),
                   edge_src=jnp.asarray(self.src_p),
                   edge_dst=jnp.asarray(self.dst_p),
                   n_nodes=jnp.int32(self.n),
                   labels=jnp.asarray(self.labels_p),
                   graph_id=jnp.zeros((self.n,), jnp.int32),
                   n_graphs=jnp.int32(1))
        logits = jgin.forward(self.jcfg, self.params, g)
        return float(node_ce_loss(logits, jnp.asarray(self.labels_p),
                                  jnp.ones((self.n,), jnp.float32)))

    def jax_equiformer_losses(self):
        """The JAX single-device forward's loss, and the JAX halo step's
        on a one-device mesh (float32, bf16 edges)."""
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P
        from repro.compat import make_mesh
        n, cfg = self.n, self.ecfg
        g = JGraph(node_feat=jnp.asarray(self.feat_p),
                   edge_src=jnp.asarray(self.src_p),
                   edge_dst=jnp.asarray(self.dst_p), n_nodes=jnp.int32(n),
                   labels=jnp.asarray(self.labels_p),
                   graph_id=jnp.zeros((n,), jnp.int32),
                   n_graphs=jnp.int32(1), positions=jnp.asarray(self.pos_p))
        ref = float(node_ce_loss(jequiformer.forward(cfg, self.eparams, g),
                                 jnp.asarray(self.labels_p),
                                 jnp.ones((n,), jnp.float32)))
        spec = jhalo.HaloSpec(1, n, len(self.src), n)
        halo = jhalo.build_halo_inputs(self.src, self.dst, self.order, 1, n,
                                       len(self.src), spec)
        mesh = make_mesh((1,), ("i",))
        out = {}
        for bf16 in (False, True):
            fn = shard_map(
                lambda p, nf, po, es, ed, lab, sidx:
                jhalo.equiformer_halo_loss_shard(
                    cfg, p, nf, po, es, ed, lab, sidx, n, spec, ("i",),
                    m_truncate=True, bf16_edges=bf16),
                mesh=mesh, in_specs=(jax.tree.map(lambda _: P(),
                                                  self.eparams),
                                     P("i", None), P("i", None), P("i"),
                                     P("i"), P("i"), P("i", None)),
                out_specs=P(), check_rep=False)
            with mesh:
                out[bf16] = float(jax.jit(fn)(
                    self.eparams, jnp.asarray(self.feat_p),
                    jnp.asarray(self.pos_p), jnp.asarray(halo["edge_src"]),
                    jnp.asarray(halo["edge_dst"]),
                    jnp.asarray(self.labels_p),
                    jnp.asarray(halo["send_idx"])))
        return ref, out[False], out[True]

    def spec(self, n_shards):
        v_l = self.n // n_shards
        return gnn_halo.HaloSpec(n_shards, v_l, len(self.src), v_l)

    def halo_run(self, n_shards, bf16=False, steps=2, arch="gin-tu",
                 m_truncate=True):
        spec = self.spec(n_shards)
        halo = gnn_halo.build_halo_inputs(
            self.src, self.dst, self.order, n_shards, self.n,
            len(self.src) * n_shards, spec, device="cpu")
        batch = {"node_feat": self.feat_p, "labels": self.labels_p,
                 **{k: halo[k] for k in ("edge_src", "edge_dst",
                                         "send_idx")}}
        run = {"arch": "gin-tu", "cfg": self.cfg, "state": self.state,
               "batch": batch, "steps": steps, "bf16": bf16,
               "halo": {"spec": spec, "n_valid": self.n,
                        "bf16_msgs": bf16}}
        if arch == "equiformer-v2":
            run.update(arch=arch, state=self.estate, cfg=self.tcfg)
            batch["positions"] = self.pos_p
            run["halo"]["m_truncate"] = m_truncate
        return run


def _step_run(arch, shape, rng_seed):
    """A ``build_gnn_step`` run of a smoke shape: its model from seed 0 and
    a batch from ``make_batch``."""
    cfg = arch.make_config(arch_shape(shape), True)
    model = arch.make_model(cfg, 0, "cpu")
    batch = arch.make_batch(shape, rng_seed, smoke=True, device="cpu")
    return {"arch": arch.arch_id, "cfg": cfg, "shape": shape, "smoke": True,
            "state": {k: v.numpy() for k, v in model.state_dict().items()},
            "batch": {k: v.numpy() for k, v in batch.items()}, "steps": 2}


def arch_shape(shape):
    from repro_torch.configs.gnn_common import GNN_SMOKE_SHAPES
    return GNN_SMOKE_SHAPES[shape]


@pytest.fixture(scope="module")
def halo_case():
    return HaloCase()


#: The Equiformer halo runs' places in ``_runs``: m_truncate, the full
#: rotation, bf16 edges.
EQ_TRUNC, EQ_FULL, EQ_BF16 = 6, 7, 8


def _runs(halo_case, n_shards):
    """The halo GIN in float32 and with bf16 messages on ``n_shards``
    shards, then ``build_gnn_step``'s all-gather layout for GIN and GAT on
    a full graph and the molecule batch split over the ranks; then the
    halo Equiformer (m_truncate, the full rotation, bf16 edges), the
    all-gather Equiformer on a full graph, and the molecule batch of
    Equiformer and DimeNet split over the ranks."""
    eq = dict(arch="equiformer-v2")
    return [halo_case.halo_run(n_shards),
            halo_case.halo_run(n_shards, bf16=True),
            _step_run(gin_tu.ARCH, "full_graph_sm", 1),
            _step_run(gat_cora.ARCH, "full_graph_sm", 2),
            _step_run(gin_tu.ARCH, "molecule", 3),
            _step_run(gat_cora.ARCH, "molecule", 4),
            halo_case.halo_run(n_shards, **eq),
            halo_case.halo_run(n_shards, m_truncate=False, **eq),
            halo_case.halo_run(n_shards, bf16=True, **eq),
            _step_run(equiformer_v2.ARCH, "full_graph_sm", 5),
            _step_run(equiformer_v2.ARCH, "molecule", 6),
            _step_run(dimenet_cfg.ARCH, "molecule", 7)]


@pytest.fixture(scope="module")
def world_of_one(halo_case):
    return gnn_halo.gnn_rank_runs(ShardGroup.single("cpu"),
                                  _runs(halo_case, 1))


@pytest.fixture(scope="module")
def four_ranks(halo_case):
    return collectives.launch(gnn_halo.gnn_rank_runs, RANKS,
                              _runs(halo_case, RANKS), backend="gloo",
                              devices=["cpu"] * RANKS, timeout=RANK_TIMEOUT)


def _same(got, want, rtol=1e-4, what=""):
    assert got["loss"] == pytest.approx(want["loss"], rel=rtol / 10), what
    scale = max(float(np.abs(g).max()) for g in want["grads"].values())
    for k, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], g, rtol=rtol,
                                   atol=rtol * scale, err_msg=f"{what} {k}")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol / 10,
                               err_msg=what)


def test_halo_loss_at_world_size_one_equals_jax(halo_case, world_of_one):
    want = halo_case.jax_loss()
    assert world_of_one["results"][0]["loss"] == pytest.approx(want,
                                                               rel=1e-5)
    # bf16 messages: close to the float32 loss, not equal.
    assert world_of_one["results"][1]["loss"] == pytest.approx(want,
                                                               rel=2e-2)


def test_halo_gradients_equal_the_plain_model(halo_case, world_of_one):
    """At world size 1 the halo step's gradients are the plain GIN's on the
    Louvain-ordered graph."""
    from repro_torch.models.gnn.gin import GIN
    model = GIN(halo_case.cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in halo_case.state.items()})
    n = halo_case.n
    g = GraphBatch(node_feat=torch.from_numpy(halo_case.feat_p),
                   edge_src=torch.from_numpy(halo_case.src_p),
                   edge_dst=torch.from_numpy(halo_case.dst_p), n_nodes=n,
                   labels=torch.from_numpy(halo_case.labels_p),
                   graph_id=torch.zeros(n, dtype=torch.int32), n_graphs=1)
    loss = model.loss(g)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    got = world_of_one["results"][0]
    assert got["loss"] == pytest.approx(float(loss.detach()), rel=1e-5)
    _same({"loss": float(loss.detach()), "losses": [],
           "grads": {k: v.numpy() for k, v in grads.items()}},
          {**got, "losses": []})


def test_halo_exchange_autograd_at_world_size_one():
    """With one shard the exchange sends ``x[send_idx]`` to itself, and its
    backward adds the halo rows' gradients into the sent rows."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((6, 3)), requires_grad=True)
    idx = torch.tensor([[4, 0, 4, 2]])
    out = gnn_halo.halo_exchange(x, idx, ShardGroup.single("cpu"))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  x.detach().numpy()[[4, 0, 4, 2]])
    w = torch.tensor(rng.standard_normal((4, 3)))
    (gx,) = torch.autograd.grad((out * w).sum(), x)
    (want,) = torch.autograd.grad((x[idx.reshape(-1)] * w).sum(), x)
    np.testing.assert_array_equal(gx.numpy(), want.numpy())


def test_four_gloo_ranks_equal_world_size_one(halo_case, world_of_one,
                                              four_ranks):
    assert len(four_ranks) == RANKS
    jax_loss = halo_case.jax_loss()
    for rank_out in four_ranks:
        runs = _runs(halo_case, 1)
        assert len(rank_out["results"]) == len(runs)
        for i, (got, want) in enumerate(zip(rank_out["results"],
                                            world_of_one["results"])):
            # bf16 messages (runs 1 and EQ_BF16): the halo rows' gradients
            # travel and add up in bf16 on 4 ranks, in float32 at world
            # size 1.
            _same(got, want, rtol=1e-2 if runs[i].get("bf16") else 1e-4,
                  what=f"run {i}")
        assert rank_out["results"][0]["loss"] == pytest.approx(jax_loss,
                                                               rel=1e-5)
        assert rank_out["results"][0]["losses"][-1] < jax_loss
        assert rank_out["staged_bytes"] == 0
    # The ranks hand over the same number of bytes (equal shapes).
    assert len({o["wire_bytes"] for o in four_ranks}) == 1


def test_halo_wire_bytes_are_the_exchange_and_the_sums(halo_case,
                                                       four_ranks):
    """Per rank and layer the halo exchange hands over P·S·d floats forward
    and the same backward; the first-loss psums add the count and the
    summed gradients."""
    spec, cfg = halo_case.spec(RANKS), halo_case.cfg
    n_params = sum(v.size for v in halo_case.state.values())
    per_call = sum(2 * spec.n_shards * spec.send_cap * d * 4
                   for d in [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers
                                                             - 1))
    # Layer 0's backward exchange is skipped: the features need no grad.
    per_call -= spec.n_shards * spec.send_cap * cfg.d_feat * 4
    psums = 4 + (n_params + 1) * 4
    # The first loss, then 2 steps: three forward + backward passes.
    for rank_out in four_ranks:
        assert rank_out["results"][0]["wire_bytes"] == 3 * (per_call
                                                              + psums)


def test_equiformer_halo_loss_at_world_size_one_equals_jax(halo_case,
                                                           world_of_one):
    ref, halo, halo_bf16 = halo_case.jax_equiformer_losses()
    assert halo == pytest.approx(ref, rel=1e-5)
    res = world_of_one["results"]
    for i in (EQ_TRUNC, EQ_FULL):
        assert res[i]["loss"] == pytest.approx(ref, rel=1e-5), i
        assert res[i]["loss"] == pytest.approx(halo, rel=1e-5), i
    # bf16 edges: close to the float32 loss and to the reference's bf16.
    assert res[EQ_BF16]["loss"] == pytest.approx(ref, rel=1e-3)
    assert res[EQ_BF16]["loss"] == pytest.approx(halo_bf16, rel=1e-3)


def test_equiformer_m_truncate_equals_the_full_rotation(world_of_one,
                                                        four_ranks):
    """The truncated rows path computes the untruncated step: the same
    loss, gradients and step losses, at world size 1 and on 4 ranks."""
    for out in [world_of_one] + four_ranks:
        _same(out["results"][EQ_TRUNC], out["results"][EQ_FULL],
              what="m_truncate")


def test_equiformer_halo_gradients_equal_the_plain_model(halo_case,
                                                         world_of_one):
    """At world size 1 the Equiformer halo step's gradients are the plain
    model's on the Louvain-ordered graph."""
    from repro_torch.models.gnn.equiformer import Equiformer
    model = Equiformer(halo_case.tcfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in halo_case.estate.items()})
    n = halo_case.n
    g = GraphBatch(node_feat=torch.from_numpy(halo_case.feat_p),
                   edge_src=torch.from_numpy(halo_case.src_p),
                   edge_dst=torch.from_numpy(halo_case.dst_p), n_nodes=n,
                   labels=torch.from_numpy(halo_case.labels_p),
                   graph_id=torch.zeros(n, dtype=torch.int32), n_graphs=1,
                   positions=torch.from_numpy(halo_case.pos_p))
    loss = model.loss(g)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    for i in (EQ_TRUNC, EQ_FULL):
        got = world_of_one["results"][i]
        _same({"loss": float(loss.detach()), "losses": [],
               "grads": {k: v.numpy() for k, v in grads.items()}},
              {**got, "losses": []}, what=f"run {i}")
