"""DimeNet of the PyTorch port (``repro_torch.models.gnn.dimenet``,
``repro_torch.configs.dimenet_cfg``) against the JAX package, on the CPU
at the smoke shapes.

Tolerances: ``_sph_jl`` within 1e-6 relative (and 1e-5 of the largest
value absolute) of the reference on both sides of its Taylor switch and,
in float64, within 1e-9 of scipy's ``spherical_jn`` above it;
``_bessel_zeros`` equal to the reference's; the RBF and SBF bases rtol
1e-5 / atol 1e-6; ``build_triplets_host`` array for array, truncation and
padding included; outputs rtol 1e-5 / atol 1e-5 (graph energies sum over
every edge); loss rtol 1e-5; gradients rtol 1e-4 with an atol of 1e-4
times the largest reference entry; a 6-step AdamW loss trajectory rtol
1e-4 and its first moments rtol 1e-3 / atol 1e-6; energies under a global
rotation and translation of the positions within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _gnn_parity import CPU, Case, assert_grads_close
from repro.configs import dimenet_cfg as jdimenet_cfg
from repro.models.gnn import dimenet as jdn

from repro_torch.configs import dimenet_cfg
from repro_torch.configs.gnn_common import GNN_SMOKE_SHAPES, merged_graph
from repro_torch.models.gnn import dimenet
from repro_torch.models.gnn.common import GraphBatch

SHAPES = list(GNN_SMOKE_SHAPES)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("l", range(7))
def test_spherical_bessel_on_both_sides_of_the_switch(l):
    from scipy import special
    thresh = max(0.5, 0.55 * l + 0.5)
    x = np.concatenate([np.linspace(0.0, thresh, 40, endpoint=False),
                        [thresh - 1e-4, thresh, thresh + 1e-4],
                        np.linspace(thresh, 25.0, 80)]).astype(np.float32)
    want = np.asarray(jdn._sph_jl(l, jnp.asarray(x)))
    got = dimenet._sph_jl(l, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-5 * np.abs(want).max())
    big = x.astype(np.float64) >= thresh
    got64 = dimenet._sph_jl(l, torch.from_numpy(x.astype(np.float64))).numpy()
    np.testing.assert_allclose(got64[big],
                               special.spherical_jn(l, x[big].astype(
                                   np.float64)), rtol=1e-9, atol=1e-9)


def test_bessel_zeros_equal_the_reference():
    for n_l, n_n in ((3, 4), (7, 6)):
        got = dimenet._bessel_zeros(n_l, n_n)
        np.testing.assert_array_equal(got, jdn._bessel_zeros(n_l, n_n))
        assert got.shape == (n_l, n_n)


def test_radial_and_spherical_bases_equal_the_reference():
    rng = np.random.default_rng(0)
    d = np.concatenate([[0.0, 1e-9, 5.0, 6.0],
                        rng.uniform(0, 6, 60)]).astype(np.float32)
    cos_a = rng.uniform(-1, 1, d.size).astype(np.float32)
    cos_a[:2] = [-1.0, 1.0]
    for n_radial, cutoff in ((4, 5.0), (6, 5.0)):
        want = np.asarray(jdn.rbf_basis(jnp.asarray(d), n_radial, cutoff))
        got = dimenet.rbf_basis(torch.from_numpy(d), n_radial, cutoff)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        assert np.all(got.numpy()[d >= cutoff] == 0)
    for n_sph, n_radial in ((3, 4), (7, 6)):
        want = np.asarray(jdn.sbf_basis(jnp.asarray(d), jnp.asarray(cos_a),
                                        n_sph, n_radial, 5.0))
        got = dimenet.sbf_basis(torch.from_numpy(d), torch.from_numpy(cos_a),
                                n_sph, n_radial, 5.0).numpy()
        assert got.shape == (d.size, n_sph * n_radial)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed,n,e,n_edges,cap", [
    (0, 12, 40, 40, 4096),          # all wedges, padded
    (1, 12, 40, 40, 25),            # truncated at cap
    (2, 30, 64, 60, 256),           # the molecule cap; 4 dead tail slots
    (3, 5, 30, 30, 1000),           # dense: self loops, duplicates
    (4, 50, 0, 0, 8),               # no edges: all padding
])
def test_triplets_equal_the_reference(seed, n, e, n_edges, cap):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    src[n_edges:] = dst[n_edges:] = n             # padding slots
    want = jdn.build_triplets_host(src, dst, n_edges, cap)
    got = dimenet.build_triplets_host(src, dst, n_edges, cap)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32 and a.shape == (cap,)
        np.testing.assert_array_equal(a, b)


def test_triplets_in_small_passes_equal_one_pass(monkeypatch):
    rng = np.random.default_rng(5)
    src = rng.integers(0, 40, 300).astype(np.int32)
    dst = rng.integers(0, 40, 300).astype(np.int32)
    whole = dimenet.build_triplets_host(src, dst, 300, 5000)
    want = jdn.build_triplets_host(src, dst, 300, 5000)
    monkeypatch.setattr(dimenet, "TRIPLET_CHUNK", 7)
    for cap in (5000, 333):
        part = dimenet.build_triplets_host(src, dst, 300, cap)
        for a, b, c in zip(part, whole, want):
            np.testing.assert_array_equal(a, b[:cap] if cap < 5000 else b)
            np.testing.assert_array_equal(a[:cap], c[:cap])


def test_merged_graph_offsets_the_triplets():
    """Part b's triplet ids move by b·e; the padding id e becomes B·e."""
    b, n, e, t = 3, 4, 5, 6
    rng = np.random.default_rng(6)
    tkj = rng.integers(0, e + 1, (b, t)).astype(np.int32)
    batch = {"node_feat": torch.zeros(b, n, 2),
             "edge_src": torch.zeros(b, e, dtype=torch.int32),
             "edge_dst": torch.zeros(b, e, dtype=torch.int32),
             "labels": torch.zeros(b), "positions": torch.zeros(b, n, 3),
             "t_kj": torch.from_numpy(tkj),
             "t_ji": torch.from_numpy(tkj[::-1].copy())}
    g = merged_graph(batch)
    want = np.where(tkj < e, tkj + np.arange(b)[:, None] * e, b * e)
    np.testing.assert_array_equal(g.t_kj.numpy(), want.reshape(-1))
    np.testing.assert_array_equal(
        g.t_ji.numpy(), np.where(tkj[::-1] < e, tkj[::-1]
                                 + np.arange(b)[:, None] * e,
                                 b * e).reshape(-1))
    assert g.positions.shape == (b * n, 3)


@pytest.fixture(scope="module")
def cases():
    return {s: Case(jdimenet_cfg, jdn, dimenet_cfg, s, graph_level=True)
            for s in SHAPES}


def test_batches_equal_the_reference(cases):
    for case in cases.values():
        assert list(case.batch) == list(case.jbatch)
        for k, v in case.batch.items():
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(case.jbatch[k]))


@pytest.mark.parametrize("shape", SHAPES)
def test_outputs_loss_and_gradients_equal_the_reference(cases, shape):
    case = cases[shape]
    out, jl, jg = case.jax_outputs_loss_and_grads()
    np.testing.assert_allclose(case.port_outputs(), out, rtol=1e-5,
                               atol=1e-5)
    loss, grads = case.port_loss_and_grads()
    assert float(loss) == pytest.approx(jl, rel=1e-5)
    assert_grads_close(grads, case.convert(jg))


def test_loss_fn_equals_the_reference(cases):
    """``DimeNet.loss`` against the reference's ``loss_fn`` on the
    full_graph_sm batch (the masked mean squared error of row 0)."""
    from repro.models.gnn.common import GraphBatch as JGraph
    case = cases["full_graph_sm"]
    b = case.batch
    n = b["node_feat"].shape[0]
    g = GraphBatch(node_feat=b["node_feat"], edge_src=b["edge_src"],
                   edge_dst=b["edge_dst"], n_nodes=case.sh.n_nodes,
                   labels=b["labels"],
                   graph_id=torch.zeros(n, dtype=torch.int64), n_graphs=1,
                   positions=b["positions"])
    jg = JGraph(*(jnp.asarray(x.numpy()) if torch.is_tensor(x)
                  else jnp.int32(x) for x in g[:7]),
                positions=jnp.asarray(b["positions"].numpy()))
    tri = [jnp.asarray(b[k].numpy()) for k in ("t_kj", "t_ji")]
    want = float(jax.jit(lambda p: jdn.loss_fn(case.jcfg, p, jg, *tri))(
        case.params))
    got = float(case.model.loss(g, b["t_kj"], b["t_ji"]))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_train_step_trajectory_equals_the_reference(cases, shape):
    """Six AdamW steps (lr 3e-3): the losses agree step by step and
    fall."""
    got, want, state, jstate = cases[shape].trajectories()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0] + 1e-6
    assert int(state.step) == int(jstate.step) == 6
    for k in jstate.mu:
        np.testing.assert_allclose(state.mu[k].numpy(), jstate.mu[k].numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


def test_energies_invariant_under_rotation_and_translation():
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(8)
    n, e = 20, 60
    cfg = dimenet.DimeNetConfig(n_blocks=2, d_hidden=16, n_bilinear=4,
                                n_spherical=7, n_radial=6, d_feat=8)
    model = dimenet.DimeNet(cfg, seed=4, device=CPU)
    nf = rng.standard_normal((n, 8)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    tkj, tji = dimenet.build_triplets_host(src, dst, e, 4 * e)
    pos = (2 * rng.standard_normal((n, 3))).astype(np.float32)
    rot = Rotation.from_euler("zyx", [1.2, 0.4, -2.5]).as_matrix()
    moved = (pos @ rot.T + np.array([-3.0, 0.5, 1.25])).astype(np.float32)

    def energy(p):
        g = GraphBatch(node_feat=torch.from_numpy(nf),
                       edge_src=torch.from_numpy(src),
                       edge_dst=torch.from_numpy(dst), n_nodes=n,
                       labels=torch.zeros(1), graph_id=torch.zeros(
                           n, dtype=torch.int64), n_graphs=1,
                       positions=torch.from_numpy(p))
        with torch.no_grad():
            return float(model(g, torch.from_numpy(tkj),
                               torch.from_numpy(tji))[0, 0])

    e1 = energy(pos)
    assert energy(moved) == pytest.approx(e1, rel=1e-4, abs=1e-5)


def test_full_graph_runs_on_one_rank_only():
    import dataclasses
    from repro_torch import ShardGroup
    sh = GNN_SMOKE_SHAPES["full_graph_sm"]
    share = dimenet_cfg.ARCH.make_loss(dimenet_cfg._config(sh, True), sh,
                                       "full_graph_sm")
    two = dataclasses.replace(ShardGroup.single(CPU), world_size=2)
    with pytest.raises(ValueError, match="one rank"):
        share(None, {}, two)
