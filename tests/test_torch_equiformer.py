"""Equiformer-v2 of the PyTorch port (``repro_torch.models.gnn.wigner``,
``repro_torch.models.gnn.equiformer``, ``repro_torch.configs.
equiformer_v2``) against the JAX package, on the CPU at the smoke shapes.

Tolerances: ``rotation_to_z`` within 1e-6; the Wigner-D blocks at l_max 6
entry for entry within 2e-6 of the reference (float32: the port sums each
entry's recurrence terms in another order), each block orthogonal within
1e-5 in float32 and 1e-12 in float64; the norm and SO(2) convolution
within 1e-6 relative; logits rtol 1e-5 / atol 1e-6; loss rtol 1e-5;
gradients rtol 1e-4 with an atol of 1e-4 times the largest reference
entry; a 6-step AdamW loss trajectory rtol 1e-4 and its first moments
rtol 1e-3 / atol 1e-6; energies under a global rotation and translation of
the positions within 1e-4 relative (the reference's own invariance test
takes 1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _gnn_parity import CPU, Case, assert_grads_close, np_tree
from repro.configs import equiformer_v2 as jequiformer_v2
from repro.core import gnn_halo as jhalo
from repro.models.gnn import equiformer as jeq, wigner as jwigner

from repro_torch import ShardGroup
from repro_torch.configs import equiformer_v2
from repro_torch.configs.gnn_common import GNN_SMOKE_SHAPES
from repro_torch.core import gnn_halo
from repro_torch.interop import gnn_params_from_numpy
from repro_torch.models.gnn import equiformer, wigner
from repro_torch.models.gnn.common import GraphBatch

SHAPES = list(GNN_SMOKE_SHAPES)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _unit_vectors(seed, n):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    # A zero vector (self loops, padding), +-z, and the 0.9 switch.
    v[0] = 0.0
    v[1], v[2] = [0, 0, 1], [0, 0, -1]
    v[3] = [np.sqrt(1 - 0.81), 0, 0.9]
    v[4] = [0, np.sqrt(1 - 0.8099), 0.9 - 1e-4]
    v[3:5] /= np.linalg.norm(v[3:5], axis=1, keepdims=True)
    return v


def test_rotation_to_z_equals_the_reference():
    v = _unit_vectors(0, 64)
    want = np.asarray(jwigner.rotation_to_z(jnp.asarray(v)))
    got = wigner.rotation_to_z(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.all(got[0] == 0.0)              # the zero vector: all zeros
    z = np.einsum("eij,ej->ei", got[1:], v[1:])
    np.testing.assert_allclose(z, np.tile([0, 0, 1.0], (63, 1)), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_wigner_d_stack_equals_the_reference_at_l_max_6(seed):
    v = _unit_vectors(seed, 256)
    r = np.asarray(jwigner.rotation_to_z(jnp.asarray(v)))
    want = jwigner.wigner_d_stack(jnp.asarray(r), 6)
    got = wigner.wigner_d_stack(torch.from_numpy(r.copy()), 6)
    v64 = v.astype(np.float64)
    v64[1:] /= np.linalg.norm(v64[1:], axis=1, keepdims=True)
    got64 = wigner.wigner_d_stack(
        wigner.rotation_to_z(torch.from_numpy(v64)), 6)
    assert len(got) == len(want) == 7
    for l, (a, b, c) in enumerate(zip(got, want, got64)):
        assert a.shape == (256, 2 * l + 1, 2 * l + 1) and not a.requires_grad
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6,
                                   err_msg=f"l={l}")
        eye = np.eye(2 * l + 1)
        # Row 0 is the zero rotation: its blocks are zero past l = 0.
        for d, tol in ((a, 1e-5), (c, 1e-12)):
            d = d.double().numpy()[1:]
            np.testing.assert_allclose(d @ d.transpose(0, 2, 1),
                                       np.broadcast_to(eye, d.shape),
                                       atol=tol, err_msg=f"l={l}")
        if l:
            assert np.all(a.numpy()[0] == 0.0)


def test_block_diag_apply_whole_and_row_sliced_blocks():
    """Whole blocks: the reference's ``block_diag_apply`` both ways.
    Blocks sliced to the |m| <= m_max rows: the rows of the whole
    product forward, and the whole transpose of the zero-padded rows
    back (the halo step's ``rotate_rows`` / ``unrotate_rows``)."""
    rng = np.random.default_rng(3)
    r = np.asarray(jwigner.rotation_to_z(jnp.asarray(_unit_vectors(3, 40))))
    ds = wigner.wigner_d_stack(torch.from_numpy(r.copy()), 4)
    jds = jwigner.wigner_d_stack(jnp.asarray(r), 4)
    x = rng.standard_normal((40, 25, 6)).astype(np.float32)
    for tr in (False, True):
        want = np.asarray(jwigner.block_diag_apply(jds, jnp.asarray(x), tr))
        got = wigner.block_diag_apply(ds, torch.from_numpy(x), tr).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    sel = equiformer.truncated_rows(4, 2)
    cut = [d if l <= 2 else d[:, l - 2:l + 3] for l, d in enumerate(ds)]
    full = wigner.block_diag_apply(ds, torch.from_numpy(x))
    np.testing.assert_allclose(
        wigner.block_diag_apply(cut, torch.from_numpy(x)).numpy(),
        full[:, sel].numpy(), rtol=1e-6, atol=1e-6)
    back = wigner.block_diag_apply(cut, torch.from_numpy(x[:, sel]), True)
    padded = np.zeros_like(x)
    padded[:, sel] = x[:, sel]
    want = wigner.block_diag_apply(ds, torch.from_numpy(padded), True)
    np.testing.assert_allclose(back.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def _layer_pair(l_max, m_max, seed=0):
    jcfg = jeq.EquiformerConfig(n_layers=1, d_hidden=8, l_max=l_max,
                                m_max=m_max, n_heads=2, d_feat=4)
    params = jeq.init_params(jcfg, jax.random.PRNGKey(seed))
    model = equiformer.Equiformer(
        equiformer.EquiformerConfig(**dataclasses.asdict(jcfg)), device=CPU)
    model.load_state_dict(gnn_params_from_numpy(
        "equiformer-v2", np_tree(params), device=CPU))
    return jcfg, params["layers"][0], model.cfg, model.layers[0]


@pytest.mark.parametrize("l_max,m_max", [(2, 1), (6, 2)])
def test_norm_and_so2_convolution_equal_the_reference(l_max, m_max):
    """``_irrep_norm`` and ``_so2_conv`` against the reference's, and the
    truncated convolution against ``gnn_halo._so2_conv_truncated``."""
    jcfg, jlp, cfg, layer = _layer_pair(l_max, m_max)
    rng = np.random.default_rng(5)
    n_coef = (l_max + 1) ** 2
    x = rng.standard_normal((30, n_coef, 8)).astype(np.float32)
    want = np.asarray(jeq._irrep_norm(jnp.asarray(x), jlp["ln_scale"], l_max))
    got = equiformer._irrep_norm(torch.from_numpy(x), layer.ln_scale, l_max)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    feat = rng.standard_normal((30, n_coef, 16)).astype(np.float32)
    wmsg, wm0 = jeq._so2_conv(jcfg, jlp, jnp.asarray(feat))
    msg, m0 = equiformer._so2_conv(cfg, layer, torch.from_numpy(feat))
    np.testing.assert_allclose(msg.detach().numpy(), np.asarray(wmsg),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m0.detach().numpy(), np.asarray(wm0),
                               rtol=1e-5, atol=1e-5)
    sel = equiformer.truncated_rows(l_max, m_max)
    inv_sel = {int(f): r for r, f in enumerate(sel)}
    tmsg, tm0 = jhalo._so2_conv_truncated(jcfg, jlp, jnp.asarray(feat[:, sel]),
                                          sel, inv_sel)
    msg_t, m0_t = equiformer._so2_conv(cfg, layer,
                                       torch.from_numpy(feat[:, sel]), True)
    np.testing.assert_allclose(msg_t.detach().numpy(), np.asarray(tmsg),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(msg_t.detach().numpy(),
                                  msg.detach().numpy()[:, sel])
    np.testing.assert_array_equal(m0_t.detach().numpy(), m0.detach().numpy())


@pytest.fixture(scope="module")
def cases():
    return {s: Case(jequiformer_v2, jeq, equiformer_v2, s,
                    graph_level=s == "molecule") for s in SHAPES}


def test_batches_equal_the_reference(cases):
    for case in cases.values():
        assert list(case.batch) == list(case.jbatch)
        for k, v in case.batch.items():
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(case.jbatch[k]))


@pytest.mark.parametrize("shape", SHAPES)
def test_logits_loss_and_gradients_equal_the_reference(cases, shape):
    case = cases[shape]
    out, jl, jg = case.jax_outputs_loss_and_grads()
    np.testing.assert_allclose(case.port_outputs(), out, rtol=1e-5,
                               atol=1e-6)
    loss, grads = case.port_loss_and_grads()
    assert float(loss) == pytest.approx(jl, rel=1e-5)
    assert_grads_close(grads, case.convert(jg))


@pytest.mark.parametrize("shape,node_level", [("full_graph_sm", True),
                                              ("molecule", False)])
def test_loss_fn_equals_the_reference(cases, shape, node_level):
    """``Equiformer.loss`` against the reference's ``loss_fn`` on one
    graph: the masked node cross-entropy, or the masked mean squared error
    of the graph outputs (the first molecule of the batch)."""
    from repro.models.gnn.common import GraphBatch as JGraph
    case = cases[shape]
    b = {k: v[0] if shape == "molecule" else v for k, v in case.batch.items()}
    n = b["node_feat"].shape[0]
    labels = b["labels"] if node_level else b["labels"].reshape(1)
    g = GraphBatch(node_feat=b["node_feat"], edge_src=b["edge_src"],
                   edge_dst=b["edge_dst"], n_nodes=case.sh.n_nodes,
                   labels=labels, graph_id=torch.zeros(n, dtype=torch.int64),
                   n_graphs=1, positions=b["positions"])
    jg = JGraph(*(jnp.asarray(x.numpy()) if torch.is_tensor(x)
                  else jnp.int32(x) for x in g[:7]),
                positions=jnp.asarray(b["positions"].numpy()))
    want = float(jax.jit(lambda p: jeq.loss_fn(case.jcfg, p, jg))(
        case.params))
    assert float(case.model.loss(g)) == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_train_step_trajectory_equals_the_reference(cases, shape):
    """Six AdamW steps (lr 3e-3), as ``tests/test_models_gnn.py`` runs the
    reference: the losses agree step by step and fall."""
    got, want, state, jstate = cases[shape].trajectories()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0] + 1e-6
    assert int(state.step) == int(jstate.step) == 6
    for k in jstate.mu:
        np.testing.assert_allclose(state.mu[k].numpy(), jstate.mu[k].numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("l_max,m_max", [(2, 1), (6, 2)])
def test_energies_invariant_under_rotation_and_translation(l_max, m_max):
    """The reference's invariance test graph (20 nodes, 60 edges) with a
    global rotation and translation of the positions: the port's energy
    holds within 1e-4 relative, and equals the reference's at l_max 2."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(7)
    n, e = 20, 60
    cfg = equiformer.EquiformerConfig(n_layers=2, d_hidden=8, l_max=l_max,
                                      m_max=m_max, n_heads=2, d_feat=8)
    model = equiformer.Equiformer(cfg, seed=3, device=CPU)
    nf = rng.standard_normal((n, 8)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    rot = Rotation.from_euler("xyz", [0.3, -1.1, 2.0]).as_matrix()
    moved = (pos @ rot.T + np.array([1.5, -0.7, 2.2])).astype(np.float32)

    def energy(p):
        g = GraphBatch(node_feat=torch.from_numpy(nf),
                       edge_src=torch.from_numpy(src),
                       edge_dst=torch.from_numpy(dst), n_nodes=n,
                       labels=torch.zeros(n), graph_id=torch.zeros(
                           n, dtype=torch.int64), n_graphs=1,
                       positions=torch.from_numpy(p))
        with torch.no_grad():
            return float(model(g)[0, 0])

    e1, e2 = energy(pos), energy(moved)
    assert e2 == pytest.approx(e1, rel=1e-4, abs=1e-5)
    if l_max == 2:
        jcfg = jeq.EquiformerConfig(**dataclasses.asdict(cfg))
        from repro.models.gnn.common import GraphBatch as JGraph
        params = jax.tree.map(jnp.asarray, _params_as_tree(model))
        g = JGraph(node_feat=jnp.asarray(nf), edge_src=jnp.asarray(src),
                   edge_dst=jnp.asarray(dst), n_nodes=jnp.int32(n),
                   labels=jnp.zeros((n,)), graph_id=jnp.zeros((n,),
                                                              jnp.int32),
                   n_graphs=jnp.int32(1), positions=jnp.asarray(pos))
        want = float(jax.jit(lambda p: jeq.forward(jcfg, p, g))(params)[0, 0])
        assert e1 == pytest.approx(want, rel=1e-5)


def _params_as_tree(model):
    """The port module's weights as the reference's parameter pytree."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    def mlp(prefix):
        n = sum(1 for k in sd if k.startswith(prefix + ".w."))
        return [(sd[f"{prefix}.w.{j}"], sd[f"{prefix}.b.{j}"])
                for j in range(n)]

    layers = []
    for i in range(model.cfg.n_layers):
        p = f"layers.{i}"
        lp = {k: sd[f"{p}.{k}"] for k in ("w_m0", "ln_scale", "out_proj")}
        lp.update({k: mlp(f"{p}.{k}")
                   for k in ("rbf_mlp", "attn_mlp", "ffn_gate")})
        lp["ffn_l"] = [sd[f"{p}.ffn_l.{l}"]
                       for l in range(model.cfg.l_max + 1)]
        for m in range(1, model.cfg.m_max + 1):
            lp[f"w1_m{m}"], lp[f"w2_m{m}"] = (sd[f"{p}.w1_m{m}"],
                                              sd[f"{p}.w2_m{m}"])
        layers.append(lp)
    tree = {"embed": mlp("embed"), "layers": layers, "head": mlp("head")}
    # The reference's tree converts back to the same state.
    back = gnn_params_from_numpy("equiformer-v2", tree, device=CPU)
    assert all(np.array_equal(back[k].numpy(), v) for k, v in sd.items())
    return tree


def test_halo_variant_dispatches_to_the_equiformer_halo_step():
    step = equiformer_v2.ARCH.build_step("full_graph_sm",
                                         ShardGroup.single(CPU), smoke=True,
                                         variant=("halo", "no_mtrunc"))
    assert tuple(step.split) == gnn_halo.HALO_FIELDS["equiformer-v2"]
    assert "positions" in step.split
    plain = equiformer_v2.ARCH.build_step("molecule", ShardGroup.single(CPU),
                                          smoke=True, variant=("halo",))
    assert tuple(plain.split) == tuple(
        equiformer_v2.ARCH.input_specs("molecule", smoke=True))
