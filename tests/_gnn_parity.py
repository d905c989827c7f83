"""Shared parity harness of the geometric GNN tests
(``test_torch_equiformer.py``, ``test_torch_dimenet.py``): one (arch,
smoke shape) through the JAX package and the PyTorch port on the same
weights (``interop.gnn_params_from_numpy``) and the same batch
(``make_batch`` from the same numpy seed).

The outputs compared are the model's: node logits, or graph outputs; on
the batched kinds the reference ``vmap``s each part and keeps its row 0
(graph level) or all its rows (node level), the port runs one merged
graph, whose row b (graph level) or rows of part b are compared.  One
jitted call gives the reference's outputs, loss and gradients; a second
its AdamW trajectory.
"""

import jax
import jax.numpy as jnp
import numpy as np

from repro.models.gnn.common import GraphBatch as JGraph
from repro.optim import (AdamWConfig as JAdamWConfig, adamw_init as jinit,
                         adamw_update as jupdate)

from repro_torch import ShardGroup
from repro_torch.configs.gnn_common import (GNN_SMOKE_SHAPES, loss_and_grads,
                                            merged_graph)
from repro_torch.interop import adamw_state_from_numpy, gnn_params_from_numpy
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.optim import AdamWConfig, adamw_init

CPU = "cpu"


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


class Case:
    """One (arch, smoke shape): the JAX params, batch, loss and forward,
    and the port's model (same weights), batch (same seed) and loss
    share.  ``graph_level``: the model's output is one row per graph."""

    def __init__(self, jmod, jmodel, tmod, shape, graph_level):
        self.jarch, self.arch = jmod.ARCH, tmod.ARCH
        self.arch_id = self.arch.arch_id
        self.jforward = jmodel.forward
        self.shape, self.graph_level = shape, graph_level
        self.sh = GNN_SMOKE_SHAPES[shape]
        self.triplets = self.arch.needs_triplets
        self.jcfg = self.jarch.make_config(self.sh, True)
        self.jloss = self.jarch.make_loss(self.jcfg, self.sh, shape)
        key = jax.random.PRNGKey(0)
        self.params = self.jarch.init_params(shape, key, smoke=True)
        self.jbatch = self.jarch.make_batch(shape, key, smoke=True)
        seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
        self.batch = self.arch.make_batch(shape, seed, smoke=True,
                                          device=CPU)
        self.model = self.arch.init_model(shape, smoke=True, device=CPU)
        self.model.load_state_dict(self.convert(self.params))
        self.share = self.arch.make_loss(self.arch.make_config(self.sh, True),
                                         self.sh, shape)

    def convert(self, tree):
        return gnn_params_from_numpy(self.arch_id, np_tree(tree), device=CPU)

    def _jax_outputs(self, params):
        sh, b, cfg = self.sh, self.jbatch, self.jcfg
        tri = ("t_kj", "t_ji") if self.triplets else ()
        if sh.kind == "full":
            n_pad = b["node_feat"].shape[0]
            g = JGraph(node_feat=b["node_feat"], edge_src=b["edge_src"],
                       edge_dst=b["edge_dst"], n_nodes=jnp.int32(sh.n_nodes),
                       labels=b["labels"],
                       graph_id=jnp.zeros((n_pad,), jnp.int32),
                       n_graphs=jnp.int32(1), positions=b["positions"])
            return self.jforward(cfg, params, g, *(b[k] for k in tri))

        def one(nf, es, ed, pos, *t):
            g = JGraph(node_feat=nf, edge_src=es, edge_dst=ed,
                       n_nodes=jnp.int32(sh.n_nodes),
                       labels=jnp.zeros((sh.n_nodes,), jnp.int32),
                       graph_id=jnp.zeros((sh.n_nodes,), jnp.int32),
                       n_graphs=jnp.int32(1), positions=pos)
            out = self.jforward(cfg, params, g, *t)
            return out[0] if self.graph_level else out
        return jax.vmap(one)(b["node_feat"], b["edge_src"], b["edge_dst"],
                             b["positions"], *(b[k] for k in tri))

    def jax_outputs_loss_and_grads(self):
        """The reference's (outputs, loss, gradients) from one jitted call."""
        @jax.jit
        def run(p):
            loss, grads = jax.value_and_grad(
                lambda q: self.jloss(q, self.jbatch))(p)
            return self._jax_outputs(p), loss, grads
        out, loss, grads = run(self.params)
        return np.asarray(out), float(loss), grads

    def port_outputs(self, model=None):
        model = model or self.model
        sh, b = self.sh, self.batch
        if sh.kind == "full":
            g = GraphBatch(node_feat=b["node_feat"], edge_src=b["edge_src"],
                           edge_dst=b["edge_dst"], n_nodes=sh.n_nodes,
                           labels=b["labels"],
                           graph_id=b["edge_src"].new_zeros(
                               b["node_feat"].shape[0]),
                           n_graphs=1, positions=b["positions"])
            extra = (b["t_kj"], b["t_ji"]) if self.triplets else ()
            return model(g, *extra).detach().numpy()
        g = merged_graph(b)
        extra = (g.t_kj, g.t_ji) if self.triplets else ()
        out = model(g, *extra).detach().numpy()
        if self.graph_level:
            return out[:sh.batch]
        return out.reshape(sh.batch, sh.n_nodes, -1)

    def port_loss_and_grads(self):
        return loss_and_grads(self.model, self.share, self.batch,
                              ShardGroup.single(CPU))

    def trajectories(self, steps=6, lr=3e-3):
        """(port losses, reference losses, port AdamW state, reference
        AdamW state converted) after ``steps`` steps from the same
        weights."""
        ocfg = JAdamWConfig(lr=lr)

        @jax.jit
        def jstep(p, o):
            loss, g = jax.value_and_grad(
                lambda q: self.jloss(q, self.jbatch))(p)
            p, o, _ = jupdate(ocfg, p, g, o)
            return p, o, loss

        params, opt = self.params, jinit(self.params)
        want = []
        for _ in range(steps):
            params, opt, loss = jstep(params, opt)
            want.append(float(loss))
        model = self.arch.init_model(self.shape, smoke=True, device=CPU)
        model.load_state_dict(self.model.state_dict())
        step = self.arch.build_step(self.shape, ShardGroup.single(CPU),
                                    smoke=True, opt_cfg=AdamWConfig(lr=lr))
        state = adamw_init(model)
        got = []
        for _ in range(steps):
            state, loss = step(model, state, self.batch)
            got.append(float(loss))
        jstate = adamw_state_from_numpy(self.arch_id, int(opt.step),
                                        np_tree(opt.mu), np_tree(opt.nu),
                                        device=CPU)
        return got, want, state, jstate


def assert_grads_close(got: dict, want: dict, rtol: float = 1e-4):
    """Each gradient within ``rtol`` relative and ``rtol`` times the
    largest entry of any reference gradient absolute (entries that cancel
    to near zero carry the float32 error of the larger terms)."""
    assert set(got) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=rtol,
                                   atol=rtol * scale, err_msg=k)
