"""equiformer-v2 [gnn]: 12 layers, d_hidden=128 sphere channels, l_max=6,
m_max=2, 8 heads — SO(2)-eSCN equivariant graph attention.
[arXiv:2306.12059; unverified]

Node classification on full/sampled shapes (node head over the l=0
channel), energy regression on `molecule`.  Positions are required
(random for the non-geometric shapes).  Each loss returns this rank's
share of the reference's loss (see ``configs.gnn_common``); the batched
kinds run as one merged graph, whose part b's output row is the
reference's per-part row 0.
"""

from __future__ import annotations

import torch

from repro_torch.configs.gnn_common import (GNNArch, GNNShape, full_graph,
                                            merged_graph, node_exchange)
from repro_torch.models.gnn import equiformer
from repro_torch.models.gnn.common import node_nll


def _config(sh: GNNShape, smoke: bool) -> equiformer.EquiformerConfig:
    node_level = sh.kind != "molecule"
    out = sh.n_classes if node_level else 1
    if smoke:
        # l_max=2/m_max=1 still exercise the SO(2) path.
        return equiformer.EquiformerConfig(
            name="equiformer-v2-smoke", n_layers=2, d_hidden=8, l_max=2,
            m_max=1, n_heads=2, d_feat=sh.d_feat, out_dim=out,
            node_level=node_level)
    return equiformer.EquiformerConfig(
        name="equiformer-v2", n_layers=12, d_hidden=128, l_max=6, m_max=2,
        n_heads=8, d_feat=sh.d_feat, out_dim=out, node_level=node_level)


def _loss(cfg: equiformer.EquiformerConfig, sh: GNNShape, shape_name: str):
    if sh.kind == "full":
        def share(model, batch, group):
            g, rows = full_graph(batch, group, sh.n_nodes)
            logits = model(g, node_exchange(group))
            mask = (rows < g.n_nodes).to(logits.dtype)
            return (torch.sum(node_nll(logits, g.labels) * mask)
                    / max(sh.n_nodes, 1))
        return share

    if sh.kind == "blocks":
        def share(model, batch, group):
            g = merged_graph(batch)
            nll = node_nll(model(g), g.labels).view(g.n_graphs, sh.n_nodes)
            mask = (torch.arange(sh.n_nodes, device=nll.device)
                    < sh.n_seeds).to(nll.dtype)
            per = (nll * mask).sum(1) / max(min(sh.n_seeds, sh.n_nodes), 1)
            return per.sum() / sh.batch
        return share

    # molecule: per-graph energy regression.
    def share(model, batch, group):
        g = merged_graph(batch)
        pred = model(g)[:g.n_graphs, 0]
        return torch.sum(torch.square(pred - g.labels)) / sh.batch
    return share


ARCH = GNNArch(
    arch_id="equiformer-v2",
    needs_positions=True,
    needs_triplets=False,
    label_kind="node",
    label_kind_overrides={"molecule": "graph"},
    make_config=_config,
    make_loss=_loss,
    make_model=lambda cfg, seed, device: equiformer.Equiformer(cfg, seed,
                                                               device),
)
