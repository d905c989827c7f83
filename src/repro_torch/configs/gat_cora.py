"""gat-cora [gnn]: 2 layers, d_hidden=8 per head, 8 heads, attention
aggregator.  [arXiv:1710.10903; paper]

Node classification on every shape (GAT is a node classifier; the
`molecule` shape runs node-level targets over the batched graphs).  Each
loss returns this rank's share of the reference's loss (see
``configs.gnn_common``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.gnn_common import (GNNArch, GNNShape, full_graph,
                                            merged_graph, node_exchange)
from repro_torch.models.gnn import gat
from repro_torch.models.gnn.common import node_nll


def _config(sh: GNNShape, smoke: bool) -> gat.GATConfig:
    if smoke:
        return gat.GATConfig(name="gat-cora-smoke", n_layers=2, d_hidden=4,
                             n_heads=2, d_feat=sh.d_feat,
                             n_classes=sh.n_classes)
    return gat.GATConfig(name="gat-cora", n_layers=2, d_hidden=8, n_heads=8,
                         d_feat=sh.d_feat, n_classes=sh.n_classes)


def _loss(cfg: gat.GATConfig, sh: GNNShape, shape_name: str):
    if sh.kind == "full":
        def share(model, batch, group):
            g, rows = full_graph(batch, group, sh.n_nodes)
            logits = model(g, node_exchange(group))
            mask = (rows < g.n_nodes).to(logits.dtype)
            return (torch.sum(node_nll(logits, g.labels) * mask)
                    / max(sh.n_nodes, 1))
        return share

    n_masked = sh.n_seeds if sh.kind == "blocks" else sh.n_nodes

    def share(model, batch, group):
        g = merged_graph(batch)
        nll = node_nll(model(g), g.labels).view(g.n_graphs, sh.n_nodes)
        mask = (torch.arange(sh.n_nodes, device=nll.device)
                < n_masked).to(nll.dtype)
        per = (nll * mask).sum(1) / max(min(n_masked, sh.n_nodes), 1)
        return per.sum() / sh.batch
    return share


ARCH = GNNArch(
    arch_id="gat-cora",
    needs_positions=False,
    needs_triplets=False,
    label_kind="node",
    make_config=_config,
    make_loss=_loss,
    make_model=lambda cfg, seed, device: gat.GAT(cfg, seed, device),
)
