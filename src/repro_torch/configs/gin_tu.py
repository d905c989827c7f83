"""gin-tu [gnn]: 5 layers, d_hidden=64, sum aggregator, learnable eps.
[arXiv:1810.00826; paper]

Node classification on the full-graph / sampled shapes; TU-style graph
classification on the `molecule` shape (its native benchmark setting).
Each loss returns this rank's share of the reference's loss (see
``configs.gnn_common``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.gnn_common import (GNNArch, GNNShape, full_graph,
                                            merged_graph, node_exchange)
from repro_torch.models.gnn import gin
from repro_torch.models.gnn.common import node_nll, segment_sum


def _config(sh: GNNShape, smoke: bool) -> gin.GINConfig:
    if smoke:
        return gin.GINConfig(name="gin-tu-smoke", n_layers=2, d_hidden=16,
                             d_feat=sh.d_feat, n_classes=sh.n_classes)
    return gin.GINConfig(name="gin-tu", n_layers=5, d_hidden=64,
                         d_feat=sh.d_feat, n_classes=sh.n_classes)


def _loss(cfg: gin.GINConfig, sh: GNNShape, shape_name: str):
    if sh.kind == "full":
        def share(model, batch, group):
            g, rows = full_graph(batch, group, sh.n_nodes)
            logits = model.head(model.embed(g, node_exchange(group)))
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

    # molecule: graph classification (graph-level readout, label per graph).
    def share(model, batch, group):
        g = merged_graph(batch)
        pooled = segment_sum(model.embed(g), g.graph_id, g.n_graphs)
        return node_nll(model.head(pooled), g.labels).sum() / sh.batch
    return share


ARCH = GNNArch(
    arch_id="gin-tu",
    needs_positions=False,
    needs_triplets=False,
    label_kind="node",
    label_kind_overrides={"molecule": "graph_class"},
    make_config=_config,
    make_loss=_loss,
    make_model=lambda cfg, seed, device: gin.GIN(cfg, seed, device),
)
