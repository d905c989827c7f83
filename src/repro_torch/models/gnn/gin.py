"""GIN (Graph Isomorphism Network, arXiv:1810.00826) of the PyTorch port
(``repro.models.gnn.gin``): sum aggregation + learnable epsilon + 2-layer
MLP per layer.  gin-tu config: 5 layers, d=64.

The sum aggregation is ``gather_scatter_sum`` onto ``N_pad + 1`` rows (the
last is the padding edges' sentinel, dropped)."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.graph import resolve_device
from repro_torch.models.gnn.common import (LOCAL, MLP, GraphBatch,
                                           clamp_src, gather_scatter_sum,
                                           node_ce_loss, segment_sum)


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_hidden: int = 64
    d_feat: int = 64
    n_classes: int = 16
    graph_level: bool = False  # graph classification (TU datasets) vs node


class GINLayer(nn.Module):
    """``mlp((1 + eps) * x + agg)`` with a learnable scalar ``eps``."""

    def __init__(self, d_in: int, d_hidden: int, generator):
        super().__init__()
        self.mlp = MLP([d_in, d_hidden, d_hidden], generator)
        self.eps = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
        return self.mlp((1.0 + self.eps) * x + agg)


class GIN(nn.Module):
    """Parameters ``layers.{i}.mlp.{w,b}.{j}``, ``layers.{i}.eps`` and
    ``head.{w,b}.0``, drawn from ``torch.Generator().manual_seed(seed)`` on
    the host and moved to ``device`` (the card unless the caller asks for
    the CPU)."""

    def __init__(self, cfg: GINConfig, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        d_in = cfg.d_feat
        layers = []
        for _ in range(cfg.n_layers):
            layers.append(GINLayer(d_in, cfg.d_hidden, gen))
            d_in = cfg.d_hidden
        self.layers = nn.ModuleList(layers)
        self.head = MLP([cfg.d_hidden, cfg.n_classes], gen)
        self.to(dev)

    def embed(self, g: GraphBatch, nodes=LOCAL) -> torch.Tensor:
        """The node states after the last layer, (N_pad, d_hidden): of the
        owned rows when ``nodes`` splits the graph's nodes over ranks (each
        layer gathers every row and scatters back the owned rows' sums;
        edge ids are global)."""
        x = g.node_feat
        src = None
        for layer in self.layers:
            x_all = nodes.gather(x)
            n_all = x_all.shape[0]
            if src is None:
                src = clamp_src(g.edge_src, n_all)
            agg = gather_scatter_sum(x_all, src, g.edge_dst,
                                     n_all + 1)[:n_all]
            x = layer(x, nodes.scatter(agg))
        return x

    def forward(self, g: GraphBatch) -> torch.Tensor:
        x = self.embed(g)
        if self.cfg.graph_level:
            # Only the first n_graphs rows are meaningful.
            x = segment_sum(x, g.graph_id, int(g.graph_id.shape[0]))
        return self.head(x)

    def loss(self, g: GraphBatch) -> torch.Tensor:
        logits = self(g)
        rows = torch.arange(logits.shape[0], device=logits.device)
        if self.cfg.graph_level:
            mask = (rows < g.n_graphs).to(logits.dtype)
            return node_ce_loss(logits, g.labels[: logits.shape[0]], mask)
        return node_ce_loss(logits, g.labels,
                            (rows < g.n_nodes).to(logits.dtype))
