"""dimenet [gnn]: 6 blocks, d_hidden=128, n_bilinear=8, n_spherical=7,
n_radial=6 — directional message passing over triplets.  [arXiv:2003.03123]

Graph-level regression everywhere (DimeNet's native task).  Non-geometric
shapes use random positions; triplet lists are capacity-capped on the
web-scale shapes.  Each loss returns this rank's share of the reference's
loss (see ``configs.gnn_common``); the batched kinds run as one merged
graph (its triplets offset with the edges), whose part b's output row is
the reference's per-part row 0.  A full graph runs on one rank: its
triplets index edges across the whole graph, and the split layout of
edges and triplets over ranks is not ported.
"""

from __future__ import annotations

import torch

from repro_torch.configs.gnn_common import GNNArch, GNNShape, merged_graph
from repro_torch.models.gnn import dimenet
from repro_torch.models.gnn.common import GraphBatch


def _config(sh: GNNShape, smoke: bool) -> dimenet.DimeNetConfig:
    if smoke:
        return dimenet.DimeNetConfig(
            name="dimenet-smoke", n_blocks=2, d_hidden=16, n_bilinear=4,
            n_spherical=3, n_radial=4, d_feat=sh.d_feat)
    return dimenet.DimeNetConfig(
        name="dimenet", n_blocks=6, d_hidden=128, n_bilinear=8,
        n_spherical=7, n_radial=6, d_feat=sh.d_feat)


def _loss(cfg: dimenet.DimeNetConfig, sh: GNNShape, shape_name: str):
    if sh.kind == "full":
        def share(model, batch, group):
            if group.world_size != 1:
                raise ValueError("dimenet runs a full graph on one rank; "
                                 f"got a group of {group.world_size}")
            nf = batch["node_feat"]
            n_pad = nf.shape[0]
            g = GraphBatch(
                node_feat=nf, edge_src=batch["edge_src"],
                edge_dst=batch["edge_dst"], n_nodes=sh.n_nodes,
                labels=batch["labels"],
                graph_id=torch.zeros(n_pad, dtype=torch.int64,
                                     device=nf.device),
                n_graphs=1, positions=batch["positions"])
            pred = model(g, batch["t_kj"], batch["t_ji"])   # (n_pad, 1)
            return torch.square(pred[0, 0] - batch["labels"][0])
        return share

    def share(model, batch, group):
        g = merged_graph(batch)
        pred = model(g, g.t_kj, g.t_ji)[:g.n_graphs, 0]     # (B,)
        return torch.sum(torch.square(pred - g.labels)) / sh.batch
    return share


ARCH = GNNArch(
    arch_id="dimenet",
    needs_positions=True,
    needs_triplets=True,
    label_kind="graph",
    make_config=_config,
    make_loss=_loss,
    make_model=lambda cfg, seed, device: dimenet.DimeNet(cfg, seed, device),
)
