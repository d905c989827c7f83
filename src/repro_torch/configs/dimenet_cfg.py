"""dimenet [gnn]: 6 blocks, d_hidden=128, n_bilinear=8, n_spherical=7,
n_radial=6 — directional message passing over triplets.  [arXiv:2003.03123]

Graph-level regression everywhere (DimeNet's native task).  Non-geometric
shapes use random positions; triplet lists are capacity-capped on the
web-scale shapes.  Each loss returns this rank's share of the reference's
loss (see ``configs.gnn_common``); the batched kinds run as one merged
graph (its triplets offset with the edges), whose part b's output row is
the reference's per-part row 0.  A full graph splits its nodes, edges and
triplets over the ranks (dim 0, in rank order): the node exchange of
``configs.gnn_common`` moves node rows, and the same exchange over the
edge dimension moves each block's per-edge tensors to the triplets that
read them and the triplet sums back to their edges
(``models.gnn.dimenet.DimeNet.forward``); the graph's loss is rank 0's
share.
"""

from __future__ import annotations

import torch

from repro_torch.configs.gnn_common import (GNNArch, GNNShape, full_graph,
                                            merged_graph, node_exchange)
from repro_torch.models.gnn import dimenet


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
            g, _ = full_graph(batch, group, sh.n_nodes)
            split = node_exchange(group)
            pred = model(g, batch["t_kj"], batch["t_ji"], split, split)
            loss = torch.square(pred[0, 0] - batch["labels"][0])
            # The graph's loss is one number: rank 0 holds it.
            return loss if group.rank == 0 else loss * 0.0
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
