"""Shared plumbing for the GNN architectures of the PyTorch port
(``repro.configs.gnn_common``): the shape set, input specs, random batches
and the train step over a ``ShardGroup``.

The four GNN shapes all exercise *training*:

  full_graph_sm   Cora-scale full-batch        (N=2,708   E=10,556   F=1,433)
  minibatch_lg    Reddit-scale sampled blocks  (N=232,965 E=114.6M,
                                                1,024 seeds, fanout 15-10)
  ogb_products    products-scale full-batch    (N=2,449,029 E=61.9M  F=100)
  molecule        batched small graphs         (30 nodes, 64 edges, batch 128)

Layouts over the ranks of a ``ShardGroup`` (parameters replicated):
  - full graphs: nodes and edges split over the ranks (dim 0, in rank
    order); each layer all-gathers the node features and reduce-scatters
    the partial sums (the traffic of the all-gather baseline,
    O(N·d) a rank and layer; ``core/gnn_halo`` is the Louvain-ordered
    alternative);
  - minibatch: a leading batch of 32 sampled blocks (32 seeds x fanout
    15-10 each = 1,024 global seeds) split over the ranks;
  - molecule: a leading batch of 128 padded molecules split over the ranks.
A batched shape's graphs run as one graph of disjoint parts (ids offset by
part; each part's padding sentinel goes to the merged sentinel), which
computes what the reference's ``vmap`` over parts does.  Each rank
differentiates its share of the loss; the loss and the gradients are the
shares summed in rank order (``ShardGroup.psum``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.collectives import (AllGather, AllSum, ReduceScatter,
                                          ShardGroup)
from repro_torch.core.graph import resolve_device
from repro_torch.models.gnn.common import LOCAL, GraphBatch
from repro_torch.optim import AdamWConfig, adamw_apply
from repro_torch.sharding.rules import graph_batch_split

F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class GNNShape:
    kind: str                 # "full" | "blocks" | "molecule"
    n_nodes: int
    n_edges: int              # directed edge slots
    d_feat: int
    n_classes: int
    # blocks / molecule:
    batch: int = 1            # leading batch (blocks or molecules)
    n_seeds: int = 0          # seeds per block (blocks kind)
    note: str = ""


# block capacity for 32 seeds, fanout (15, 10):  nodes 32*(1+15+150)=5312,
# edges 32*(15+150)=5280 — 32 blocks x 32 seeds = 1,024 global seed nodes.
_BLOCK_SEEDS = 32
_BLOCK_N = _BLOCK_SEEDS * (1 + 15 + 15 * 10)
_BLOCK_E = _BLOCK_SEEDS * (15 + 15 * 10)

GNN_SHAPES: Dict[str, GNNShape] = {
    "full_graph_sm": GNNShape("full", 2708, 10556, 1433, 7,
                              note="Cora full-batch"),
    "minibatch_lg": GNNShape("blocks", _BLOCK_N, _BLOCK_E, 602, 41,
                             batch=32, n_seeds=_BLOCK_SEEDS,
                             note="Reddit-scale sampled; global graph "
                                  "N=232,965 E=114,615,892 lives host-side"),
    "ogb_products": GNNShape("full", 2449029, 61859140, 100, 47,
                             note="ogbn-products full-batch"),
    "molecule": GNNShape("molecule", 30, 64, 16, 8, batch=128,
                         note="batched small graphs"),
}

# Reduced shapes for smoke tests (same kinds, tiny sizes).
GNN_SMOKE_SHAPES: Dict[str, GNNShape] = {
    "full_graph_sm": GNNShape("full", 64, 256, 16, 4),
    "minibatch_lg": GNNShape("blocks", 2 * (1 + 3 + 6), 2 * (3 + 6), 16, 4,
                             batch=2, n_seeds=2),
    "ogb_products": GNNShape("full", 96, 384, 12, 5),
    "molecule": GNNShape("molecule", 10, 20, 8, 3, batch=4),
}


def shape_of(shape_name: str, smoke: bool = False) -> GNNShape:
    return (GNN_SMOKE_SHAPES if smoke else GNN_SHAPES)[shape_name]


def pad512(x: int) -> int:
    """Pad a split capacity to a multiple of 512 (every power-of-two rank
    count up to 512 divides it).  The valid prefix keeps the exact size;
    pad slots carry sentinels."""
    return -(-x // 512) * 512


def triplet_cap(shape_name: str, shape: GNNShape) -> int:
    """Static triplet capacity for DimeNet per shape (k->j->i wedges):
    molecules get 4x edges; the full-graph shapes are capped (the wedge
    count grows with sum(deg^2))."""
    if shape.kind == "full" and shape.n_edges > 1_000_000:
        return pad512(2 * shape.n_edges)
    if shape.kind == "full":
        return pad512(16 * shape.n_edges)
    return 4 * shape.n_edges


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------

def gnn_input_specs(shape_name: str, *, needs_positions: bool,
                    needs_triplets: bool, label_kind: str,
                    smoke: bool = False) -> dict:
    """``{field: (shape, dtype)}`` of one (arch x shape) batch.

    label_kind: "node" (int class per node), "graph" (float target per
    graph), "graph_class" (int class per graph).
    """
    sh = shape_of(shape_name, smoke)
    if sh.kind == "full":
        n_pad, e_pad = pad512(sh.n_nodes), pad512(sh.n_edges)
        specs = {"node_feat": ((n_pad, sh.d_feat), F32),
                 "edge_src": ((e_pad,), I32),
                 "edge_dst": ((e_pad,), I32)}
        specs["labels"] = (((n_pad,), I32) if label_kind == "node"
                           else ((1,), F32))
        if needs_positions:
            specs["positions"] = ((n_pad, 3), F32)
        if needs_triplets:
            t = triplet_cap(shape_name, sh)
            specs["t_kj"] = ((t,), I32)
            specs["t_ji"] = ((t,), I32)
        return specs
    # blocks / molecule: leading batch dim.
    b, n, e = sh.batch, sh.n_nodes, sh.n_edges
    specs = {"node_feat": ((b, n, sh.d_feat), F32),
             "edge_src": ((b, e), I32),
             "edge_dst": ((b, e), I32)}
    specs["labels"] = {"node": ((b, n), I32),
                       "graph": ((b,), F32),
                       "graph_class": ((b,), I32)}[label_kind]
    if needs_positions:
        specs["positions"] = ((b, n, 3), F32)
    if needs_triplets:
        t = triplet_cap(shape_name, sh)
        specs["t_kj"] = ((b, t), I32)
        specs["t_ji"] = ((b, t), I32)
    return specs


def gnn_batch_split(shape_name: str, specs: dict) -> Dict[str, Optional[int]]:
    """The split dimension of each batch field (``None``: replicated), the
    reference's ``gnn_batch_pspecs``: ``rules.graph_batch_split``, node
    sharded for the ``full`` kind."""
    sh = GNN_SHAPES.get(shape_name) or GNN_SMOKE_SHAPES[shape_name]
    return graph_batch_split(specs, node_sharded=sh.kind == "full")


def shard_batch(batch: dict, split: Dict[str, Optional[int]],
                group: ShardGroup) -> dict:
    """This rank's views of a global batch: each field's split dimension
    cut into ``world_size`` equal parts in rank order."""
    out = {}
    for k, x in batch.items():
        dim = split.get(k, 0)
        if dim is None or group.world_size == 1:
            out[k] = x
            continue
        n = x.shape[dim]
        if n % group.world_size:
            raise ValueError(f"batch field {k!r}: dim {dim} of size {n} "
                             f"does not split over {group.world_size} ranks")
        part = n // group.world_size
        out[k] = x.narrow(dim, group.rank * part, part)
    return out


# ---------------------------------------------------------------------------
# Node exchange of the split full graph (the all-gather baseline)
# ---------------------------------------------------------------------------

class ShardedNodes:
    """A full graph's nodes split over the ranks of ``group`` in rank order
    (the ``LocalNodes`` interface of ``models.gnn.common``); float sums
    over ranks are added in rank order."""

    def __init__(self, group: ShardGroup):
        self.group = group

    def gather(self, x):
        return AllGather.apply(x, self.group)

    def scatter(self, x):
        return ReduceScatter.apply(x, self.group)

    def all_sum(self, x):
        return AllSum.apply(x, self.group)

    def all_max(self, x):
        return self.group.pmax(x.detach())


def node_exchange(group: ShardGroup):
    """``LOCAL`` at world size 1 (no collective), else ``ShardedNodes``."""
    return LOCAL if group.world_size == 1 else ShardedNodes(group)


def full_graph(batch: dict, group: ShardGroup,
               n_valid: int) -> Tuple[GraphBatch, torch.Tensor]:
    """This rank's ``GraphBatch`` of a split full graph of ``n_valid``
    nodes (edge ids global) and the global ids of its owned rows."""
    nf = batch["node_feat"]
    v_l = nf.shape[0]
    rows = group.rank * v_l + torch.arange(v_l, device=nf.device)
    return GraphBatch(node_feat=nf, edge_src=batch["edge_src"],
                      edge_dst=batch["edge_dst"], n_nodes=n_valid,
                      labels=batch["labels"],
                      graph_id=torch.zeros(v_l, dtype=I32, device=nf.device),
                      n_graphs=1, positions=batch.get("positions")), rows


def merged_graph(batch: dict) -> GraphBatch:
    """The parts of a batched shape ((B, n, d) features, (B, e) edges with
    padding sentinel n) as one graph of B * n nodes: part b's ids offset by
    b * n, every padding id mapped to the merged sentinel B * n;
    ``graph_id`` is the part of each node; positions (B, n, 3) become
    (B * n, 3).  DimeNet's triplets ((B, t) edge ids with padding sentinel
    e) index the merged edge list the same way: part b's offset by b * e,
    the sentinel e mapped to B * e."""
    nf = batch["node_feat"]
    b, n = nf.shape[0], nf.shape[1]
    dev = nf.device
    parts = torch.arange(b, device=dev, dtype=torch.int64)[:, None]

    def ids(x, size):
        x = x.to(torch.int64)
        return torch.where(x < size, x + parts * size, b * size).reshape(-1)

    e = batch["edge_src"].shape[1]
    labels, pos = batch["labels"], batch.get("positions")
    tri = {k: ids(batch[k], e) for k in ("t_kj", "t_ji") if k in batch}
    return GraphBatch(
        node_feat=nf.reshape(b * n, -1), edge_src=ids(batch["edge_src"], n),
        edge_dst=ids(batch["edge_dst"], n), n_nodes=b * n,
        labels=labels.reshape(-1) if labels.dim() > 1 else labels,
        graph_id=torch.arange(b, device=dev).repeat_interleave(n),
        n_graphs=b, positions=None if pos is None else pos.reshape(b * n, 3),
        **tri)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def loss_and_grads(model: torch.nn.Module, loss_share: Callable, batch: dict,
                   group: ShardGroup):
    """``(loss, grads)``: ``loss_share(model, batch, group)`` is this rank's
    share of the loss; the loss and the parameter gradients (a dict keyed
    like ``model.named_parameters()``) are the shares summed over ranks in
    rank order, the same on every rank."""
    share = loss_share(model, batch, group)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(share, params)
    flat = group.psum(torch.cat([g.reshape(-1) for g in grads]
                                + [share.detach().reshape(1)]))
    out, at = {}, 0
    for name, p in zip(names, params):
        out[name] = flat[at:at + p.numel()].view(p.shape)
        at += p.numel()
    return flat[at], out


@dataclasses.dataclass
class TrainStep:
    """``step(model, opt_state, batch) -> (opt_state, loss)`` over the ranks
    of ``group``: ``batch`` is the global batch, of which each rank takes
    its views (``split``, ``shard_batch``); ``loss_share(model, local,
    group)`` is the rank's share of the loss; parameters are replicated
    and updated in place by AdamW with the summed gradients."""

    loss_share: Callable
    split: Dict[str, Optional[int]]
    group: ShardGroup
    opt_cfg: AdamWConfig = AdamWConfig()

    def loss_and_grads(self, model, batch: dict):
        """The loss and the summed gradients of ``batch`` (no update)."""
        local = shard_batch({k: batch[k] for k in self.split}, self.split,
                            self.group)
        return loss_and_grads(model, self.loss_share, local, self.group)

    def __call__(self, model, opt_state, batch: dict):
        loss, grads = self.loss_and_grads(model, batch)
        opt_state, _ = adamw_apply(self.opt_cfg, model, grads, opt_state)
        return opt_state, loss


def build_gnn_step(*, shape_name: str, group: ShardGroup,
                   loss_share: Callable, input_specs: dict,
                   opt_cfg: AdamWConfig = AdamWConfig()) -> TrainStep:
    """The train step of one (arch x shape) over the ranks of ``group``,
    each rank taking the split of ``gnn_batch_split``."""
    return TrainStep(loss_share, gnn_batch_split(shape_name, input_specs),
                     group, opt_cfg)


def gnn_archs() -> Dict[str, "GNNArch"]:
    """Every ported GNN architecture's ``ARCH`` by ``arch_id``."""
    from repro_torch.configs import (dimenet_cfg, equiformer_v2, gat_cora,
                                     gin_tu)
    return {m.ARCH.arch_id: m.ARCH
            for m in (gin_tu, gat_cora, equiformer_v2, dimenet_cfg)}


@dataclasses.dataclass(frozen=True)
class GNNArch:
    """One GNN architecture: configs + batch semantics per shape."""

    arch_id: str
    needs_positions: bool
    needs_triplets: bool
    label_kind: str              # "node" | "graph" | "graph_class"
    make_config: Callable[[GNNShape, bool], object]   # (shape, smoke) -> cfg
    #: (cfg, shape, shape_name) -> loss_share(model, batch, group).
    make_loss: Callable[[object, GNNShape, str], Callable]
    #: (cfg, seed, device) -> the model.
    make_model: Callable[[object, int, object], torch.nn.Module]
    shapes: Tuple[str, ...] = tuple(GNN_SHAPES)
    family: str = "gnn"
    skip_notes: Dict[str, str] = dataclasses.field(default_factory=dict)
    # Per-shape-kind override, e.g. GIN classifies graphs on `molecule`.
    label_kind_overrides: Dict[str, str] = dataclasses.field(
        default_factory=dict)

    def label_kind_for(self, shape: str) -> str:
        sh = GNN_SHAPES.get(shape) or GNN_SMOKE_SHAPES[shape]
        return self.label_kind_overrides.get(sh.kind, self.label_kind)

    def input_specs(self, shape: str, smoke: bool = False) -> dict:
        return gnn_input_specs(
            shape, needs_positions=self.needs_positions,
            needs_triplets=self.needs_triplets,
            label_kind=self.label_kind_for(shape), smoke=smoke)

    def build_step(self, shape: str, group: ShardGroup, smoke: bool = False,
                   variant: Tuple[str, ...] = (),
                   opt_cfg: AdamWConfig = AdamWConfig(), **halo_kwargs):
        """The ``TrainStep`` of ``build_gnn_step``.  variant ``"halo"``: the
        Louvain-partitioned halo-exchange layout on the full-graph shapes
        of gin-tu and equiformer-v2 (``core/gnn_halo.build_halo_step``,
        which takes ``halo_kwargs``), with ``"bf16_msgs"`` for bf16
        messages (Equiformer: bf16 edge tensors) and ``"no_mtrunc"`` for
        Equiformer's edge tensors over all coefficients."""
        sh = shape_of(shape, smoke)
        cfg = self.make_config(sh, smoke)
        if ("halo" in variant and sh.kind == "full"
                and self.arch_id in ("gin-tu", "equiformer-v2")):
            from repro_torch.core.gnn_halo import build_halo_step
            return build_halo_step(
                self.arch_id, shape, group, smoke=smoke, opt_cfg=opt_cfg,
                m_truncate="no_mtrunc" not in variant,
                bf16_msgs="bf16_msgs" in variant,
                **{"n_valid": sh.n_nodes, **halo_kwargs})
        return build_gnn_step(
            shape_name=shape, group=group,
            loss_share=self.make_loss(cfg, sh, shape),
            input_specs=self.input_specs(shape, smoke=smoke), opt_cfg=opt_cfg)

    def init_model(self, shape: str, seed: int = 0, smoke: bool = False,
                   device="cuda") -> torch.nn.Module:
        return self.make_model(self.make_config(shape_of(shape, smoke),
                                                smoke), seed, device)

    def make_batch(self, shape: str, seed: int, smoke: bool = False,
                   device="cuda") -> dict:
        """Random concrete batch matching ``input_specs``, drawn from
        ``np.random.default_rng(seed)`` in the reference's order (the
        reference draws ``seed`` from its JAX key)."""
        dev = resolve_device(device)
        specs = self.input_specs(shape, smoke=smoke)
        sh = shape_of(shape, smoke)
        rng = np.random.default_rng(seed)
        out = {}
        for k, (s, dtype) in specs.items():
            if k in ("edge_src", "edge_dst"):
                x = rng.integers(0, sh.n_nodes, s).astype(np.int32)
            elif k in ("t_kj", "t_ji"):
                x = rng.integers(0, sh.n_edges, s).astype(np.int32)
            elif k == "labels" and dtype == I32:
                x = rng.integers(0, sh.n_classes, s).astype(np.int32)
            else:
                x = rng.standard_normal(s).astype(np.float32)
            out[k] = torch.from_numpy(x).to(dev)
        return out
