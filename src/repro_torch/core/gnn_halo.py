"""Louvain-partition-aware distributed GNN training: halo exchange
(``repro.core.gnn_halo``: gin-tu and equiformer-v2), over the ranks of a
``ShardGroup``.

The all-gather baseline for full-graph training (``configs/gnn_common``)
all-gathers the node-feature array to every rank for each layer's
gather/scatter — O(N·d) collective traffic per rank per layer.  With the
graph in Louvain order (``core/partition.louvain_partition``:
community-contiguous vertices, each rank owning a contiguous
community-aligned slice) most edges are intra-shard, and only the *halo* —
features of remote source vertices of cut edges — must move, via a single
fixed-shape ``all_to_all`` per layer:

    traffic/rank/layer = 2 · P · S · d  ·  4B      (S = per-peer halo cap)

Layout (host or card, from the partitioner, ``build_halo_inputs``):
  - vertices in Louvain order; shard p owns the contiguous slice
    [p·V_l, (p+1)·V_l);
  - edges partitioned by OWNER OF DST (so the per-dst scatter is local);
    per-shard edge arrays use LOCAL indices: dst in [0, V_l), src in
    [0, V_l + P·S] where indices >= V_l point into the received halo buffer
    (sentinel = V_l + P·S -> zero row);
  - send_idx[p, q, s]: the s-th local vertex shard p sends to shard q.

Equiformer exchanges the positions once and the normed irreps once a
layer; its edge tensors may stay in the |m| <= m_max rows the SO(2)
convolution reads (``m_truncate``) and in bf16 (``bf16_edges``).

Each rank differentiates its share of the loss (its owned vertices' NLL
over the summed count); the loss and the parameter gradients are the
shares summed over ranks in rank order, which is the gradient of the
reference's ``psum(nll) / psum(count)``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.collectives import ShardGroup
from repro_torch.core.graph import resolve_device
from repro_torch.models.gnn.common import gather_scatter_sum, node_nll


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    n_shards: int       # P
    v_per_shard: int    # V_l
    e_per_shard: int    # E_l
    send_cap: int       # S (per peer pair)

    @property
    def halo_size(self) -> int:
        return self.n_shards * self.send_cap

    @property
    def sentinel(self) -> int:          # local index of the zero row
        return self.v_per_shard + self.halo_size


def make_halo_spec(n_nodes_pad: int, n_edges_pad: int, n_shards: int,
                   halo_frac: float = 0.25) -> HaloSpec:
    v_l = n_nodes_pad // n_shards
    e_l = n_edges_pad // n_shards
    s = max(-(-int(halo_frac * v_l) // n_shards), 1)
    return HaloSpec(n_shards, v_l, e_l, s)


class _HaloExchange(torch.autograd.Function):
    """Forward: ``all_to_all`` of ``x_l[send_idx]``.  Backward: the halo
    rows' gradients go back by the reverse ``all_to_all`` and are added
    into the owners' rows."""

    @staticmethod
    def forward(ctx, x_l, send_idx_l, group):
        idx = send_idx_l.reshape(-1)
        ctx.save_for_backward(idx)
        ctx.group, ctx.rows = group, x_l.shape[0]
        return group.all_to_all(x_l.index_select(0, idx))

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        back = ctx.group.all_to_all(grad.contiguous())
        gx = back.new_zeros((ctx.rows,) + back.shape[1:])
        return gx.index_add_(0, idx, back), None, None


def halo_exchange(x_l: torch.Tensor, send_idx_l: torch.Tensor,
                  group: ShardGroup) -> torch.Tensor:
    """One halo exchange.  x_l: (V_l, ...) owned features; send_idx_l:
    (P, S) local ids to send.  Returns (P·S, ...) received features (block
    q = sent by shard q)."""
    return _HaloExchange.apply(x_l, send_idx_l, group)


def _with_halo(x_l: torch.Tensor, send_idx_l: torch.Tensor,
               group: ShardGroup) -> torch.Tensor:
    """x_full = [owned | halo | zero-sentinel-row]."""
    halo = halo_exchange(x_l, send_idx_l, group)
    zero = x_l.new_zeros((1,) + x_l.shape[1:])
    return torch.cat([x_l, halo, zero], dim=0)


# ---------------------------------------------------------------------------
# GIN halo-distributed loss (per-shard body)
# ---------------------------------------------------------------------------

def gin_halo_loss_shard(model, x_l, src_l, dst_l, labels_l, send_idx_l,
                        n_valid: int, spec: HaloSpec, group: ShardGroup,
                        bf16_msgs: bool = False) -> torch.Tensor:
    """This rank's share of the loss: GIN forward over its shard and the
    summed cross-entropy of its owned valid vertices over the count of all
    ranks' (a ``psum``).  The shares summed over ranks are the reference's
    ``psum(nll) / psum(count)``.

    bf16_msgs: exchange + gather messages at bf16, accumulate the scatter
    in the model's type (halves the edge-side traffic; MLPs stay as they
    are)."""
    v_l = spec.v_per_shard
    gidx = group.rank * v_l + torch.arange(v_l, device=x_l.device)
    x = x_l
    for layer in model.layers:
        xm = x.to(torch.bfloat16) if bf16_msgs else x
        x_full = _with_halo(xm, send_idx_l, group)
        # build_halo_inputs emits edges dst-sorted per shard.
        agg = gather_scatter_sum(x_full, src_l, dst_l, v_l + 1,
                                 out_dtype=x.dtype)[:v_l]
        x = layer(x, agg)
    logits = model.head(x)
    mask = (gidx < n_valid).to(logits.dtype)
    count = group.psum(torch.sum(mask).reshape(1))[0]
    return (torch.sum(node_nll(logits, labels_l) * mask)
            / torch.clamp(count, min=1.0))


# ---------------------------------------------------------------------------
# Equiformer halo-distributed loss (per-shard body)
# ---------------------------------------------------------------------------

def equiformer_halo_loss_shard(model, feat_l, pos_l, src_l, dst_l, labels_l,
                               send_idx_l, n_valid: int, spec: HaloSpec,
                               group: ShardGroup, m_truncate: bool = True,
                               bf16_edges: bool = False) -> torch.Tensor:
    """This rank's share of the loss: the eSCN forward over its shard
    (``EquiformerLayer``, the model's own layer) and the summed
    cross-entropy of its owned valid vertices over the count of all
    ranks'.  Geometry (positions) is exchanged once, the normed irreps
    once a layer.  ``m_truncate`` keeps the edge tensors in the |m| <=
    m_max rows the SO(2) convolution reads (Wigner blocks sliced forward,
    transposed back); ``bf16_edges`` keeps them (and the exchanged irreps)
    in bf16, the sums and the node state in the model's type."""
    from repro_torch.models.gnn.equiformer import edge_frame

    v_l = spec.v_per_shard
    gidx = group.rank * v_l + torch.arange(v_l, device=feat_l.device)

    # Edge geometry (positions exchanged once).
    pos_full = _with_halo(pos_l, send_idx_l, group)     # (V_l+H+1, 3)
    live_e = src_l < spec.sentinel
    s_ix = torch.clamp(src_l, max=spec.sentinel)
    d_ix = torch.clamp(dst_l, max=v_l - 1)
    edge_dtype = torch.bfloat16 if bf16_edges else None
    frame = edge_frame(model.cfg, pos_l[d_ix] - pos_full[s_ix], m_truncate,
                       edge_dtype)

    def pair(h):
        h_full = _with_halo(h.to(edge_dtype or h.dtype), send_idx_l, group)
        return h_full.index_select(0, s_ix), h_full.index_select(0, d_ix)

    x = model.init_irreps(feat_l)
    for layer in model.layers:
        x = layer(x, frame, pair, dst_l, v_l + 1, live_e)
    logits = model.head(x[:, 0])
    mask = (gidx < n_valid).to(logits.dtype)
    count = group.psum(torch.sum(mask).reshape(1))[0]
    return (torch.sum(node_nll(logits, labels_l) * mask)
            / torch.clamp(count, min=1.0))


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

#: The halo batch's fields by architecture; every one splits dim 0 over
#: the ranks.
HALO_FIELDS = {
    "gin-tu": ("node_feat", "edge_src", "edge_dst", "labels", "send_idx"),
    "equiformer-v2": ("node_feat", "positions", "edge_src", "edge_dst",
                      "labels", "send_idx"),
}


def build_halo_step(arch_id: str, shape_name: str, group: ShardGroup, *,
                    n_valid: int, spec: Optional[HaloSpec] = None,
                    opt_cfg=None, halo_frac: float = 0.25,
                    m_truncate: bool = True, bf16_msgs: bool = False,
                    smoke: bool = False):
    """The ``TrainStep`` of the halo-distributed full-graph gin-tu or
    equiformer-v2 over the ranks of ``group``.

    ``batch`` is the global halo layout (``HALO_FIELDS[arch_id]``:
    Louvain-ordered ``node_feat`` (n_pad, d), ``labels`` (n_pad,) and, for
    equiformer-v2, ``positions`` (n_pad, 3); ``build_halo_inputs``'
    ``edge_src`` / ``edge_dst`` (P·E_l,) and ``send_idx`` (P·P, S)); each
    rank takes its dim-0 slice.  ``spec`` defaults to ``make_halo_spec``
    of the shape's padded sizes at ``halo_frac`` with one shard per rank.
    ``bf16_msgs`` is GIN's bf16 messages and Equiformer's bf16 edges;
    ``m_truncate`` is Equiformer's."""
    from repro_torch.configs.gnn_common import TrainStep, pad512, shape_of
    from repro_torch.optim import AdamWConfig

    if arch_id not in HALO_FIELDS:
        raise ValueError(f"the halo step is ported for "
                         f"{' and '.join(HALO_FIELDS)}; got {arch_id!r}")
    if spec is None:
        sh = shape_of(shape_name, smoke)
        spec = make_halo_spec(pad512(sh.n_nodes), pad512(sh.n_edges),
                              group.world_size, halo_frac)
    if spec.n_shards != group.world_size:
        raise ValueError(f"a halo layout of {spec.n_shards} shards on "
                         f"{group.world_size} ranks")
    return TrainStep(halo_loss_share(n_valid, spec, bf16_msgs, arch_id,
                                     m_truncate),
                     dict.fromkeys(HALO_FIELDS[arch_id], 0), group,
                     opt_cfg or AdamWConfig())


def halo_loss_share(n_valid: int, spec: HaloSpec, bf16_msgs: bool = False,
                    arch_id: str = "gin-tu", m_truncate: bool = True):
    """``share(model, local_batch, group)``: ``gin_halo_loss_shard`` or
    ``equiformer_halo_loss_shard`` over a rank's slice of the halo layout
    (``HALO_FIELDS[arch_id]``)."""
    def share(model, local, group):
        if arch_id == "equiformer-v2":
            return equiformer_halo_loss_shard(
                model, local["node_feat"], local["positions"],
                local["edge_src"], local["edge_dst"], local["labels"],
                local["send_idx"], n_valid, spec, group,
                m_truncate=m_truncate, bf16_edges=bf16_msgs)
        return gin_halo_loss_shard(
            model, local["node_feat"], local["edge_src"], local["edge_dst"],
            local["labels"], local["send_idx"], n_valid, spec, group,
            bf16_msgs=bf16_msgs)
    return share


# ---------------------------------------------------------------------------
# Halo layout of real graphs
# ---------------------------------------------------------------------------

def _relabel(edge_src, edge_dst, membership_order, dev):
    order = torch.from_numpy(np.array(membership_order)).to(dev)
    inv = torch.empty_like(order)
    inv[order.to(torch.int64)] = torch.arange(order.numel(), device=dev,
                                              dtype=order.dtype)

    def ids(e):
        return inv[torch.from_numpy(np.array(e)).to(dev).to(torch.int64)]

    return ids(edge_src).to(torch.int64), ids(edge_dst).to(torch.int64)


def _send_sets(src, dst, n_shards: int, v_l: int, n_ids: int):
    """The sorted unique (q, p, s) of cut edges s -> d (q = owner of s,
    p = owner of d, q != p) as keys ``(q·P + p)·n_ids + s``, and the count
    of each (q, p) pair, (P·P,)."""
    p, q = dst // v_l, src // v_l
    cut = p != q
    keys = torch.unique((q[cut] * n_shards + p[cut]) * n_ids + src[cut])
    counts = torch.bincount(keys // n_ids, minlength=n_shards * n_shards)
    return keys, counts


def halo_counts(edge_src, edge_dst, membership_order, n_shards: int,
                v_per_shard: int, device="cuda") -> np.ndarray:
    """(P, P) host int64: entry [q, p] is the number of distinct vertices
    shard q must send to shard p (the halo that ``build_halo_inputs``
    checks against its cap)."""
    dev = resolve_device(device)
    src, dst = _relabel(edge_src, edge_dst, membership_order, dev)
    _, counts = _send_sets(src, dst, n_shards, v_per_shard,
                           len(membership_order))
    return counts.cpu().numpy().reshape(n_shards, n_shards)


def build_halo_inputs(edge_src, edge_dst, membership_order, n_shards: int,
                      n_pad: int, e_pad: int, spec: HaloSpec,
                      device="cuda") -> Dict:
    """Reorder a real graph into the halo layout, vectorised on ``device``
    (the card unless the caller asks for the CPU).

    membership_order: permutation placing vertices in Louvain order (vertex
    order[i] becomes new id i).  Returns a dict of numpy arrays matching
    build_halo_step's batch layout, equal to the reference's array for
    array (send lists sorted per (q, p), dst-stable-sorted edges per
    shard), or raises the reference's ``ValueError`` where a halo or edge
    cap overflows (caps are sized from the partition's measured cut;
    callers pick halo_frac accordingly).
    """
    dev = resolve_device(device)
    v_l, s_cap, e_l = spec.v_per_shard, spec.send_cap, spec.e_per_shard
    n_ids = len(membership_order)
    src, dst = _relabel(edge_src, edge_dst, membership_order, dev)
    keys, counts = _send_sets(src, dst, n_shards, v_l, n_ids)

    over = torch.nonzero(counts > s_cap)
    if over.numel():
        k = int(over[0, 0])
        q, p = divmod(k, n_shards)
        raise ValueError(
            f"halo cap {s_cap} exceeded ({int(counts[k])}) for "
            f"{q}->{p}; increase halo_frac")
    pair = keys // n_ids
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(keys.numel(), device=dev) - start[pair]
    q_of = pair // n_shards
    # Padding slots send local vertex 0 (duplicate sends are harmless).
    send_idx = torch.zeros(n_shards * n_shards * s_cap, dtype=torch.int32,
                           device=dev)
    send_idx[pair * s_cap + slot] = (keys % n_ids - q_of * v_l).to(
        torch.int32)

    owner = dst // v_l
    e_count = torch.bincount(owner, minlength=n_shards)
    over = torch.nonzero(e_count > e_l)
    if over.numel():
        raise ValueError(f"edge cap {e_l} exceeded on shard "
                         f"{int(over[0, 0])}")
    order_e = torch.sort(dst, stable=True).indices     # dst-sorted per shard
    s, d = src[order_e], dst[order_e]
    p = d // v_l
    q = s // v_l
    cut = q != p
    local_s = s - p * v_l
    key_e = (q[cut] * n_shards + p[cut]) * n_ids + s[cut]
    at = torch.searchsorted(keys, key_e)
    local_s[cut] = v_l + q[cut] * s_cap + (at - start[key_e // n_ids])
    e_start = torch.cumsum(e_count, 0) - e_count
    pos = p * e_l + torch.arange(d.numel(), device=dev) - e_start[p]
    es_out = torch.full((n_shards * e_l,), spec.sentinel, dtype=torch.int32,
                        device=dev)
    ed_out = torch.full((n_shards * e_l,), v_l, dtype=torch.int32,
                        device=dev)
    es_out[pos] = local_s.to(torch.int32)
    ed_out[pos] = (d - p * v_l).to(torch.int32)
    return {"edge_src": es_out.cpu().numpy(),
            "edge_dst": ed_out.cpu().numpy(),
            "send_idx": send_idx.cpu().numpy().reshape(n_shards * n_shards,
                                                       s_cap),
            "perm": membership_order}


# ---------------------------------------------------------------------------
# Spawned ranks
# ---------------------------------------------------------------------------

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def gnn_rank_runs(group: ShardGroup, runs: list) -> dict:
    """One rank of a spawned GNN run (``collectives.launch``), for each
    dict of ``runs``: ``arch`` (an ``arch_id`` of ``gnn_archs()``), ``cfg``
    (its model config), ``state`` (the model's state dict as numpy;
    without it, the weights ``make_model`` draws from seed 0, the same on
    every rank),
    ``batch`` (the global batch as numpy), and either ``shape`` /
    ``smoke`` (the arch's ``build_step``) or ``halo`` (``build_halo_step``'s
    keywords: ``spec``, ``n_valid``, ``bf16_msgs``, ``m_truncate``);
    ``steps`` AdamW steps (lr 1e-2) follow the first loss.  Each result
    holds the first loss, the summed gradients (numpy, by parameter name),
    the steps' losses, the bytes the run handed to the collectives
    (``wire_bytes``) and the host seconds of the first loss and gradients
    (``seconds``, ending in a sync on a card); the rank's totals of
    ``wire_bytes`` and ``staged_bytes`` come beside them."""
    from repro_torch.configs.gnn_common import gnn_archs
    from repro_torch.optim import AdamWConfig, adamw_init

    archs = gnn_archs()
    dev = group.device
    opt_cfg = AdamWConfig(lr=1e-2)
    out = []
    for run in runs:
        wire0 = group.wire_bytes
        arch = archs[run["arch"]]
        model = arch.make_model(run["cfg"], 0, dev)
        if "state" in run:
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in run["state"].items()})
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in run["batch"].items()}
        if "halo" in run:
            step = build_halo_step(run["arch"], "", group, opt_cfg=opt_cfg,
                                   **run["halo"])
        else:
            step = arch.build_step(run["shape"], group,
                                   smoke=run.get("smoke", False),
                                   opt_cfg=opt_cfg)
        _sync(dev)
        t = time.perf_counter()
        loss, grads = step.loss_and_grads(model, batch)
        _sync(dev)
        seconds = time.perf_counter() - t
        opt = adamw_init(model)
        losses = []
        for _ in range(run.get("steps", 0)):
            opt, lo = step(model, opt, batch)
            losses.append(float(lo))
        out.append({"loss": float(loss),
                    "grads": {k: g.cpu().numpy() for k, g in grads.items()},
                    "losses": losses, "wire_bytes": group.wire_bytes - wire0,
                    "seconds": seconds})
    return {"results": out, "wire_bytes": group.wire_bytes,
            "staged_bytes": group.staged_bytes}
