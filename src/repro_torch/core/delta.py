"""In-capacity CSR edge-batch updates of the PyTorch port
(``repro.core.delta``): the streaming half of dynamic Louvain.

A batch is a set of undirected ``{u, v} -> w`` assignments applied to the
padded ``CSRGraph`` buffers in place of capacity:

    w > 0, edge absent   -> insert
    w > 0, edge present  -> reweight (set, not add)
    w == 0               -> delete (no-op if absent)

The update is one sort-reduce over ``e_cap + 2 * b_cap`` slots: existing
directed slots (rank 0) and the batch's directed slots (rank 1 + entry
index, so later entries win ties) sort by (src, dst, rank); each group of
equal keys resolves to its highest-rank weight and compacts back into CSR
order.  Two backends resolve the sorted groups: ``"sort"`` (segment
reductions and cumsums, the reference's ``"xla"`` chain) and ``"kernel"``
(the CUDA kernel K4, or its plain version on a CPU tensor).  Both give
graphs, touched sets and edge counts equal to the reference's bit for bit.

The sort order is NOT a stable sort of the reference's concatenation.
There all forward batch slots precede all reverse ones, so a stable sort on
the (src, dst) key alone would put the forward slot of entry i before the
reverse slot of an earlier entry j < i with the same key: for the batch
``[(1, 2, w=3), (2, 1, w=5)]`` the reference resolves both directions to 5,
a key-only sort would resolve (2, 1) to 3 — an asymmetric graph.  The
single-device apply therefore interleaves the batch's directed slots as
``fwd0, rev0, fwd1, rev1, ...`` so that list order is rank order and one
stable key sort equals the reference's lexsort; a list whose ranks are out
of order gets two stable sorts (rank, then key).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.louvain_arch import resolve_apply_backend
from repro_torch.core.graph import (CSRGraph, resolve_device, scatter_slots,
                                    segment_sum)
from repro_torch.kernels.batch_apply.resolve import resolve_groups


@dataclasses.dataclass
class EdgeBatch:
    """A padded batch of undirected edge assignments on one device.

    src, dst : (b_cap,) int32 endpoints; padding slots hold ``n_cap``.
    weight   : (b_cap,) float32 new weight (0 = delete); padding slots 0.
    b_valid  : number of live entries (a host int).
    """

    src: torch.Tensor
    dst: torch.Tensor
    weight: torch.Tensor
    b_valid: int

    @property
    def b_cap(self) -> int:
        return self.src.shape[0]


def make_edge_batch(src, dst, weight, n_cap: int, b_cap: int | None = None,
                    device="cuda") -> EdgeBatch:
    """Host-side batch builder; pads to ``b_cap`` with sentinel entries and
    puts the batch on ``device``."""
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    weight = np.asarray(weight, dtype=np.float32)
    b = len(src)
    b_cap = int(b_cap if b_cap is not None else max(b, 1))
    if b_cap < b:
        raise ValueError(f"batch capacity {b_cap} below batch size {b}")
    pad = np.full(b_cap - b, n_cap, np.int32)
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return EdgeBatch(
        src=put(np.concatenate([src, pad])),
        dst=put(np.concatenate([dst, pad])),
        weight=put(np.concatenate([weight, np.zeros(b_cap - b, np.float32)])),
        b_valid=b)


def sort_slots(all_src, all_dst, all_w, rank, is_batch, sent: int):
    """Sort a unified directed-slot list by (src, dst, rank); slots with an
    endpoint >= ``sent`` key as ``(sent, sent)`` and sort last.  Returns
    ``(s_src, s_dst, s_w, s_batch)``.

    When ``rank`` is already non-decreasing in list order (the single-device
    apply builds its list so), one stable sort of the (src, dst) key is that
    order; otherwise a stable sort by rank comes first.
    """
    dead = (all_src >= sent) | (all_dst >= sent)
    k_src = torch.where(dead, sent, all_src).to(torch.int32)
    k_dst = torch.where(dead, sent, all_dst).to(torch.int32)
    key = k_src.to(torch.int64) * (sent + 1) + k_dst.to(torch.int64)
    if bool((rank[1:] >= rank[:-1]).all()):
        order = torch.sort(key, stable=True).indices
    else:
        by_rank = torch.sort(rank, stable=True).indices
        order = by_rank[torch.sort(key[by_rank], stable=True).indices]
    return k_src[order], k_dst[order], all_w[order], is_batch[order]


def sort_reduce_apply_slots(all_src, all_dst, all_w, rank, is_batch,
                            sent: int, out_cap: int, backend: str = "auto"):
    """The shared batch-apply sort-reduce over a unified directed-slot list.

    ``all_*`` concatenate the existing slots (rank 0) and the batch's
    directed slots (rank 1 + batch position, so later entries win ties);
    dead slots carry an endpoint >= ``sent``.  Groups of equal (src, dst)
    resolve to their highest-rank weight and compact back into
    (src, dst)-sorted order in ``out_cap`` slots (overflow rows land in a
    scratch slot and are reported through the uncapped ``e_new``).

    Returns ``(out_src, out_dst, out_w, e_new, chg_src, chg_dst)``;
    ``e_new`` is a 0-d device tensor, and ``chg_*`` hold the endpoints of
    every group whose resolved weight changed (``sent`` elsewhere).
    ``backend`` is ``"sort"``, ``"kernel"`` (K4) or ``"auto"`` (the kernel
    on CUDA tensors).  The two backends give the same graph and the same
    touched set; only the ``chg_*`` encoding differs (every slot of a
    changed group, against one record per group).
    """
    backend = resolve_apply_backend(backend, all_src.device)
    s_src, s_dst, s_w, s_batch = sort_slots(all_src, all_dst, all_w, rank,
                                            is_batch, sent)

    if backend == "kernel":
        keep, pos, f_src, f_dst, f_w, chg = resolve_groups(
            s_src, s_dst, s_w, s_batch, sent=sent)
        e_new = keep.sum()
        pos = torch.where(keep & (pos < out_cap), pos, out_cap)
        out_src, out_dst, out_w = scatter_slots(
            pos, torch.where(keep, f_src, sent),
            torch.where(keep, f_dst, sent), torch.where(keep, f_w, 0.0),
            sent, out_cap)
        return (out_src, out_dst, out_w, e_new,
                torch.where(chg, f_src, sent), torch.where(chg, f_dst, sent))

    total = s_src.shape[0]
    s_sent = s_src == sent
    nxt_same = (s_src[:-1] == s_src[1:]) & (s_dst[:-1] == s_dst[1:])
    one = torch.ones(min(total, 1), dtype=torch.bool, device=s_src.device)
    is_last = torch.cat([~nxt_same, one])
    is_first = torch.cat([one, ~nxt_same])
    gid = torch.cumsum(is_first, 0) - 1

    # Per-group old weight (0 if the first slot is a batch slot, an insert)
    # and new weight (the last slot's: batch slots outrank existing ones).
    # One non-zero summand per group, so the sums are exact selections.
    old_w = segment_sum(torch.where(is_first & ~s_batch, s_w, 0.0), gid,
                        total)
    new_w = segment_sum(torch.where(is_last, s_w, 0.0), gid, total)
    changed_group = segment_sum(
        (s_batch & (old_w[gid] != new_w[gid])).to(torch.int32), gid, total)

    # Compact live groups (w > 0, real key) back into sorted slot order.
    keep = is_last & ~s_sent & (new_w[gid] > 0.0)
    e_new = keep.sum()
    pos = torch.cumsum(keep, 0) - 1
    pos = torch.where(keep & (pos < out_cap), pos, out_cap)
    out_src, out_dst, out_w = scatter_slots(
        pos, torch.where(keep, s_src, sent), torch.where(keep, s_dst, sent),
        torch.where(keep, new_w[gid], 0.0), sent, out_cap)

    hit = changed_group[gid] > 0
    return (out_src, out_dst, out_w, e_new, torch.where(hit, s_src, sent),
            torch.where(hit, s_dst, sent))


def batch_slots(graph: CSRGraph, batch: EdgeBatch):
    """The unified directed-slot list of one batch apply:
    ``(all_src, all_dst, all_w, rank, is_batch)`` with dead slots keyed
    ``(n_cap, n_cap)``, existing slots first, then the batch's directed
    slots interleaved as ``fwd0, rev0, fwd1, rev1, ...`` (rank order; see
    the module docstring).  Self loops get ONE slot (the reverse is dead).
    """
    n_cap, e_cap = graph.n_cap, graph.e_cap
    b_cap = batch.b_cap
    dev = graph.device
    if batch.src.device != dev:
        raise ValueError(f"batch on {batch.src.device}, graph on {dev}")
    b_idx = torch.arange(b_cap, device=dev)
    b_live = ((b_idx < batch.b_valid) & (batch.src < n_cap)
              & (batch.dst < n_cap))
    u = torch.where(b_live, batch.src, n_cap).to(torch.int32)
    v = torch.where(b_live, batch.dst, n_cap).to(torch.int32)
    rev_live = b_live & (u != v)
    d_src = torch.stack([u, torch.where(rev_live, v, n_cap)], 1).reshape(-1)
    d_dst = torch.stack([v, torch.where(rev_live, u, n_cap)], 1).reshape(-1)
    d_w = torch.stack([batch.weight, torch.where(rev_live, batch.weight, 0.0)],
                      1).reshape(-1)

    all_src = torch.cat([graph.src, d_src.to(torch.int32)])
    all_dst = torch.cat([graph.indices, d_dst.to(torch.int32)])
    all_w = torch.cat([graph.weights, d_w]).to(torch.float32)
    e_idx = torch.arange(e_cap, device=dev)
    exist_live = (e_idx < graph.e_valid) & (graph.src < n_cap)
    slot_live = torch.cat([exist_live, (d_src < n_cap) | (d_dst < n_cap)])
    is_batch = torch.cat([torch.zeros(e_cap, dtype=torch.bool, device=dev),
                          torch.ones(2 * b_cap, dtype=torch.bool, device=dev)])
    rank = torch.cat([torch.zeros(e_cap, dtype=torch.int32, device=dev),
                      1 + torch.arange(2 * b_cap, dtype=torch.int32,
                                       device=dev) // 2])
    dead = ~(slot_live & (all_src < n_cap) & (all_dst < n_cap))
    return (torch.where(dead, n_cap, all_src),
            torch.where(dead, n_cap, all_dst), all_w, rank, is_batch)


def sorted_batch_slots(graph: CSRGraph, batch: EdgeBatch):
    """The (src, dst, rank)-sorted slot list that K4 resolves for one batch:
    ``(s_src, s_dst, s_w, s_batch)``."""
    return sort_slots(*batch_slots(graph, batch), graph.n_cap)


def _apply_edge_batch(graph: CSRGraph, batch: EdgeBatch,
                      backend: str = "auto"):
    """Returns (graph', touched_mask, e_new_uncapped).  Reads ``e_new`` and
    the new ``n_valid`` to the host in one transfer (the port's
    ``CSRGraph`` keeps them as host ints)."""
    n_cap, e_cap = graph.n_cap, graph.e_cap
    dev = graph.device
    all_src, all_dst, all_w, rank, is_batch = batch_slots(graph, batch)
    out_src, out_dst, out_w, e_new, chg_src, chg_dst = sort_reduce_apply_slots(
        all_src, all_dst, all_w, rank, is_batch, n_cap, e_cap, backend)

    live_rows = out_src < n_cap
    counts = segment_sum(live_rows.to(torch.int32),
                         torch.where(live_rows, out_src, n_cap), n_cap + 1)
    indptr = torch.zeros(n_cap + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(counts[:n_cap], 0, dtype=torch.int32)

    # Touched vertices: endpoints of groups whose weight actually changed
    # (True written at repeated indices is idempotent; slot n_cap stays off).
    touched = torch.zeros(n_cap + 1, dtype=torch.bool, device=dev)
    touched[chg_src.to(torch.int64)] = True
    touched[chg_dst.to(torch.int64)] = True
    touched[n_cap] = False

    # Batch endpoints may extend the valid-vertex prefix (still < n_cap).
    max_end = torch.max(torch.where(
        touched, torch.arange(n_cap + 1, device=dev), -1))
    e_new, max_end = torch.stack([e_new.to(torch.int64), max_end]).tolist()
    out = CSRGraph(indptr=indptr, indices=out_dst, weights=out_w,
                   src=out_src, n_valid=max(graph.n_valid, max_end + 1),
                   e_valid=min(e_new, e_cap))
    return out, touched, e_new


def grow_graph_capacity(graph: CSRGraph, e_cap_new: int) -> CSRGraph:
    """Copy a graph into buffers with more edge slots.  Vertex capacity is
    unchanged; the live prefix is copied and the rest padded."""
    e_cap_new = int(e_cap_new)
    if e_cap_new < graph.e_cap:
        raise ValueError(f"cannot shrink e_cap {graph.e_cap} -> {e_cap_new}")
    n_cap, e = graph.n_cap, graph.e_valid

    def grow(x, fill):
        return torch.cat([x[:e], torch.full((e_cap_new - e,), fill,
                                            dtype=x.dtype, device=x.device)])

    return CSRGraph(indptr=graph.indptr, indices=grow(graph.indices, n_cap),
                    weights=grow(graph.weights, 0.0),
                    src=grow(graph.src, n_cap), n_valid=graph.n_valid,
                    e_valid=graph.e_valid)


def apply_edge_batch(graph: CSRGraph, batch: EdgeBatch, *, grow: bool = False,
                     backend: str = "auto") -> Tuple[CSRGraph, torch.Tensor]:
    """Apply one edge batch; returns (graph', touched_vertex_mask).

    Raises if the resulting edge count exceeds ``e_cap``; with
    ``grow=True`` an overflowing batch instead re-buckets into doubled
    capacity (at least the required count) and re-applies.  ``backend``
    selects the group resolve (``"sort"``, ``"kernel"`` or ``"auto"``: the
    kernel K4 on a CUDA graph, the sort chain on a CPU graph).
    """
    out, touched, e_new = _apply_edge_batch(graph, batch, backend)
    if e_new > graph.e_cap:
        if not grow:
            raise ValueError(
                f"edge batch overflows capacity: {e_new} live directed "
                f"slots > e_cap={graph.e_cap}")
        grown = grow_graph_capacity(graph, max(2 * graph.e_cap, e_new))
        out, touched, e_new = _apply_edge_batch(grown, batch, backend)
    return out, touched
