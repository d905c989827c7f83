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
apply therefore interleaves the batch's directed slots as ``fwd0, rev0,
fwd1, rev1, ...`` so that list order is rank order and one stable key sort
equals the reference's lexsort (``sort_slots``, the reference's
``sort_reduce_apply_slots`` on any list, gives a list whose ranks are out
of order two stable sorts: rank, then key).  A graph's batch applies as a
one-stream fleet's (``apply_fleet_batch``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.louvain_arch import resolve_apply_backend
from repro_torch.core.graph import (CSRGraph, FleetGraph, lane_positions,
                                    resolve_device, scatter_fleet_records,
                                    scatter_slots,
                                    segment_sum, stack_graphs, stack_rows)
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
                            sent: int, out_cap: int, backend: str = "auto",
                            lanes=None):
    """The shared batch-apply sort-reduce over a unified directed-slot list.

    ``all_*`` concatenate the existing slots (rank 0) and the batch's
    directed slots (rank 1 + batch position, so later entries win ties);
    dead slots carry an endpoint >= ``sent``.  Groups of equal (src, dst)
    resolve to their highest-rank weight and compact back into
    (src, dst)-sorted order in ``out_cap`` slots (overflow rows land in a
    scratch slot and are reported through the uncapped ``e_new``).

    ``lanes = (v0, v_per, n)`` splits the list into ``n`` lanes (a sharded
    fleet bucket's tenants on one rank): lane i's live src ids lie in
    ``[v0 + i * v_per, v0 + (i + 1) * v_per)``, its records compact into
    its own block ``[i * out_cap, (i + 1) * out_cap)`` of ``n * out_cap``
    output slots (``core.graph.lane_positions``), and ``e_new`` is the
    (n,) int32 tensor of each lane's uncapped count.  Still one sort and
    one group resolve for all lanes.

    Returns ``(out_src, out_dst, out_w, e_new, chg_src, chg_dst)``;
    ``e_new`` is a 0-d device tensor without ``lanes``, and ``chg_*`` hold
    the endpoints of every group whose resolved weight changed (``sent``
    elsewhere).  ``backend`` is ``"sort"``, ``"kernel"`` (K4) or ``"auto"``
    (the kernel on CUDA tensors).  The two backends give the same graph and
    the same touched set; only the ``chg_*`` encoding differs (every slot
    of a changed group, against one record per group).
    """
    backend = resolve_apply_backend(backend, all_src.device)
    s_src, s_dst, s_w, s_batch = sort_slots(all_src, all_dst, all_w, rank,
                                            is_batch, sent)
    keep, pos, r_src, r_dst, r_w, chg_src, chg_dst = resolve_sorted_slots(
        s_src, s_dst, s_w, s_batch, sent, backend)
    if lanes is None:
        n, lane, lpos, e_new = 1, torch.zeros_like(pos), pos, keep.sum()
    else:
        v0, v_per, n = lanes
        lane, lpos, e_new = lane_positions(keep, pos, torch.div(
            r_src.to(torch.int32) - int(v0), int(v_per),
            rounding_mode="floor"), int(n))
    slot = torch.where(keep & (lpos < out_cap),
                       lane.to(torch.int64) * out_cap + lpos, n * out_cap)
    out_src, out_dst, out_w = scatter_slots(
        slot, torch.where(keep, r_src, sent), torch.where(keep, r_dst, sent),
        torch.where(keep, r_w, 0.0), sent, n * out_cap)
    return out_src, out_dst, out_w, e_new, chg_src, chg_dst


def resolve_sorted_slots(s_src, s_dst, s_w, s_batch, sent: int,
                         backend: str):
    """Resolve a (src, dst, rank)-sorted slot list into one record per
    group: ``(keep, pos, r_src, r_dst, r_w, chg_src, chg_dst)``.  ``keep``
    marks the records of live groups (real key, resolved weight > 0),
    ``pos`` their rank among the kept ones, ``r_*`` the group's key and
    resolved weight; ``chg_*`` hold the endpoints of every group whose
    weight changed (``sent`` elsewhere).  ``"kernel"`` is K4 (its records
    sit one slot after each group); ``"sort"`` the segment-reduction chain
    (records on each group's last slot)."""
    if backend == "kernel":
        keep, pos, f_src, f_dst, f_w, chg = resolve_groups(
            s_src, s_dst, s_w, s_batch, sent=sent)
        return (keep, pos, f_src, f_dst, f_w, torch.where(chg, f_src, sent),
                torch.where(chg, f_dst, sent))

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
    pos = torch.cumsum(keep, 0) - 1
    hit = changed_group[gid] > 0
    return (keep, pos, s_src, s_dst, new_w[gid],
            torch.where(hit, s_src, sent), torch.where(hit, s_dst, sent))


def _directed_slots(src, indices, weights, e_valid, b_src, b_dst, b_w,
                    b_valid, n_cap: int):
    """The unified directed-slot lists ``(all_src, all_dst, all_w,
    is_batch)`` along the last axis: a graph's slots (live below
    ``e_valid``), then its batch's directed slots interleaved as ``fwd0,
    rev0, fwd1, rev1, ...``; dead slots keyed ``(n_cap, n_cap)``.  Leading
    axes (a fleet's streams) take ``e_valid``/``b_valid`` as (S, 1)
    tensors."""
    e_cap, b_cap = src.shape[-1], b_src.shape[-1]
    dev = src.device
    lead = b_src.shape[:-1]
    b_idx = torch.arange(b_cap, device=dev)
    b_live = (b_idx < b_valid) & (b_src < n_cap) & (b_dst < n_cap)
    u = torch.where(b_live, b_src, n_cap).to(torch.int32)
    v = torch.where(b_live, b_dst, n_cap).to(torch.int32)
    rev_live = b_live & (u != v)
    d_src = torch.stack([u, torch.where(rev_live, v, n_cap)],
                        -1).reshape(*lead, -1)
    d_dst = torch.stack([v, torch.where(rev_live, u, n_cap)],
                        -1).reshape(*lead, -1)
    d_w = torch.stack([b_w, torch.where(rev_live, b_w, 0.0)],
                      -1).reshape(*lead, -1)

    all_src = torch.cat([src, d_src.to(torch.int32)], -1)
    all_dst = torch.cat([indices, d_dst.to(torch.int32)], -1)
    all_w = torch.cat([weights, d_w], -1).to(torch.float32)
    e_idx = torch.arange(e_cap, device=dev)
    exist_live = (e_idx < e_valid) & (src < n_cap)
    slot_live = torch.cat([exist_live, (d_src < n_cap) | (d_dst < n_cap)],
                          -1)
    is_batch = torch.cat([torch.zeros(e_cap, dtype=torch.bool, device=dev),
                          torch.ones(2 * b_cap, dtype=torch.bool, device=dev)])
    dead = ~(slot_live & (all_src < n_cap) & (all_dst < n_cap))
    return (torch.where(dead, n_cap, all_src),
            torch.where(dead, n_cap, all_dst), all_w,
            is_batch.expand(all_src.shape))


def sorted_batch_slots(graph: CSRGraph, batch: EdgeBatch):
    """The sorted slot list that K4 resolves for one batch: ``(s_src,
    s_dst, s_w, s_batch)``, that of a one-stream fleet
    (``sorted_fleet_slots``; dead slots key as its flat sentinel
    n_cap + 1)."""
    return sorted_fleet_slots(stack_graphs([graph]), stack_batches([batch]))


def _apply_edge_batch(graph: CSRGraph, batch: EdgeBatch,
                      backend: str = "auto"):
    """Returns (graph', touched_mask, e_new_uncapped): ``apply_fleet_batch``
    of a one-stream fleet, which reads ``e_new`` and the new ``n_valid``
    to the host in one transfer (the port's ``CSRGraph`` keeps them as
    host ints)."""
    if batch.src.device != graph.device:
        raise ValueError(f"batch on {batch.src.device}, graph on "
                         f"{graph.device}")
    out, touched, e_new, _ = apply_fleet_batch(
        stack_graphs([graph]), stack_batches([batch]), backend)
    return out.stream(0), touched[0], int(e_new[0])


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


# ---------------------------------------------------------------------------
# The fleet form: one apply for every stream of a batched serving step.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetBatch:
    """S padded edge batches of one ``b_cap``, stacked along axis 0:
    src, dst (S, b_cap) int32, weight (S, b_cap) float32, b_valid (S,)
    host ints."""

    src: torch.Tensor
    dst: torch.Tensor
    weight: torch.Tensor
    b_valid: np.ndarray

    @property
    def b_cap(self) -> int:
        return self.src.shape[1]


def stack_batches(batches) -> FleetBatch:
    """Stack equal-capacity edge batches along a new leading stream axis."""
    b0 = batches[0]
    for b in batches[1:]:
        if b.b_cap != b0.b_cap:
            raise ValueError(
                f"batch capacities differ: {b.b_cap} vs {b0.b_cap}")
    return FleetBatch(src=stack_rows([b.src for b in batches]),
                      dst=stack_rows([b.dst for b in batches]),
                      weight=stack_rows([b.weight for b in batches]),
                      b_valid=np.array([b.b_valid for b in batches],
                                       np.int64))


def sorted_fleet_slots(fleet: FleetGraph, batch: FleetBatch):
    """The fleet's unified slot list, keyed ``(stream, src, dst)`` in flat
    ids (``FleetGraph.flat_ids``; dead slots of every stream key as the
    flat sentinel G and sort last) and put in order by ONE stable sort:
    ``(s_src, s_dst, s_w, s_batch)``, which K4 resolves with ``sent=G``.
    Within a stream the list is in rank order (``_directed_slots``), and
    live keys of two streams never meet, so the stable key sort is the
    reference's (stream, src, dst, rank) order."""
    dev = fleet.device
    if batch.src.device != dev or batch.src.shape[0] != fleet.n_streams:
        raise ValueError(f"a batch of {batch.src.shape[0]} streams on "
                         f"{batch.src.device} for a fleet of "
                         f"{fleet.n_streams} on {dev}")
    ev = torch.from_numpy(fleet.e_valid).to(dev)[:, None]
    bv = torch.from_numpy(batch.b_valid).to(dev)[:, None]
    all_src, all_dst, all_w, is_batch = _directed_slots(
        fleet.src, fleet.indices, fleet.weights, ev, batch.src, batch.dst,
        batch.weight, bv, fleet.n_cap)
    f_src, f_dst = fleet.flat_ids(all_src), fleet.flat_ids(all_dst)
    del all_src, all_dst
    key = f_src.to(torch.int64)
    key.mul_(fleet.sentinel + 1).add_(f_dst)
    order = torch.sort(key, stable=True).indices
    del key
    return (f_src[order], f_dst[order], all_w.reshape(-1)[order],
            is_batch.reshape(-1)[order])


def apply_fleet_batch(fleet: FleetGraph, batch: FleetBatch,
                      backend: str = "auto"):
    """One edge batch per stream, applied to the whole fleet at once: one
    slot-list build, one stable key sort, one group resolve (K4 with
    ``backend="kernel"``: ONE launch for all S streams) and one scatter.
    Each stream's graph, touched set and edge count equal its own
    ``_apply_edge_batch`` bit for bit (K4 selects weights, never sums).

    Returns ``(fleet', touched, e_new, n_touched)``: touched is (S, n_cap
    + 1) bool on the device; ``e_new`` (uncapped; above ``e_cap`` the
    stream overflowed and its slots past the envelope were dropped) and
    ``n_touched`` are (S,) host arrays, read with the new ``n_valid`` in
    one transfer for the whole fleet.
    """
    backend = resolve_apply_backend(backend, fleet.device)
    S, n_cap, e_cap = fleet.n_streams, fleet.n_cap, fleet.e_cap
    sent = fleet.sentinel
    s_src, s_dst, s_w, s_batch = sorted_fleet_slots(fleet, batch)
    keep, pos, r_src, r_dst, r_w, chg_src, chg_dst = resolve_sorted_slots(
        s_src, s_dst, s_w, s_batch, sent, backend)
    out_src, out_dst, out_w, counts, indptr = scatter_fleet_records(
        fleet, keep, pos, r_src, r_dst, r_w, e_cap)

    touched = torch.zeros(sent + 1, dtype=torch.bool, device=fleet.device)
    touched[chg_src.to(torch.int64)] = True
    touched[chg_dst.to(torch.int64)] = True
    touched = touched[:sent].view(S, n_cap + 1)
    touched[:, n_cap] = False
    idx = torch.arange(n_cap + 1, device=fleet.device)
    max_end = torch.max(torch.where(touched, idx, -1), 1).values
    host = torch.cat([counts, max_end, touched.sum(1)]).cpu().numpy()
    e_new, max_end, n_touched = host[:S], host[S:2 * S], host[2 * S:]
    out = FleetGraph(indptr=indptr, indices=out_dst, weights=out_w,
                     src=out_src,
                     n_valid=np.maximum(fleet.n_valid, max_end + 1),
                     e_valid=np.minimum(e_new, e_cap))
    return out, touched, e_new, n_touched
