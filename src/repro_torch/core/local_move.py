"""Sort-reduce scanner backends (full and frontier-compacted) + the
single-device local-moving phase (``repro.core.local_move`` and
``repro.core.louvain._move_phase``).

Every frontier vertex computes its best move against the same snapshot of
(C, Sigma); all moves then apply at once (the engine's rounds).  The scan
groups edge slots by (src, C[dst]) with one stable sort of a packed int64
key — the counterpart of the reference's ``lexsort((C[dst], src))`` — and
segment-sums the per-community weights K_{i->c}.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.engine import (ConstrainedScanner, EngineConfig,
                                     MoveEngine, MoveState,
                                     ReplicatedScannerBase,
                                     mask_cross_outer_slots, sanitize_outer)
from repro_torch.core.graph import CSRGraph, scatter_slots, segment_sum
from repro_torch.core.modularity import delta_modularity
from repro_torch.core.spans import count

_NEG_INF = float("-inf")


def _scan_communities_slots(src, dst, w, comm):
    """Group directed slots by (src, C[dst]) and compute K_{i->c} per slot.

    Returns (order, s_src, s_c, k_i_to_c) in sorted slot order; self-loop
    slots contribute 0.  The sort is stable, so each group sums its
    weights in slot order, as the reference's stable lexsort does.
    """
    cdst = comm[dst]
    key = src.to(torch.int64) * comm.shape[0] + cdst.to(torch.int64)
    s_key, order = torch.sort(key, stable=True)
    s_src = src[order]
    s_c = cdst[order]
    s_w = torch.where(s_src == dst[order], 0.0, w[order])
    new_group = torch.ones_like(s_key, dtype=torch.bool)
    new_group[1:] = s_key[1:] != s_key[:-1]
    gid = torch.cumsum(new_group, 0) - 1
    group_w = segment_sum(s_w, gid, src.shape[0])
    return order, s_src, s_c, group_w[gid]


def scan_communities_sorted(graph: CSRGraph, comm: torch.Tensor):
    """Group the graph's edge slots by (src, C[dst]) and compute K_{i->c}
    per slot: (order, s_src, s_c, k_i_to_c) in sorted slot order,
    self-loop slots contributing 0."""
    return _scan_communities_slots(graph.src, graph.indices, graph.weights,
                                   comm)


def best_moves_slots(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                     comm: torch.Tensor, sigma: torch.Tensor, k: torch.Tensor,
                     frontier: torch.Tensor, m: torch.Tensor,
                     n_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vertex (best community, best dQ) from a directed-slot list.

    The slot arrays may be the graph's full ``e_cap`` layout or any
    order-preserving subset of it: a vertex whose live slots are all present
    gets exactly the full-scan answer (same weights, added in the same
    order).  Ties go to the smallest community id; a vertex with no
    candidate gets (n_cap, -inf).  ``m`` is 0-d, or (n_cap + 1,) per vertex
    (over a fleet, each vertex's own stream's m); it is read per slot.
    """
    own = (comm[dst] == comm[src]) & (dst != src)
    k_to_own = segment_sum(torch.where(own, w, 0.0), src, n_cap + 1)

    _, s_src, s_c, k_i_to_c = _scan_communities_slots(src, dst, w, comm)
    c_own = comm[s_src]
    dq = delta_modularity(k_i_to_c, k_to_own[s_src], k[s_src], sigma[s_c],
                          sigma[c_own], m.expand(n_cap + 1)[s_src])
    valid = ((s_c != c_own) & (s_src != n_cap) & (s_c != n_cap)
             & frontier[s_src])
    dq = torch.where(valid, dq, _NEG_INF)

    seg = s_src.to(torch.int64)
    best_dq = torch.full((n_cap + 1,), _NEG_INF, dtype=torch.float32,
                         device=dq.device)
    best_dq.scatter_reduce_(0, seg, dq, "amax", include_self=True)
    best_dq = torch.where(torch.isfinite(best_dq), best_dq, _NEG_INF)
    is_best = (dq == best_dq[s_src]) & valid
    # Empty segments keep the initial n_cap: the reference's clamp of
    # segment_min's iinfo.max into the sentinel slot.
    best_c = torch.full((n_cap + 1,), n_cap, dtype=torch.int32,
                        device=dq.device)
    best_c.scatter_reduce_(0, seg, torch.where(is_best, s_c, n_cap), "amin",
                           include_self=True)
    return best_c, best_dq


def best_moves(graph: CSRGraph, comm, sigma, k, frontier, m):
    """Per-vertex (best community, best dQ) from one snapshot (full scan)."""
    return best_moves_slots(graph.src, graph.indices, graph.weights, comm,
                            sigma, k, frontier, m, graph.n_cap)


def gather_frontier_slots(graph: CSRGraph, frontier: torch.Tensor,
                          work_cap: int):
    """Compact the frontier vertices' edge slots into a (work_cap,) buffer.

    Order-preserving: slot i of the output is the i-th edge slot (in CSR
    order) whose src is in the frontier, so the sort-reduce results are
    bit-identical to the full scan.  Slots past ``work_cap`` are dropped and
    ``overflow`` (a 0-d bool tensor) reports whether any were.

    Returns (src, dst, w, overflow) with dead slots = (n_cap, n_cap, 0).
    """
    n_cap = graph.n_cap
    src, dst, w = graph.src, graph.indices, graph.weights
    in_f = frontier[src]                       # pad slots: frontier[n_cap]=F
    rank = torch.cumsum(in_f, 0) - 1
    keep = in_f & (rank < work_cap)
    out_src, out_dst, out_w = scatter_slots(
        torch.where(keep, rank, work_cap), torch.where(keep, src, n_cap),
        torch.where(keep, dst, n_cap), torch.where(keep, w, 0.0), n_cap,
        work_cap)
    return out_src, out_dst, out_w, in_f.sum() > work_cap


def compact_best_moves(graph: CSRGraph, comm, sigma, k, frontier, m,
                       work_cap: int):
    """Frontier-proportional best-move scan with measured-overflow fallback.

    Scans only the frontier vertices' edge slots, gathered into a
    ``(work_cap,)`` buffer; when they exceed the cap, the full scan runs
    instead.  The reference's ``lax.cond`` is a host branch here: one sync
    per round.  Returns (best_c, best_dq, overflowed); the first two are
    bit-identical to ``best_moves`` either way.  Counts each call in
    ``scan.compact_rounds`` and each fallback in ``scan.compact_fallbacks``
    (``core/spans.py``).
    """
    c_src, c_dst, c_w, overflow = gather_frontier_slots(graph, frontier,
                                                        work_cap)
    overflowed = bool(overflow)
    count("scan.compact_rounds")
    if overflowed:
        count("scan.compact_fallbacks")
        best_c, best_dq = best_moves(graph, comm, sigma, k, frontier, m)
    else:
        best_c, best_dq = best_moves_slots(c_src, c_dst, c_w, comm, sigma, k,
                                           frontier, m, graph.n_cap)
    return best_c, best_dq, overflowed


class SortReduceScanner(ReplicatedScannerBase):
    """Engine backend: CSR sort-reduce scan on a single device, of a
    ``CSRGraph`` or of a whole fleet's ``FleetView``.  Counts each round in
    ``scan.full_rounds`` (``core/spans.py``)."""

    def __init__(self, graph: CSRGraph, k: torch.Tensor, m: torch.Tensor):
        super().__init__(graph.n_cap, graph.n_valid, k, graph.n_streams)
        self.graph = graph
        self.m = m

    def scan(self, comm, sigma, frontier):
        count("scan.full_rounds")
        return best_moves(self.graph, comm, sigma, self.k_local, frontier,
                          self.m)

    def mark_neighbors(self, moved: torch.Tensor) -> torch.Tensor:
        g = self.graph
        marked = segment_sum(moved[g.src].to(torch.int32), g.indices,
                             g.n_cap + 1)
        return marked > 0


class CompactSortReduceScanner(SortReduceScanner):
    """Engine backend: frontier-compacted CSR sort-reduce scan.

    Same topology surface as ``SortReduceScanner``; per round it scans only
    the CURRENT frontier's edge slots (``compact_best_moves``), falling back
    to the full scan when they overflow ``work_cap``.  Results are
    bit-identical to the full scan; the work is frontier-proportional.
    """

    def __init__(self, graph: CSRGraph, k: torch.Tensor, m: torch.Tensor,
                 work_cap: int):
        super().__init__(graph, k, m)
        if not 0 < work_cap:
            raise ValueError(f"work_cap must be positive, got {work_cap}")
        self.work_cap = int(min(work_cap, graph.e_cap))

    def scan(self, comm, sigma, frontier):
        best_c, best_dq, _ = compact_best_moves(
            self.graph, comm, sigma, self.k_local, frontier, self.m,
            self.work_cap)
        return best_c, best_dq


def cross_outer_masked(graph: CSRGraph, refine_outer: torch.Tensor):
    """(sanitized outer, a copy of ``graph`` whose cross-outer slots are
    masked by ``mask_cross_outer_slots``): the candidate topology of a
    constrained sweep.  ``indptr`` and ``src`` are shared, so degree
    buckets do not change; one new ``indices``/``weights`` pair is made."""
    outer = sanitize_outer(refine_outer, graph.n_valid, graph.n_cap)
    dst, w = mask_cross_outer_slots(graph.src, graph.indices, graph.weights,
                                    outer, graph.n_cap)
    return outer, dataclasses.replace(graph, indices=dst, weights=w)


def _move_engine(graph: CSRGraph, k, m, *, max_iterations: int,
                 use_pruning: bool, gate_fraction: int, work_cap: int,
                 refine_outer: Optional[torch.Tensor]) -> MoveEngine:
    """The engine of one sort-reduce move phase (see ``move_phase``)."""
    if refine_outer is not None:
        outer, graph = cross_outer_masked(graph, refine_outer)
    scanner = (CompactSortReduceScanner(graph, k, m, work_cap) if work_cap
               else SortReduceScanner(graph, k, m))
    if refine_outer is not None:
        scanner = ConstrainedScanner(scanner, outer,
                                     gate_fraction=gate_fraction)
    return MoveEngine(scanner, EngineConfig(
        max_iterations=max_iterations, use_pruning=use_pruning,
        gate_fraction=gate_fraction))


def move_phase(graph: CSRGraph, comm0, sigma0, frontier0, tolerance: float,
               *, max_iterations: int = 20, use_pruning: bool = True,
               gate_fraction: int = 2, work_cap: int = 0,
               refine_outer: Optional[torch.Tensor] = None,
               k: Optional[torch.Tensor] = None):
    """One local-moving phase on the sort-reduce backend from an arbitrary
    (C, Sigma, frontier) start; returns (comm, iters, dq_sum).  ``k`` is
    the graph's ``vertex_weights()``, computed here when not given.

    ``work_cap > 0`` runs the frontier-compacted scanner with that
    work-buffer capacity (bit-identical results, frontier-proportional
    work); 0 is the full ``e_cap`` scan.  ``refine_outer`` runs Leiden's
    constrained sweep instead: the scanner sees the cross-outer-masked
    topology (``cross_outer_masked``) inside a ``ConstrainedScanner``,
    while ``k`` and ``m`` stay the unmasked graph's.

    ``graph`` may be a fleet's ``FleetView`` with one tolerance per stream
    (an (S,) array): then each stream stops on its own dQ
    (``MoveEngine.run``), and ``iters`` and ``dq_sum`` are per stream.
    """
    st = _move_engine(
        graph, graph.vertex_weights() if k is None else k,
        graph.total_weight(),
        max_iterations=max_iterations, use_pruning=use_pruning,
        gate_fraction=gate_fraction, work_cap=work_cap,
        refine_outer=refine_outer).run(comm0, sigma0, frontier0, tolerance)
    return st.comm, st.iters, st.dq_sum


def louvain_move(graph: CSRGraph, comm: torch.Tensor, sigma: torch.Tensor,
                 k: torch.Tensor, m: torch.Tensor, *, tolerance,
                 max_iterations: int = 20, use_pruning: bool = True,
                 gate_fraction: int = 2,
                 frontier0: Optional[torch.Tensor] = None,
                 work_cap: int = 0,
                 refine_outer: Optional[torch.Tensor] = None) -> MoveState:
    """Algorithm 2 on the sort-reduce backend with the caller's K and m
    (the reference's adapter; ``move_phase`` computes them from the graph):
    returns the engine's ``MoveState``.  ``comm``/``sigma`` may be any
    consistent start (a warm start passes the previous membership);
    ``frontier0`` restricts the first round to a seed set, ``None`` meaning
    every valid vertex; ``work_cap`` and ``refine_outer`` as in
    ``move_phase``."""
    valid = (torch.arange(graph.n_cap + 1, device=graph.device)
             < graph.n_valid)
    frontier0 = valid if frontier0 is None else (frontier0 & valid)
    return _move_engine(
        graph, k, m, max_iterations=max_iterations, use_pruning=use_pruning,
        gate_fraction=gate_fraction, work_cap=work_cap,
        refine_outer=refine_outer).run(comm, sigma, frontier0, tolerance)
