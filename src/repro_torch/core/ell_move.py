"""ELL scanner backends + their local-moving phase (``repro.core.ell_move``).

Vertices are degree-bucketed by ELL width (``graph.ell_bucket_rows``), and
each bucket's best-move scan runs in the CUDA kernels K2 (``ELLScanner``) or
K1 (``FusedELLScanner``, scan + decision in one launch), which read the
bucket's CSR rows themselves.  Hub vertices above the widest ELL width take
the sort-reduce scan.  ``scan_backend="auto"``'s route to K1 buckets by
``AUTO_ELL_WIDTHS``, keeping the tiers that the pass's degree histogram
fills (``graph.degree_tiers``).  PyTorch runs eagerly, so the reference's
jit cache has no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.engine import (ConstrainedScanner, EngineConfig,
                                     MoveEngine, gated_move_mask, round_gate)
from repro_torch.core.graph import CSRGraph, degree_tiers, ell_bucket_rows
from repro_torch.core.local_move import (SortReduceScanner, best_moves_slots,
                                         cross_outer_masked)
from repro_torch.core.spans import count
from repro_torch.kernels.louvain_scan import ops as scan_ops

#: The ELL tiers of ``scan_backend="auto"``'s route to K1, from the kernels'
#: layout bounds: a row per thread up to 16, a row per warp up to 256, a
#: row per block in shared memory up to 16384 and in global scratch at
#: 32768.  Rows above the widest take the sort-reduce hub scan.  Timed
#: alone on graph500-22's first pass (H100), the 4096 and 16384 tiers
#: take their rows in 3.9 ms where the 32768 tier takes 14.3; a 1024 tier
#: takes its rows slower than the 2048 tier does.
AUTO_ELL_WIDTHS = (16, 64, 256, 2048, 4096, 16384, 32768)


class ELLScanner(SortReduceScanner):
    """Engine backend: the ELL scan kernel (K2) per degree bucket + the
    sort-reduce fallback for hub rows.  ``buckets`` pairs each ELL width
    with its rows (``ell_bucket_rows``).

    The fallback scans only the hub vertices' own slots (an order-preserving
    subset of the CSR, gathered once per phase), which gives exactly the
    full scan's answer for those vertices; the reference scans every slot
    and keeps the hub rows.
    """

    def __init__(self, graph: CSRGraph, buckets, leftover: torch.Tensor, k,
                 m):
        super().__init__(graph, k, m)
        self.buckets = buckets
        self.leftover = leftover
        if leftover.numel():
            hub = torch.zeros(graph.n_cap + 1, dtype=torch.bool,
                              device=graph.device)
            hub[leftover] = True
            keep = torch.nonzero(hub[graph.src]).flatten()
            self._hub_slots = tuple(t.index_select(0, keep) for t in (
                graph.src, graph.indices, graph.weights))

    def _hub_scan(self, comm, sigma, frontier):
        src, dst, w = self._hub_slots
        return best_moves_slots(src, dst, w, comm, sigma, self.k_local,
                                frontier, self.m, self.graph.n_cap)

    def scan(self, comm, sigma, frontier) -> Tuple[torch.Tensor, torch.Tensor]:
        n_cap = self.graph.n_cap
        dev = comm.device
        best_c = torch.full((n_cap + 1,), n_cap, dtype=torch.int32,
                            device=dev)
        best_dq = torch.full((n_cap + 1,), float("-inf"), dtype=torch.float32,
                             device=dev)
        g = self.graph
        count("scan.ell_rounds")
        for width, rows in self.buckets:
            bc, bdq = scan_ops.louvain_scan(
                rows, g.indptr, g.indices, g.weights, comm, sigma,
                self.k_local, self.m, width=width)
            # Pad rows carry vertex id n_cap -> land in the sentinel slot.
            best_c[rows] = torch.where(bc < 0, n_cap, bc)
            best_dq[rows] = bdq
        if self.leftover.numel():
            sc, sdq = self._hub_scan(comm, sigma, frontier)
            best_c[self.leftover] = sc[self.leftover]
            best_dq[self.leftover] = sdq[self.leftover]
        # Frontier-gate: non-frontier vertices must not move.
        best_dq = torch.where(frontier, best_dq, float("-inf"))
        best_c[n_cap] = n_cap
        return best_c, best_dq


class FusedELLScanner(ELLScanner):
    """Engine backend: the fused kernel (K1) per bucket supplies the engine's
    ``decide_moves`` hook; hub rows take the sort-reduce scan + the engine's
    ``gated_move_mask``, the same boolean the kernel computes."""

    def __init__(self, graph: CSRGraph, buckets, leftover, k, m, *,
                 gate_fraction: int):
        super().__init__(graph, buckets, leftover, k, m)
        self.gate_fraction = gate_fraction

    def decide_moves(self, comm, sigma, frontier, comm_l, sizes, round_ix):
        n_cap = self.graph.n_cap
        dev = comm.device
        front = frontier & self._valid          # frontier & move-valid
        best_c = torch.full((n_cap + 1,), n_cap, dtype=torch.int32,
                            device=dev)
        best_dq = torch.full((n_cap + 1,), float("-inf"), dtype=torch.float32,
                             device=dev)
        do_move = torch.zeros(n_cap + 1, dtype=torch.bool, device=dev)
        g = self.graph
        count("scan.ell_rounds")
        for width, rows in self.buckets:
            bc, bdq, mv = scan_ops.louvain_fused(
                rows, g.indptr, g.indices, g.weights, comm, sigma, sizes,
                self.k_local, front, self.m, round_ix, width=width,
                gate_fraction=self.gate_fraction, sentinel=n_cap)
            best_c[rows] = bc
            best_dq[rows] = bdq
            do_move[rows] = mv > 0
        if self.leftover.numel():
            lo = self.leftover
            sc, sdq = self._hub_scan(comm, sigma, frontier)
            gate = (round_gate(self.local_ids, round_ix, self.gate_fraction)
                    if self.gate_fraction > 1 else None)
            mv_all = gated_move_mask(sc, sdq, comm_l, sizes, frontier, n_cap,
                                     self.move_valid, gate)
            best_c[lo] = sc[lo]
            best_dq[lo] = torch.where(front[lo], sdq[lo], float("-inf"))
            do_move[lo] = mv_all[lo]
        best_c[n_cap] = n_cap
        do_move[n_cap] = False
        return do_move, best_c, best_dq


def move_phase_ell(graph: CSRGraph, comm0, sigma0, frontier0,
                   tolerance: float, *, max_iterations: int = 20,
                   use_pruning: bool = True, gate_fraction: int = 2,
                   widths: Optional[Tuple[int, ...]] = (16, 64, 256),
                   fused: bool = False,
                   refine_outer: Optional[torch.Tensor] = None,
                   k: Optional[torch.Tensor] = None):
    """ELL-kernel local-moving phase from a (C, Sigma, frontier) start;
    returns (comm, iters, dq_sum).

    Buckets the graph once per phase, then runs the engine over the scan
    kernel (``fused=False``) or the fused kernel (``fused=True``) — the same
    memberships either way.  ``widths=None`` buckets by ``AUTO_ELL_WIDTHS``
    and keeps only the tiers that hold rows.  ``k`` is the graph's
    ``vertex_weights()``, computed here when not given.  ``refine_outer``
    runs Leiden's constrained sweep: the scanners read one
    cross-outer-masked copy of the CSR's
    ``indices``/``weights`` (``local_move.cross_outer_masked``; the kernels
    and their plain versions build each tile from it, so the tiles are
    masked too) inside a ``ConstrainedScanner``.  The buckets (from
    ``indptr``), ``k`` and ``m`` are the unmasked graph's.
    """
    if widths is None:
        buckets, leftover = degree_tiers(graph, AUTO_ELL_WIDTHS)
    else:
        rows, leftover = ell_bucket_rows(graph, widths)
        buckets = list(zip(widths, rows))
    k = graph.vertex_weights() if k is None else k
    m = graph.total_weight()
    if refine_outer is not None:
        outer, graph = cross_outer_masked(graph, refine_outer)
    if fused:
        scanner = FusedELLScanner(graph, buckets, leftover, k, m,
                                  gate_fraction=gate_fraction)
    else:
        scanner = ELLScanner(graph, buckets, leftover, k, m)
    if refine_outer is not None:
        scanner = ConstrainedScanner(scanner, outer,
                                     gate_fraction=gate_fraction)
    st = MoveEngine(scanner, EngineConfig(
        max_iterations=max_iterations, use_pruning=use_pruning,
        gate_fraction=gate_fraction)).run(comm0, sigma0, frontier0,
                                          tolerance)
    return st.comm, st.iters, st.dq_sum
