"""Batched multi-stream serving of the PyTorch port
(``repro.core.multistream``): many edge streams, one chain of launches.

Serving fleets carry many streams at once: per-user interaction graphs,
per-region topologies, A/B shadow graphs.  Each tenant sends small
edge-batch deltas and wants fresh communities.  Serving them one
``louvain_dynamic`` at a time pays each stream's chain of small launches
and host reads S times; here the whole fleet goes through one chain:

  * ``stack_graphs`` / ``stack_batches`` stack equal-capacity graphs and
    batches along axis 0 (``core.graph.FleetGraph``, ``core.delta.
    FleetBatch``): the fleet provisions one shared (n_cap, e_cap) envelope.
  * Every phase runs over the fleet FLATTENED: stream s's vertex v is the
    flat id s * (n_cap + 1) + v (``FleetGraph.view``), which keeps the
    order within each stream, so sort keys, min-id tie-breaks and the
    singleton-swap guard compare what they compare for the stream alone.
    The Weyl round gate hashes the stream-local id, each stream keeps its
    own m, dQ, tolerance and stop (``MoveEngine.run``), and renumbering is
    per stream.  A single graph runs the same code as a fleet of one.
  * The batch apply (``core.delta.apply_fleet_batch``) and aggregation
    (``core.aggregate.aggregate_fleet``) issue ONE slot-list build, ONE
    stable key sort and ONE launch of K4 or K3 for all S streams.
  * ``louvain_batched`` is the batched pass loop.  Pass-level decisions
    are taken once for the fleet: a stream that converged leaves the
    working set (the reference freezes it at tolerance +inf; the results
    are the same and the work is less), and the capacity ladder picks one
    tier from the largest coarse graph still optimizing.
  * ``louvain_dynamic_batched`` is the streaming driver: per step one fleet
    apply, one delta screen, one warm move phase and one renumber.

Each stream's result equals that stream served alone (``louvain``,
``louvain_dynamic``), element for element, wherever the per-stream sums
are exact in float64: every float sum (m, K, Sigma, dQ, the sort chain's
group weights) accumulates in float64 and rounds once to float32, on the
fleet as alone, so the order and padding of the terms do not matter.  That
holds for integer weights whose sums stay below 2^53, and for float
weights while each sum over the smallest term's last-place unit stays
below 2^53.  K3 on the card adds its group
weights in float32, and on float weights its bits depend on where its
tiles start, so there a fleet's coarse weights (and what follows from
them) equal the solo path's only within ``tests/_k3_bounds.py``.  Capacity
growth is a fleet event: one whale stream overflowing ``e_cap`` re-buckets
every stream into the next power-of-two tier and replays the step
(``grow_capacity``), or raises ``FleetCapacityOverflow``.  The scanner is
the sort-reduce one: ELL bucketing is per-graph host work that does not
batch, so ELL configurations are refused.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.louvain_arch import (_pow2_at_least,
                                              resolve_agg_backend,
                                              resolve_apply_backend)
from repro_torch.core.aggregate import renumber_communities_fleet
from repro_torch.core.delta import (FleetBatch, apply_fleet_batch,
                                    stack_batches)
from repro_torch.core.engine import (affected_frontier, normalize_screening,
                                     resolve_screening_host)
from repro_torch.core.graph import (CSRGraph, FleetGraph,
                                    rebucket_capacity, segment_sum,
                                    stack_graphs)
from repro_torch.core.louvain import (LouvainConfig, PassStats,
                                      _aggregate_phase,
                                      _leiden_warm_membership, _move_phase,
                                      _refine_phase, _renumber_and_fold,
                                      pad_membership, singleton_init,
                                      warm_init)

__all__ = ["BatchedDynamicResult", "BatchedLouvainResult", "FleetBatch",
           "FleetCapacityOverflow", "FleetGraph", "louvain_batched",
           "louvain_dynamic_batched", "stack_batches", "stack_graphs"]


class FleetCapacityOverflow(ValueError):
    """A serving step overflows the fleet's shared ``e_cap`` envelope.

    Raised only under ``grow_capacity=False`` (the default driver
    re-buckets the fleet and replays).  Carries the offending ``step``, the
    worst stream's required slot count ``e_need``, and the envelope
    ``e_cap``."""

    def __init__(self, step: int, e_need: int, e_cap: int):
        super().__init__(
            f"batched step {step} overflows capacity: a stream needs "
            f"{e_need} live directed slots > e_cap={e_cap}")
        self.step, self.e_need, self.e_cap = step, e_need, e_cap


@dataclasses.dataclass
class BatchedLouvainResult:
    membership: torch.Tensor     # (S, n_cap) padded per-stream membership
    n_communities: np.ndarray    # (S,) int
    n_passes: int                # lockstep passes run (max over streams)


@dataclasses.dataclass
class BatchedDynamicResult:
    graphs: FleetGraph           # the fleet after all steps
    membership: np.ndarray       # (S, n_cap) final padded membership
    n_communities: np.ndarray    # (S,) int
    frontier_sizes: np.ndarray   # (n_steps, S) delta-screened seed sizes
    modularity: Optional[np.ndarray]  # (S,) final Q per stream (if tracked)
    total_seconds: float
    n_regrows: int = 0           # fleet-level capacity-growth re-buckets
    #: One row per serving step with the knobs the step ACTUALLY ran with
    #: (fleet-level maxima; ``screening``/``scan_backend`` record the
    #: host-resolved choices, ``downgraded`` flags an "auto" request that
    #: was not honoured as such).
    pass_stats: List[PassStats] = dataclasses.field(default_factory=list)
    #: Per step, host seconds of the fleet apply (ending in its read of the
    #: edge counts) and of the update after it (ending in the renumber's
    #: read), as ``BatchUpdateStats`` records them for one stream; after a
    #: regrow, those of the replayed attempt.
    apply_seconds: List[float] = dataclasses.field(default_factory=list)
    update_seconds: List[float] = dataclasses.field(default_factory=list)

    def stream_membership(self, s: int) -> np.ndarray:
        return self.membership[s, :int(self.graphs.n_valid[s])]


def _refuse_ell(config: LouvainConfig, who: str) -> None:
    if config.use_ell_kernel or config.scan_backend in ("ell", "ell_fused"):
        raise ValueError(f"{who} uses the sort-reduce scanner; ELL "
                         f"bucketing is per-graph host work")


def _rows_at(x, width: int, fill: int, dtype, device) -> torch.Tensor:
    """(S, k) rows as a tensor of ``width`` columns: cut, or padded with
    ``fill``."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x).to(device=device, dtype=dtype)
    if x.shape[1] < width:
        x = torch.cat([x, torch.full((x.shape[0], width - x.shape[1]), fill,
                                     dtype=dtype, device=device)], 1)
    return x[:, :width]


def _fleet_move(gb: FleetGraph, view, comm0, sigma0, frontier0, tol: float,
                config: LouvainConfig, backend: str):
    """One move phase of every stream of ``gb`` through the single-device
    ``_move_phase`` on the fleet's view; returns ((S, n_cap + 1) local
    comm, (S,) host iterations)."""
    tols = np.full(gb.n_streams, tol, np.float64)
    comm, iters, _ = _move_phase(view, comm0, sigma0, frontier0, tols,
                                 config=config, backend=backend)
    return gb.local_vertex_ids(comm), np.asarray(iters)


def louvain_batched(gb: FleetGraph, config: LouvainConfig = LouvainConfig(),
                    *, init_membership=None,
                    init_frontier=None) -> BatchedLouvainResult:
    """Batched pass loop over a fleet, on the fleet's device; see the module
    docstring.

    ``init_membership`` ((S, n_cap) or (S, n_cap + 1)) warm-starts pass 0
    per stream; ``init_frontier`` ((S, n_cap + 1) bool) seeds delta
    screening.  Streams converge independently; a stream that stopped
    keeps its membership while the rest finish.  With ``config.use_ladder``
    the coarse passes ride the capacity ladder at fleet granularity: one
    tier per pass, from the largest coarse size over the streams still
    optimizing (memberships do not depend on capacity).

    ``config.refine="leiden"`` runs the constrained refinement sweep over
    the fleet: aggregation follows each stream's refined partition, the
    reported membership and the next pass's warm start its outer one.
    ``config.agg_backend`` has its usual meaning: ``"auto"`` is K3 on the
    card, one launch per fleet aggregation.  The reference keeps ``"auto"``
    on its sort chain here because its vmapped kernel is no tuned fleet
    path; the port's fleet launch is the tuned kernel, and the results are
    equal either way.  ``config.scan_backend="compact"`` with a seed
    frontier runs pass 0 through the compacted scanner; ``"auto"`` keeps
    the full scan, as in the reference.
    """
    _refuse_ell(config, "louvain_batched")
    refine_on = config.refine == "leiden"
    S, n_cap = gb.n_streams, gb.n_cap
    dev = gb.device
    agg_backend = resolve_agg_backend(config.agg_backend, dev)

    global_comm = torch.arange(n_cap, dtype=torch.int32,
                               device=dev).repeat(S, 1)
    report_comm = global_comm.clone()
    n_valid0 = gb.n_valid.copy()
    n_comms_final = gb.n_valid.copy()
    rows = np.arange(S)          # the streams still optimizing, fleet order
    tol = float(config.initial_tolerance)
    mem = (None if init_membership is None else
           _rows_at(init_membership, n_cap + 1, n_cap, torch.int32, dev))
    fr = (None if init_frontier is None else
          _rows_at(init_frontier, n_cap + 1, False, torch.bool, dev))
    leiden_mem = None

    passes = 0
    for p in range(config.max_passes):
        view = gb.view()
        if p == 0 and mem is not None:
            comm0, sigma0, frontier0 = warm_init(
                view, gb.flat_vertex_ids(mem),
                None if fr is None else gb.flat_vertex_mask(fr))
        elif leiden_mem is not None:
            comm0, sigma0, frontier0 = warm_init(
                view, gb.flat_vertex_ids(leiden_mem))
        else:
            comm0, sigma0, frontier0 = singleton_init(view)
            if p == 0 and fr is not None:
                frontier0 = frontier0 & gb.flat_vertex_mask(fr)
        compact = (p == 0 and fr is not None
                   and config.scan_backend == "compact")
        comm, iters = _fleet_move(gb, view, comm0, sigma0, frontier0, tol,
                                  config, "compact" if compact else "full")
        rows_t = torch.from_numpy(rows).to(dev)
        if refine_on:
            refined = gb.local_vertex_ids(_refine_phase(
                view, gb.flat_vertex_ids(comm),
                np.full(gb.n_streams, tol, np.float64),
                max_iterations=config.max_iterations,
                use_pruning=config.use_pruning,
                gate_fraction=config.gate_fraction)[0])
            outer_ren, n_report, report_fold = _renumber_and_fold(
                comm, gb.n_valid, global_comm[rows_t])
            comm_ren, n_comms, folded = _renumber_and_fold(
                refined, gb.n_valid, global_comm[rows_t])
        else:
            comm_ren, n_comms, folded = _renumber_and_fold(
                comm, gb.n_valid, global_comm[rows_t])
            report_fold, n_report = folded, n_comms
        global_comm[rows_t] = folded
        report_comm[rows_t] = report_fold
        n_comms_final[rows] = n_report
        passes = p + 1

        converged = iters <= 1
        low_shrink = (n_report / np.maximum(gb.n_valid, 1)
                      > config.aggregation_tolerance)
        keep = np.nonzero(~converged & ~low_shrink)[0]
        if p == config.max_passes - 1 or keep.size == 0:
            break
        keep_t = torch.from_numpy(keep).to(dev)
        gb = gb.take(keep)
        comm_ren, n_comms = comm_ren[keep_t], n_comms[keep]
        if refine_on:
            # The outer partition on the coarse vertices, at the fine
            # capacity (the single-device function on flat ids, with
            # per-vertex thresholds); resized once the coarse tier is known.
            warm_c = gb.local_vertex_ids(_leiden_warm_membership(
                gb.flat_vertex_ids(comm_ren),
                gb.flat_vertex_ids(outer_ren[keep_t]),
                gb.thresholds(gb.n_valid), gb.thresholds(n_comms)))
        gb = _aggregate_phase(gb, comm_ren, n_comms, backend=agg_backend,
                              use_ladder=config.use_ladder)
        if refine_on:
            cap2 = gb.n_cap
            body = _rows_at(warm_c, cap2 + 1, cap2, torch.int32, dev)
            idx2 = torch.arange(cap2 + 1, device=dev)[None, :]
            n_agg = torch.from_numpy(gb.n_valid).to(dev)[:, None]
            leiden_mem = torch.where(idx2 < n_agg, body, cap2)
        rows = rows[keep]
        tol /= config.tolerance_drop

    # Invalid slots hold the ORIGINAL sentinel: a fold through a laddered
    # pass leaves the small tier's sentinel there, which a later warm start
    # would read as a community.
    idx = torch.arange(n_cap, device=dev)[None, :]
    nv0 = torch.from_numpy(n_valid0).to(dev)[:, None]
    report_comm = torch.where(idx < nv0, report_comm, n_cap)
    return BatchedLouvainResult(membership=report_comm,
                                n_communities=n_comms_final.astype(int),
                                n_passes=passes)


def _fleet_modularity(fleet: FleetGraph, comm: torch.Tensor) -> np.ndarray:
    """(S,) Q of each stream (Eq. 1) for (S, n_cap + 1) memberships, as
    ``core.modularity.modularity`` computes it for one graph (float32 sums
    in another order: equal within float32 rounding)."""
    m = fleet.total_weight()
    same = (torch.gather(comm, 1, fleet.src.to(torch.int64))
            == torch.gather(comm, 1, fleet.indices.to(torch.int64)))
    internal = torch.sum(torch.where(same, fleet.weights, 0.0), 1)
    view = fleet.view()
    k = view.vertex_weights()[:fleet.sentinel].view(comm.shape)
    flat = fleet.flat_vertex_ids(comm)[:fleet.sentinel]
    sig = segment_sum(k.reshape(-1), flat.to(torch.int64),
                      fleet.sentinel + 1)[:fleet.sentinel].view(comm.shape)
    m_safe = torch.where(m > 0, m, 1.0)
    q = (internal / (2.0 * m_safe)
         - torch.sum((sig / (2.0 * m_safe[:, None])) ** 2, 1))
    return torch.where(m > 0, q, 0.0).cpu().numpy()


def _serve_step(fleet: FleetGraph, batch: FleetBatch, mem: torch.Tensor,
                mode: Optional[str], config: LouvainConfig, compact: bool,
                apply_backend: str):
    """One fused serving step of the whole fleet: batch apply, delta
    screen, warm init, one move phase, renumber.  Returns (fleet', (S,
    n_cap) membership, (S, n_cap + 1) frontier, (S,) iterations, (S,)
    uncapped edge counts, (S,) touched counts, apply seconds); the
    membership and iterations are None when a stream overflowed (the
    caller regrows and replays)."""
    t0 = time.perf_counter()
    n_cap = fleet.n_cap
    fleet2, touched, e_new, n_touched = apply_fleet_batch(
        fleet, batch, backend=apply_backend)
    t_apply = time.perf_counter() - t0
    if int(e_new.max()) > fleet.e_cap:
        return fleet2, None, None, None, e_new, n_touched, t_apply
    view = fleet2.view()
    mem_pad = _rows_at(mem, n_cap + 1, n_cap, torch.int32, fleet.device)
    mem_flat = fleet2.flat_vertex_ids(mem_pad)
    if mode is not None:
        frontier = affected_frontier(fleet2.flat_vertex_mask(touched),
                                     mem_flat, view.n_valid, mode)
    else:
        frontier = (torch.arange(fleet2.sentinel + 1, device=fleet.device)
                    < view.n_valid)
    comm0, sigma0, frontier0 = warm_init(view, mem_flat, frontier)
    comm, iters = _fleet_move(fleet2, view, comm0, sigma0, frontier0,
                              float(config.initial_tolerance), config,
                              "compact" if compact else "full")
    comm_ren, _ = renumber_communities_fleet(comm, fleet2.n_valid)
    return (fleet2, comm_ren[:, :n_cap], fleet2.local_vertex_mask(frontier),
            iters, e_new, n_touched, t_apply)


def louvain_dynamic_batched(
    graphs: Sequence[CSRGraph],
    streams: Sequence[Sequence],
    prevs: Optional[Sequence[np.ndarray]] = None,
    config: LouvainConfig = LouvainConfig(),
    *,
    screening=True,
    track_modularity: bool = False,
    apply_backend: str = "auto",
    grow_capacity: bool = True,
) -> BatchedDynamicResult:
    """Serve S independent edge streams through one batched driver, on the
    graphs' device.

    ``streams[s]`` is stream s's batch sequence; all streams have the same
    number of steps and per-step ``b_cap`` (pad short streams with empty
    batches).  ``prevs`` are the per-stream memberships before the stream
    ((n,), (n_cap,) or (n_cap + 1,) each); ``None`` runs one batched cold
    start.  Per step: one fleet batch apply, one delta screen
    (``screening`` as in ``louvain_dynamic``), one warm move phase and one
    renumber; a step in which some stream needs more than one sweep is
    redone from its pre-step membership through ``louvain_batched``'s
    general pass loop.  ``apply_backend``: ``"auto"`` (K4 on the card, the
    sort chain on the CPU), ``"kernel"`` or ``"sort"``: equal results.

    ``screening="auto"`` is resolved on the host per step, from the
    previous step's worst touched fraction (``resolve_screening_host``; the
    first step is a flagged downgrade to ``"community"``).  With
    screening, ``config.scan_backend="auto"`` runs the full scan and is
    recorded as ``downgraded``; ``"compact"`` is honoured (bit-identical).

    A step overflowing the fleet's ``e_cap`` re-buckets every stream into
    the next power-of-two edge tier and replays the step against the
    pre-apply fleet (``grow_capacity``, counted in ``n_regrows``); with
    ``grow_capacity=False`` it raises ``FleetCapacityOverflow``.

    The reference enqueues every step with no host read and validates
    afterwards (its optimistic pass), falling back to a per-step validated
    loop.  The port's engine reads each sweep's dQ anyway, so it validates
    every step as it goes: overflow and convergence are known before the
    next step starts.  That is the reference's validated loop, and it gives
    the optimistic pass's results and ``pass_stats`` whenever the
    optimistic pass would have kept them.
    """
    t_start = time.perf_counter()
    S = len(graphs)
    if len(streams) != S:
        raise ValueError(f"{S} graphs but {len(streams)} streams")
    n_steps = len(streams[0])
    if any(len(s) != n_steps for s in streams):
        raise ValueError("all streams must have the same number of steps")
    _refuse_ell(config, "louvain_dynamic_batched")
    screen_mode = normalize_screening(screening)
    fleet = stack_graphs(list(graphs))
    n_cap, e_cap = fleet.n_cap, fleet.e_cap
    dev = fleet.device
    resolve_apply_backend(apply_backend, dev)   # refuse a bad name up front

    compact = config.scan_backend == "compact" and screen_mode is not None
    scan_used = "compact" if compact else "full"
    # Flag the scanner downgrade only where "auto" could have picked the
    # compacted scanner (it needs a screened frontier).
    scan_down = config.scan_backend == "auto" and screen_mode is not None

    if prevs is None:
        mem = louvain_batched(fleet, config).membership
    else:
        mem = torch.from_numpy(np.stack([
            pad_membership(np.asarray(p, np.int32)[:n_cap], n_cap)[:n_cap]
            for p in prevs])).to(dev)
    batches = [stack_batches([streams[s][t] for s in range(S)])
               for t in range(n_steps)]

    n_regrows = 0
    stats: List[PassStats] = []
    sizes: List[torch.Tensor] = []
    apply_s: List[float] = []
    update_s: List[float] = []
    touched_frac = None
    for step in range(n_steps):
        mode, mode_down = resolve_screening_host(screen_mode, touched_frac)
        while True:
            t0 = time.perf_counter()
            (fleet2, mem_new, frontier, iters, e_new, n_touched,
             t_apply) = _serve_step(fleet, batches[step], mem, mode, config,
                                    compact, apply_backend)
            if mem_new is not None:
                break
            if not grow_capacity:
                raise FleetCapacityOverflow(step, int(e_new.max()), e_cap)
            # One whale stream outgrew the envelope: re-bucket the WHOLE
            # fleet into the next power-of-two tier and replay the step
            # against the pre-apply fleet.
            e_cap = _pow2_at_least(int(e_new.max()))
            fleet = rebucket_capacity(fleet, n_cap_new=n_cap, e_cap_new=e_cap)
            n_regrows += 1
        if int(iters.max()) > 1:
            mem_new = louvain_batched(
                fleet2, config, init_membership=mem,
                init_frontier=frontier if mode is not None else None
            ).membership
        # Host side of the next step's "auto" resolution, in the
        # reference's float32 arithmetic.
        nv = fleet2.n_valid
        touched_frac = float(np.max(n_touched.astype(np.float32)
                                    / np.maximum(nv, 1).astype(np.float32)))
        fleet, mem = fleet2, mem_new
        sizes.append(frontier.sum(1) if mode is not None
                     else torch.from_numpy(nv.copy()))
        apply_s.append(t_apply)
        update_s.append(time.perf_counter() - t0 - t_apply)
        stats.append(PassStats(
            iterations=int(iters.max()), n_communities=0,
            n_vertices=int(nv.max()), dq_sum=0.0, seconds=0.0,
            phase_seconds={}, frontier_size=None, n_cap=n_cap, e_cap=e_cap,
            screening=mode, scan_backend=scan_used,
            downgraded=bool(mode_down or scan_down)))

    frontier_sizes = (np.stack([x.cpu().numpy() for x in sizes])
                      if sizes else np.zeros((0, S), np.int64))
    for st, row in zip(stats, frontier_sizes):
        st.frontier_size = int(row.max())
    q = None
    if track_modularity:
        q = _fleet_modularity(fleet, torch.cat([
            mem, torch.full((S, 1), n_cap, dtype=torch.int32, device=dev)],
            1))
    mem_np = mem.cpu().numpy()
    return BatchedDynamicResult(
        graphs=fleet, membership=mem_np,
        n_communities=np.array([len(np.unique(mem_np[s, :fleet.n_valid[s]]))
                                for s in range(S)]),
        frontier_sizes=frontier_sizes, modularity=q,
        total_seconds=time.perf_counter() - t_start, n_regrows=n_regrows,
        pass_stats=stats, apply_seconds=apply_s, update_seconds=update_s)
