"""GVE-Louvain main loop (Algorithm 1) of the PyTorch port
(``repro.core.louvain``): passes of local-moving + aggregation, with the
paper's defaults (MAX_PASSES=10, MAX_ITERATIONS=20, initial tolerance 0.01,
TOLERANCE_DROP=10, aggregation tolerance 0.8, vertex pruning on).

The single-device loop: the singleton or warm start
(``init_membership``/``init_frontier``, which ``core/dynamic.py`` builds
on), local-moving on the sort-reduce scanner (``"full"``), its
frontier-compacted form (``"compact"``) or the ELL kernels (``"ell"``,
``"ell_fused"``; ``"auto"`` takes the fused kernel K1 for full scans on
CUDA while its float32 sums are exact), with ``refine="leiden"`` a
constrained refinement sweep after each local-moving phase,
renumber-and-fold, aggregation by the sort chain or the kernel K3, and the
capacity ladder.  It runs on the device of the graph it is given.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.louvain_arch import (COMPACT_WORK_FRAC,
                                              compact_work_cap,
                                              resolve_agg_backend,
                                              resolve_coarse_capacity,
                                              resolve_scan_backend)
from repro_torch.core.aggregate import (aggregate_fleet,
                                        renumber_communities_fleet)
from repro_torch.core.ell_move import move_phase_ell
from repro_torch.core.engine import affected_frontier, valid_ids
from repro_torch.core.graph import (CSRGraph, FleetGraph, rebucket_capacity,
                                    stack_graphs)
from repro_torch.core.local_move import move_phase
from repro_torch.core.modularity import community_weights, modularity
from repro_torch.core.spans import span
from repro_torch.kernels.louvain_scan.louvain_scan import check_ell_width

_INT_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class LouvainConfig:
    """Paper §4.1 parameter set; the JAX ``LouvainConfig``'s fields and
    defaults.  The sharded-only fields (``comm_backend``, ``reshard``,
    ``pipeline_fetch``, ``state_layout``) are ignored, as the reference's
    single-device ``louvain()`` ignores them.  An ``ell_widths`` entry
    below 1 raises ``ELLWidthError`` here on every device; every width
    from 1 up has a layout of the kernels K1/K2."""

    max_passes: int = 10
    max_iterations: int = 20          # opt. 4.1.2
    initial_tolerance: float = 0.01   # opt. 4.1.4
    tolerance_drop: float = 10.0      # opt. 4.1.3 (threshold scaling)
    aggregation_tolerance: float = 0.8  # opt. 4.1.5
    use_pruning: bool = True          # opt. 4.1.6
    gate_fraction: int = 2            # stochastic round gating
    use_ell_kernel: bool = False      # ELL scan kernels for the move phase
    ell_widths: tuple = (16, 64, 256)
    track_modularity: bool = False    # record Q after every pass
    #: "auto" | "full" | "compact" | "ell" | "ell_fused".
    scan_backend: str = "auto"
    compact_cap_frac: float = COMPACT_WORK_FRAC
    #: "auto" | "sort" | "kernel" ("auto": the kernel on CUDA, else sort).
    agg_backend: str = "auto"
    use_ladder: bool = True
    comm_backend: str = "auto"
    #: "none" | "leiden": after each local-moving phase, a constrained
    #: sweep from singletons (moves within the outer community, singleton
    #: movers only) refines the partition; aggregation follows the refined
    #: partition, the reported membership the outer one.
    refine: str = "none"
    reshard: str = "none"
    pipeline_fetch: bool = False
    state_layout: str = "replicated"

    def __post_init__(self):
        if self.refine not in ("none", "leiden"):
            raise ValueError(f"refine must be 'none' or 'leiden', "
                             f"got {self.refine!r}")
        for width in self.ell_widths:
            check_ell_width(width)


@dataclasses.dataclass
class PassStats:
    iterations: int
    n_communities: int
    n_vertices: int
    dq_sum: float
    seconds: float
    phase_seconds: dict
    modularity: Optional[float] = None
    frontier_size: Optional[int] = None
    n_cap: Optional[int] = None          # capacities the pass ran at
    e_cap: Optional[int] = None
    #: Scanner the pass ran with ("full" | "compact" | "ell" | "ell_fused").
    scan_backend: Optional[str] = None
    refine_iterations: Optional[int] = None  # constrained-sweep iterations
    n_refined: Optional[int] = None      # refined (aggregation) communities
    #: Screening granularity a batched serving step ran with ("community" |
    #: "vertex" | None): the batched driver resolves "auto" on the host and
    #: records the concrete choice.
    screening: Optional[str] = None
    #: True when a requested "auto" knob was downgraded to a concrete
    #: choice (the batched driver's record, see ``core/multistream.py``).
    downgraded: Optional[bool] = None


@dataclasses.dataclass
class LouvainResult:
    membership: np.ndarray       # (n,) community id per original vertex
    n_communities: int
    passes: List[PassStats]
    total_seconds: float
    #: ``levels[p]`` is the (n,) membership of the original vertices after
    #: pass p; ``levels[-1] == membership``.  With ``refine="leiden"`` the
    #: levels are the outer partitions and need not nest (aggregation
    #: follows the refined ones).
    levels: List[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def n_passes(self) -> int:
        return len(self.passes)


def pad_membership(mem, n_cap: int) -> np.ndarray:
    """Pad a flat (n,) membership to the (n_cap + 1,) sentinel layout."""
    out = np.full(n_cap + 1, n_cap, np.int32)
    mem = np.asarray(mem, np.int32)
    out[: len(mem)] = mem
    return out


def screened_frontier(touched: torch.Tensor, membership: torch.Tensor,
                      n_valid: int, mode: str = "community") -> torch.Tensor:
    """Delta-screened seed frontier from a touched-vertex mask: the
    engine-level ``affected_frontier`` under the reference's name."""
    return affected_frontier(touched, membership, n_valid, mode)


def singleton_init(graph: CSRGraph):
    """(comm0, sigma0, frontier0) of the cold singleton start."""
    n_cap = graph.n_cap
    comm0 = torch.arange(n_cap + 1, dtype=torch.int32, device=graph.device)
    sigma0 = graph.vertex_weights()
    frontier0 = torch.arange(n_cap + 1, device=graph.device) < graph.n_valid
    return comm0, sigma0, frontier0


def warm_init(graph: CSRGraph, membership: torch.Tensor,
              frontier: Optional[torch.Tensor] = None):
    """(comm0, sigma0, frontier0) resuming from ``membership``.

    ``membership`` holds (n_cap,) or (n_cap + 1,) community ids in vertex-id
    space.  Invalid vertex slots become the sentinel; a valid vertex whose
    previous id is >= n_cap (one that entered through an edge insert) gets
    its own singleton.  ``sigma0`` is recomputed from the CURRENT graph, so
    a warm start stays exact after edge-batch updates.  ``frontier``
    optionally seeds delta screening.
    """
    n_cap = graph.n_cap
    dev = graph.device
    idx = torch.arange(n_cap + 1, dtype=torch.int32, device=dev)
    valid = idx < graph.n_valid
    mem = torch.cat([membership[:n_cap].to(device=dev, dtype=torch.int32),
                     torch.full((1,), n_cap, dtype=torch.int32, device=dev)])
    assigned = torch.where(mem < n_cap, mem, idx)
    comm0 = torch.where(valid, assigned, n_cap)
    sigma0 = community_weights(graph, comm0)
    frontier0 = valid if frontier is None else (frontier[: n_cap + 1] & valid)
    return comm0, sigma0, frontier0


def _renumber_and_fold(comm: torch.Tensor, n_valid,
                       global_comm: torch.Tensor):
    """Renumber each stream's pass-level communities and fold them into its
    dendrogram lookup: ``comm`` (S, n_cap + 1), ``n_valid`` (S,) host
    ints, ``global_comm`` (S, n_cap0) at the original capacity, whose
    invalid slots hold stale sentinels that clamp into the current
    sentinel slot (the reference's clamped gather).  Returns (comm_new,
    (S,) host counts, folded)."""
    n_cap = comm.shape[1] - 1
    comm_new, n_comms = renumber_communities_fleet(comm, n_valid)
    folded = torch.gather(comm_new, 1, torch.clamp(global_comm, max=n_cap)
                          .to(torch.int64))
    return comm_new, n_comms, folded


def _renumber_and_fold_one(comm: torch.Tensor, n_valid: int,
                           global_comm: torch.Tensor):
    """``_renumber_and_fold`` of one graph: 1-D rows, a host int count."""
    comm_new, n_comms, folded = _renumber_and_fold(comm[None], [n_valid],
                                                   global_comm[None])
    return comm_new[0], int(n_comms[0]), folded[0]


def _ell_widths(config: LouvainConfig):
    """The ELL widths of a pass: ``config.ell_widths`` for an explicit ELL
    request; None on ``"auto"``'s own route to K1, which buckets by the
    pass's degree histogram (``ell_move.move_phase_ell``)."""
    explicit = config.use_ell_kernel or config.scan_backend != "auto"
    return config.ell_widths if explicit else None


def _move_phase(graph, comm0, sigma0, frontier0, tolerance, *,
                config: LouvainConfig, backend: str, k=None):
    """One local-moving phase on the scanner ``backend`` (``"full"``,
    ``"compact"``, ``"ell"`` or ``"ell_fused"``) from a (C, Sigma,
    frontier) start; returns (comm, iters, dq_sum).  ``graph`` may be a
    fleet's ``FleetView`` with one tolerance per stream (the batched
    driver, ``core/multistream.py``, on the sort-reduce scanners).  ``k``
    is the graph's ``vertex_weights()``, computed by the phase when not
    given."""
    if backend in ("ell", "ell_fused"):
        return move_phase_ell(
            graph, comm0, sigma0, frontier0, tolerance,
            max_iterations=config.max_iterations,
            use_pruning=config.use_pruning,
            gate_fraction=config.gate_fraction, widths=_ell_widths(config),
            fused=backend == "ell_fused", k=k)
    return move_phase(
        graph, comm0, sigma0, frontier0, tolerance,
        max_iterations=config.max_iterations, use_pruning=config.use_pruning,
        gate_fraction=config.gate_fraction,
        work_cap=(compact_work_cap(graph.e_cap, config.compact_cap_frac)
                  if backend == "compact" else 0), k=k)


def _refine_phase(graph: CSRGraph, outer: torch.Tensor, tolerance: float,
                  *, max_iterations: int, use_pruning: bool,
                  gate_fraction: int = 2, k=None):
    """Leiden refinement on the sort-reduce scanner: from singletons, the
    constrained sweep (``move_phase(refine_outer=outer)``) yields a
    partition that refines ``outer``; returns (comm, iters, dq_sum).
    ``k``/``m`` are the full graph's: the constraint restricts candidates,
    not the objective.  ``graph`` may be a fleet's ``FleetView`` with one
    tolerance per stream."""
    comm0, sigma0, frontier0 = singleton_init(graph)
    return move_phase(graph, comm0, sigma0, frontier0, tolerance,
                      max_iterations=max_iterations, use_pruning=use_pruning,
                      gate_fraction=gate_fraction, refine_outer=outer, k=k)


def _aggregate_phase(fleet: FleetGraph, comm_ren: torch.Tensor, n_comms,
                     *, backend: str, use_ladder: bool) -> FleetGraph:
    """Aggregation of every stream (``aggregate_fleet``; a graph is a
    one-stream fleet) and, with ``use_ladder``, the re-bucket down to one
    capacity tier for the fleet, from its largest coarse graph."""
    gb = aggregate_fleet(fleet, comm_ren, n_comms, backend=backend)
    if use_ladder:
        n_cap_new, e_cap_new = resolve_coarse_capacity(
            int(gb.n_valid.max()), int(gb.e_valid.max()), gb.n_cap,
            gb.e_cap)
        if (n_cap_new, e_cap_new) != (gb.n_cap, gb.e_cap):
            gb = rebucket_capacity(gb, n_cap_new=n_cap_new,
                                   e_cap_new=e_cap_new)
    return gb


def _leiden_warm_membership(comm_ren: torch.Tensor, outer_ren: torch.Tensor,
                            n_valid, n_agg) -> torch.Tensor:
    """Next-pass warm start after aggregating the refined partition.

    The coarse graph's vertices are the refined communities; the next pass
    starts from the outer partition expressed on them.  The outer label is
    constant over each refined community, so scattering ``outer_ren``
    through ``comm_ren`` is well defined; each live coarse vertex
    (< ``n_agg``) is labelled with the smallest coarse id that shares its
    outer community.  ``n_valid`` may also be the bool live mask of a
    re-sharded sharded layout (``engine.valid_ids``).  Returns (cap + 1,)
    int32, cap = len(comm_ren) - 1.
    """
    cap = comm_ren.shape[0] - 1
    dev = comm_ren.device
    idx = torch.arange(cap + 1, dtype=torch.int32, device=dev)
    valid = valid_ids(idx, n_valid, cap)
    tgt = torch.where(valid, torch.clamp(comm_ren, max=cap), cap)
    oc = torch.full((cap + 1,), cap, dtype=torch.int32, device=dev)
    oc[tgt.to(torch.int64)] = torch.where(valid, outer_ren.to(torch.int32),
                                          cap)
    live = idx < n_agg
    oc = torch.where(live, torch.clamp(oc, max=cap), cap)
    # segment_min over the outer labels; an empty segment keeps INT_MAX.
    rep = torch.full((cap + 1,), _INT_MAX, dtype=torch.int32, device=dev)
    rep.scatter_reduce_(0, oc.to(torch.int64), torch.where(live, idx, cap),
                        "amin", include_self=True)
    rep = torch.clamp(rep, max=cap)
    return torch.where(live, rep[oc], cap)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def louvain(graph: CSRGraph, config: LouvainConfig = LouvainConfig(), *,
            init_membership=None, init_frontier=None) -> LouvainResult:
    """Run GVE-Louvain on the graph's device; returns the flat membership
    of the original vertices, per-pass stats and the dendrogram levels.

    ``init_membership`` warm-starts the FIRST pass from a previous partition
    ((n,), (n_cap,) or (n_cap + 1,) community ids) instead of singletons;
    ``init_frontier`` restricts that pass's seed frontier to a boolean
    vertex mask (delta screening, see ``core/dynamic.py``), with or without
    a warm membership.  Later passes restart from singletons on the coarse
    graph; with ``refine="leiden"`` they start from the outer partition on
    the coarse graph (``_leiden_warm_membership``).  With an active seed
    frontier, ``scan_backend="auto"`` scans through the frontier-compacted
    scanner when |F|/n <= 10%; otherwise, on a CUDA graph whose weights
    keep K1's float32 sums exact, through K1 over the pass's degree tiers.

    Memberships equal the reference's ``louvain()`` element for element on
    every scanner and aggregation backend.
    """
    with span("louvain") as call:
        with span("louvain.start", host=True):
            start = _start(graph, init_membership, init_frontier)
        membership, passes, levels = _passes(graph, config, *start)
        with span("louvain.finish", host=True):
            n_communities = int(len(np.unique(membership)))
    return LouvainResult(membership=membership, n_communities=n_communities,
                         passes=passes, total_seconds=call.seconds,
                         levels=levels)


def _start(graph: CSRGraph, init_membership, init_frontier):
    """The start of pass 0: (warm, fr, frontier_size0), ``warm`` the
    (comm0, sigma0, frontier0) of a warm or screened start (None for the
    singleton start), ``fr`` the screened frontier at capacity (or None)
    and ``frontier_size0`` its size on the host."""
    dev = graph.device
    n_cap = graph.n_cap
    warm = None
    fr = None
    if init_frontier is not None:
        # Device-resident frontiers (delta screening) stay on the device.
        fr = torch.as_tensor(init_frontier, device=dev).to(torch.bool)
        if fr.shape[0] < n_cap + 1:
            fr = torch.cat([fr, torch.zeros(n_cap + 1 - fr.shape[0],
                                            dtype=torch.bool, device=dev)])
        fr = fr[: n_cap + 1]
    if init_membership is not None:
        mem = np.asarray(init_membership, dtype=np.int32)
        if len(mem) < n_cap + 1:   # pad (n,) / (n_cap,) inputs to capacity
            mem = np.concatenate(
                [mem, np.full(n_cap + 1 - len(mem), n_cap, np.int32)])
        warm = warm_init(graph, torch.from_numpy(mem), fr)
    elif fr is not None:
        # A screened frontier over a cold singleton start is honoured too.
        comm0, sigma0, frontier0_all = singleton_init(graph)
        warm = (comm0, sigma0, fr & frontier0_all)
    frontier_size0 = int(warm[2].sum()) if warm is not None else None
    return warm, fr, frontier_size0


def _passes(graph: CSRGraph, config: LouvainConfig, warm, fr,
            frontier_size0):
    """The pass loop of ``louvain()`` from ``_start``'s pass-0 start:
    (membership, passes, levels)."""
    dev = graph.device
    n_cap = graph.n_cap
    n = graph.n_valid
    global_comm = torch.arange(n_cap, dtype=torch.int32, device=dev)

    g = graph
    tol = float(config.initial_tolerance)
    passes: List[PassStats] = []
    agg_backend = resolve_agg_backend(config.agg_backend, dev)
    levels: List[np.ndarray] = []
    refine_on = config.refine == "leiden"
    leiden_warm = None     # the outer partition on the next coarse graph

    for p in range(config.max_passes):
        with span("louvain.pass", **{"pass": p}) as pass_span:
            with span("louvain.move") as move_span:
                if p == 0 and warm is not None:
                    comm0, sigma0, frontier0 = warm
                    pass_frontier = frontier_size0
                elif leiden_warm is not None:
                    comm0, sigma0, frontier0 = warm_init(g, leiden_warm)
                    pass_frontier = None
                else:
                    comm0, sigma0, frontier0 = singleton_init(g)
                    pass_frontier = None
                # A screened frontier is active only on pass 0 with
                # init_frontier; warm-only starts re-scan all vertices, so
                # compaction buys nothing.
                frontier_frac = (frontier_size0 / max(n, 1)
                                 if p == 0 and fr is not None else None)
                k = g.vertex_weights()
                backend = resolve_scan_backend(
                    config.scan_backend, use_ell_kernel=config.use_ell_kernel,
                    frontier_frac=frontier_frac, device=dev,
                    weights=g.weights, k=k)
                comm, iters, dq_sum = _move_phase(g, comm0, sigma0, frontier0,
                                                  tol, config=config,
                                                  backend=backend, k=k)
                _sync(dev)

            refine_iters = refine_span = None
            if refine_on:
                with span("louvain.refine") as refine_span:
                    if backend in ("ell", "ell_fused"):
                        refined, refine_iters, _ = move_phase_ell(
                            g, *singleton_init(g), tol,
                            max_iterations=config.max_iterations,
                            use_pruning=config.use_pruning,
                            gate_fraction=config.gate_fraction,
                            widths=_ell_widths(config),
                            fused=backend == "ell_fused", refine_outer=comm,
                            k=k)
                    else:
                        refined, refine_iters, _ = _refine_phase(
                            g, comm, tol, max_iterations=config.max_iterations,
                            use_pruning=config.use_pruning,
                            gate_fraction=config.gate_fraction, k=k)
                    _sync(dev)

            with span("louvain.fold") as fold_span:
                if refine_on:
                    # Two folds off the same pre-pass global_comm: the outer
                    # fold is what the pass reports, the refined fold is
                    # what aggregation and the dendrogram chain follow.
                    outer_ren, n_report, level = _renumber_and_fold_one(
                        comm, g.n_valid, global_comm)
                    comm_ren, n_comms, folded = _renumber_and_fold_one(
                        refined, g.n_valid, global_comm)
                else:
                    comm_ren, n_comms, folded = _renumber_and_fold_one(
                        comm, g.n_valid, global_comm)
                    level, n_report = folded, n_comms
                global_comm = folded
                n_verts = g.n_valid
            with span("louvain.level", host=True) as level_span:
                levels.append(level[:n].cpu().numpy())

            q_now = (float(modularity(graph, torch.cat(
                [level, torch.tensor([n_cap], dtype=torch.int32,
                                     device=dev)])))
                if config.track_modularity else None)

            converged = iters <= 1                                # line 7
            low_shrink = (n_report / max(n_verts, 1)
                          > config.aggregation_tolerance)

            pass_caps = (g.n_cap, g.e_cap)
            agg_span = None
            if not (converged or low_shrink or p == config.max_passes - 1):
                with span("louvain.aggregate") as agg_span:
                    g = _aggregate_phase(stack_graphs([g]), comm_ren[None],
                                         [n_comms], backend=agg_backend,
                                         use_ladder=config.use_ladder
                                         ).stream(0)
                    if refine_on:
                        warm_flat = _leiden_warm_membership(
                            comm_ren, outer_ren, n_verts, n_comms)
                        leiden_warm = torch.full((g.n_cap + 1,), g.n_cap,
                                                 dtype=torch.int32, device=dev)
                        leiden_warm[:n_comms] = warm_flat[:n_comms]
                    _sync(dev)

        phase_seconds = {
            "local_move": move_span.seconds,
            "other": fold_span.seconds + level_span.seconds,
            "aggregate": agg_span.seconds if agg_span is not None else 0.0}
        if refine_on:
            phase_seconds["refine"] = refine_span.seconds
        passes.append(PassStats(
            iterations=iters, n_communities=n_report, n_vertices=n_verts,
            dq_sum=float(dq_sum), seconds=pass_span.seconds,
            phase_seconds=phase_seconds, modularity=q_now,
            frontier_size=(pass_frontier if pass_frontier is not None
                           else n_verts),
            n_cap=pass_caps[0], e_cap=pass_caps[1], scan_backend=backend,
            refine_iterations=refine_iters,
            n_refined=n_comms if refine_on else None))
        if converged or low_shrink:
            break
        tol = tol / config.tolerance_drop            # line 13

    # With refinement global_comm follows the refined partitions; the
    # reported membership is the last pass's outer level.
    membership = levels[-1] if levels else global_comm[:n].cpu().numpy()
    return membership, passes, levels


def membership_modularity(graph: CSRGraph, membership) -> float:
    """Q of a flat (n,) membership array on ``graph`` (sentinel-padded)."""
    mem = torch.as_tensor(np.asarray(membership, np.int32),
                          device=graph.device)
    pad = torch.full((graph.n_cap + 1 - mem.shape[0],), graph.n_cap,
                     dtype=torch.int32, device=graph.device)
    return float(modularity(graph, torch.cat([mem, pad])))


def louvain_modularity(graph: CSRGraph, result: LouvainResult) -> float:
    """Q of a result on the original graph."""
    return membership_modularity(graph, result.membership)
