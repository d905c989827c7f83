"""The bulk-synchronous move engine of the PyTorch port (``repro.core.engine``).

``MoveEngine`` owns the round loop of Algorithm 2: a sweep is
``gate_fraction`` gated rounds, and each stream sweeps until its sweep's
total dQ is at most its tolerance or the iteration cap is reached (a graph
is one stream; a fleet's flat view holds many).  A scanner backend
supplies only the per-vertex best-move scan and a thin topology surface.
JAX's ``lax.while_loop`` becomes a host loop that reads one scalar (the
sweep's dQ) from the device per sweep.  The streaming seed-frontier policy
(``affected_frontier``) and Leiden refinement's constrained scanner
(``ConstrainedScanner``, with ``sanitize_outer`` and
``mask_cross_outer_slots``) live here too, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.graph import segment_sum

#: Knuth's multiplicative constant 2654435761 reinterpreted as int32.
GATE_MUL = -1640531535
#: Odd per-round Weyl increment (low bits of 2654435769).
GATE_INC = 40503


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (defined behaviour,
    where int32 tensor overflow in C++ would not be)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def gate_hash(ids: torch.Tensor, round_ix) -> torch.Tensor:
    """Cheap per-(vertex, round) hash — Weyl sequence on odd constants,
    in int32 arithmetic that wraps (computed mod 2^32 in int64)."""
    r = int(round_ix)
    return _wrap_int32(ids.to(torch.int64) * GATE_MUL + r * GATE_INC)


def round_gate(ids: torch.Tensor, round_ix, gate_fraction: int) -> torch.Tensor:
    """Boolean mask selecting ~1/gate_fraction of ``ids`` this round."""
    h = gate_hash(ids, round_ix)
    return torch.abs(h >> 13) % gate_fraction == 0


@dataclasses.dataclass
class MoveState:
    """Loop state of one local-moving phase of the scanner's S streams (a
    graph is one; a fleet's ``FleetView`` holds S).  ``comm``/``sigma``
    are the (sent + 1,) community state; ``iters`` is an (S,) host int
    array; ``dq``/``dq_sum`` are (S,) float32 device tensors; ``live``
    masks the vertices of the streams still sweeping.  ``MoveEngine.run``
    hands one stream's back as a host int and 0-d tensors.  ``sizes`` is
    the (sent + 1,) community-size array a scanner with ``exchange_round``
    maintains across rounds (None otherwise); ``comm_fb`` counts, per
    stream, the rounds its exchange fell back to the dense path (an (S,)
    host int array; ``MoveEngine.run`` hands one stream's back as an
    int)."""

    comm: torch.Tensor
    sigma: torch.Tensor
    frontier: torch.Tensor
    iters: np.ndarray
    dq: torch.Tensor
    dq_sum: torch.Tensor
    live: torch.Tensor
    sizes: Optional[torch.Tensor] = None
    comm_fb: Union[np.ndarray, int] = 0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs of the round loop."""

    max_iterations: int = 20
    use_pruning: bool = True
    gate_fraction: int = 2


def gated_move_mask(best_c: torch.Tensor, best_dq: torch.Tensor,
                    comm_l: torch.Tensor, sizes: torch.Tensor,
                    frontier: torch.Tensor, sent: int,
                    move_valid: Optional[torch.Tensor] = None,
                    gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The engine's move decision from a scan result: the improvement test,
    the singleton-swap guard (two singletons merge only towards the smaller
    id), the frontier/validity masks and the round gate.  The fused kernel
    (K1) must reproduce exactly this boolean."""
    own_single = sizes[comm_l] == 1
    tgt_single = sizes[torch.clamp(best_c, max=sent)] == 1
    swap_blocked = own_single & tgt_single & (best_c > comm_l)
    do_move = ((best_dq > 0.0) & (best_c != comm_l) & (best_c < sent)
               & frontier & ~swap_blocked)
    if move_valid is not None:
        do_move = do_move & move_valid
    if gate is not None:
        do_move = do_move & gate
    return do_move


class MoveEngine:
    """The one BSP round loop.  ``scanner`` supplies:

    attributes ``sentinel``, ``local_ids``, ``n_streams``, ``gate_ids``
    (the stream-local ids the round gate hashes), ``stream_of`` (each
    vertex slot's stream; ``n_streams`` for the sentinel), ``k_local``,
    ``move_valid``, ``frontier_valid``; methods ``scan(comm, sigma,
    frontier)``,
    ``comm_local``, ``count_ones``, ``psum``, ``combine_sigma``,
    ``gather_comm``, ``gather_mask``, ``mark_neighbors``; and optionally
    ``decide_moves(comm, sigma, frontier, comm_l, sizes, round_ix)`` ->
    (do_move, best_c, best_dq), which must equal ``scan`` +
    ``gated_move_mask`` bit for bit (the fused ELL kernel supplies it).

    Two more optional hooks, of the sharded scanners
    (``core/distributed.py``): ``community_sizes(comm, comm_l)`` -> the
    (sent + 1,) int32 sizes in place of the engine's reduction; and
    ``exchange_round(comm, sigma, sizes, comm_l, do_move, best_c,
    dq_local)`` -> (comm', sigma', sizes', moved (sent + 1,) bool,
    fallback (n_streams,) host 0/1 ints, dq), which replaces the Sigma /
    membership / moved-mask / dQ exchange with the backend's own.  A
    scanner with ``exchange_round`` keeps the sizes across rounds (seeded
    once per phase by ``community_sizes``) instead of reducing them every
    round.
    """

    def __init__(self, scanner, config: EngineConfig):
        self.scanner = scanner
        self.config = config

    def one_round(self, st: MoveState, frontier0: torch.Tensor,
                  round_ix: int) -> MoveState:
        sc, cfg = self.scanner, self.config
        sent = sc.sentinel
        frontier = st.frontier if cfg.use_pruning else frontier0
        comm_l = sc.comm_local(st.comm)

        gate = (round_gate(sc.gate_ids, round_ix, cfg.gate_fraction)
                if cfg.gate_fraction > 1 else None)
        exchange = getattr(sc, "exchange_round", None)
        sizes_fn = getattr(sc, "community_sizes", None)
        if exchange is not None:
            sizes = st.sizes          # kept by the backend's exchange
        elif sizes_fn is not None:
            sizes = sizes_fn(st.comm, comm_l)
        else:
            sizes = sc.psum(segment_sum(sc.count_ones(comm_l), comm_l,
                                        sent + 1))

        decide = getattr(sc, "decide_moves", None)
        if decide is not None:
            do_move, best_c, best_dq = decide(st.comm, st.sigma, frontier,
                                              comm_l, sizes, round_ix)
        else:
            best_c, best_dq = sc.scan(st.comm, st.sigma, frontier)
            do_move = gated_move_mask(best_c, best_dq, comm_l, sizes,
                                      frontier, sent, sc.move_valid, gate)
        do_move = do_move & st.live

        # Each stream's dQ over its block of vertex slots, accumulated in
        # float64 and rounded once: the same sum whatever the block's
        # padding or the number of streams beside it.
        moved_dq = torch.where(do_move, best_dq, 0.0)[:sent]
        dq_local = torch.sum(moved_dq.view(sc.n_streams, -1), 1,
                             dtype=torch.float64).to(torch.float32)
        if exchange is not None:
            comm, sigma, sizes_new, moved_g, fb, dq = exchange(
                st.comm, st.sigma, sizes, comm_l, do_move, best_c, dq_local)
        else:
            dq = sc.psum(dq_local)
            moved_k = torch.where(do_move, sc.k_local, 0.0)
            add = segment_sum(moved_k, torch.where(do_move, best_c, sent),
                              sent + 1)
            sub = segment_sum(moved_k, torch.where(do_move, comm_l, sent),
                              sent + 1)
            sigma = sc.combine_sigma(st.sigma, add, sub)
            comm = sc.gather_comm(torch.where(do_move, best_c, comm_l))
            moved_g = sc.gather_mask(do_move)
            sizes_new, fb = st.sizes, 0

        # Vertex pruning: processed vertices leave the frontier; neighbors
        # of movers re-enter it.  Gated-out frontier vertices were never
        # processed this round — keep them hot.
        frontier_new = sc.mark_neighbors(moved_g) & sc.frontier_valid
        if gate is not None:
            frontier_new = frontier_new | (frontier & ~gate)
        return MoveState(comm, sigma, frontier_new, st.iters, st.dq + dq,
                         st.dq_sum + dq, st.live, sizes_new, st.comm_fb + fb)

    def run(self, comm0: torch.Tensor, sigma0: torch.Tensor,
            frontier0: torch.Tensor, tolerance) -> MoveState:
        """Algorithm 2: each stream sweeps until its own dQ <= its own
        tolerance or the cap.  ``tolerance`` is one float (the scanner's
        one stream: the state comes back with a host int ``iters`` and
        0-d ``dq``/``dq_sum``) or one per stream.

        Sweeps run in lockstep; a stream that stopped stays frozen (its
        vertices leave ``live``), so a stream whose tolerance is +inf runs
        no sweep, and running streams have swept equally often, so the
        round index is each one's own.  The comparison is the reference's
        float32 one: the sweep's float32 dQ against the float32-rounded
        tolerance.  One host read per sweep.
        """
        cfg, sc = self.config, self.scanner
        tol = np.atleast_1d(np.asarray(tolerance, np.float32))
        if tol.shape != (sc.n_streams,):
            raise ValueError(f"{tol.shape[0]} tolerances for "
                             f"{sc.n_streams} streams")
        dev = comm0.device
        zero = torch.zeros(sc.n_streams, dtype=torch.float32, device=dev)
        st = MoveState(comm0, sigma0, frontier0,
                       np.zeros(sc.n_streams, np.int64), zero, zero, None,
                       comm_fb=np.zeros(sc.n_streams, np.int64))
        if getattr(sc, "exchange_round", None) is not None:
            st.sizes = sc.community_sizes(comm0, sc.comm_local(comm0))
        dq = np.full(sc.n_streams, np.inf, np.float32)  # >= 1 sweep each
        sweeps = 0
        while True:
            running = (st.iters < cfg.max_iterations) & (dq > tol)
            if not running.any():
                break
            run_t = torch.from_numpy(np.append(running, False)).to(dev)
            st.live = run_t[sc.stream_of]
            st.dq = zero
            for r in range(cfg.gate_fraction):
                st = self.one_round(st, frontier0,
                                    sweeps * cfg.gate_fraction + r)
            st.iters = st.iters + running
            sweeps += 1
            dq = np.where(running, st.dq.cpu().numpy(), dq)
        if np.ndim(tolerance) == 0:
            return dataclasses.replace(st, iters=int(st.iters[0]),
                                       dq=st.dq[0], dq_sum=st.dq_sum[0],
                                       comm_fb=int(st.comm_fb[0]))
        return st


# ---------------------------------------------------------------------------
# Leiden refinement: the constrained sweep.
# ---------------------------------------------------------------------------

def _is_live_mask(n_valid) -> bool:
    return isinstance(n_valid, torch.Tensor) and n_valid.dtype == torch.bool


def valid_ids(ids: torch.Tensor, n_valid, sentinel: int) -> torch.Tensor:
    """Which of ``ids`` are live vertices: ``ids < n_valid`` for a live
    count (an int, or a fleet's per-vertex thresholds), or ``n_valid``
    itself when it is a bool live mask over ``ids`` (the reference's mask
    form, for the gappy layouts that skew-aware re-sharding makes); the
    sentinel slot is never live."""
    if _is_live_mask(n_valid):
        return n_valid & (ids < sentinel)
    return ids < n_valid


def sanitize_outer(outer: torch.Tensor, n_valid, sentinel: int
                   ) -> torch.Tensor:
    """An outer-community membership made safe for a constrained sweep.

    Invalid vertex slots pin to the sentinel; a stale label (not a live id,
    e.g. an earlier capacity's sentinel) on a valid slot falls back to the
    vertex's own singleton, never to another community's id.  ``n_valid``
    is the live count (over a fleet, a ``FleetView``'s per-vertex
    thresholds, which compare the same way) or, for a re-sharded sharded
    layout, a (sentinel + 1,) bool live mask: labels are representative
    vertex ids, so a label is live where the mask is.
    """
    ids = torch.arange(outer.shape[0], dtype=torch.int32,
                       device=outer.device)
    lab = outer.to(torch.int32)
    valid_slot = valid_ids(ids, n_valid, sentinel)
    if _is_live_mask(n_valid):
        safe = torch.clamp(lab, 0, sentinel).to(torch.int64)
        in_range = (lab >= 0) & (lab < sentinel) & n_valid[safe]
    else:
        in_range = (lab >= 0) & (lab < n_valid)
    out = torch.where(valid_slot & in_range, lab, ids)
    return torch.where(valid_slot, out, sentinel)


def assert_outer_sane(outer: torch.Tensor, n_valid, sentinel: int) -> None:
    """Raise ``ValueError`` if a stale outer id would reach a constrained
    sweep: a valid slot whose label is not a live id, or an invalid slot
    not at the sentinel (``n_valid`` in either of ``sanitize_outer``'s
    forms).  One host read.  The single-device and multi-stream refine
    phases sanitize on the device instead, as the reference's jitted
    sweeps do (its check is a no-op under ``jit``); the sharded driver,
    which hands outer labels across ranks, calls it."""
    ids = torch.arange(outer.shape[0], device=outer.device)
    valid = valid_ids(ids, n_valid, sentinel)
    if _is_live_mask(n_valid):
        safe = torch.clamp(outer, 0, sentinel).to(torch.int64)
        lab_ok = (outer >= 0) & (outer < sentinel) & valid[safe]
        what = f"live mask, sentinel={sentinel}"
    else:
        lab_ok = (outer >= 0) & (outer < n_valid)
        what = f"n_valid={n_valid}, sentinel={sentinel}"
    bad = (valid & ~lab_ok) | (~valid & (outer != sentinel))
    where = torch.nonzero(bad).flatten()[:8]
    if where.numel():
        raise ValueError(
            f"stale outer-community ids in refinement seed: slots "
            f"{where.tolist()} hold {outer[where].tolist()} ({what})")


def mask_cross_outer_slots(src: torch.Tensor, dst: torch.Tensor,
                           w: torch.Tensor, outer: torch.Tensor,
                           sentinel: int):
    """(dst', w'): directed slots whose endpoints lie in different outer
    communities take ``dst = sentinel`` and ``w = 0``.  The sentinel
    destination removes the candidate from every scanner's validity check;
    a zero weight alone would not (dQ can be positive with K_{i->c} = 0
    through the degree term of Eq. 2).  Padding slots pass unchanged."""
    src_o = outer[torch.clamp(src, max=sentinel)]
    dst_o = outer[torch.clamp(dst, max=sentinel)]
    cross = src_o != dst_o
    return (torch.where(cross, sentinel, dst).to(dst.dtype),
            torch.where(cross, 0.0, w).to(w.dtype))


class ConstrainedScanner:
    """Leiden refinement over any scanner built on the cross-outer-masked
    topology (``mask_cross_outer_slots``).  It delegates the whole scanner
    protocol to ``inner`` and adds two rules to the move decision: the
    target shares the mover's outer label, and only a vertex that is still
    a singleton moves, so each refined community lies inside one outer
    community and grows from singletons along edges.  (A round's moves are
    simultaneous: two singletons that join a third one's community while
    it moves away need not be adjacent, so a refined community can still
    be disconnected, as in the reference.)  ``outer`` comes sanitized
    (``sanitize_outer``, as ``local_move.cross_outer_masked`` returns it):
    nothing is checked or read back to the host here."""

    def __init__(self, inner, outer: torch.Tensor, gate_fraction: int = 2):
        self.inner = inner
        self.gate_fraction = int(gate_fraction)
        self.outer = outer
        self._outer_l = outer[torch.clamp(inner.local_ids,
                                          max=inner.sentinel)]

    def __getattr__(self, name):
        # Reached only for names this class lacks: the scanner protocol
        # (sentinel, local_ids, scan, mark_neighbors, ...) is the inner's.
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def decide_moves(self, comm, sigma, frontier, comm_l, sizes, round_ix):
        """The inner decision (the fused kernel's, or ``scan`` +
        ``gated_move_mask``) AND intra-outer target AND still-singleton
        mover."""
        sent = self.sentinel
        inner_decide = getattr(self.inner, "decide_moves", None)
        if inner_decide is not None:
            do_move, best_c, best_dq = inner_decide(
                comm, sigma, frontier, comm_l, sizes, round_ix)
        else:
            best_c, best_dq = self.inner.scan(comm, sigma, frontier)
            gate = (round_gate(self.gate_ids, round_ix, self.gate_fraction)
                    if self.gate_fraction > 1 else None)
            do_move = gated_move_mask(best_c, best_dq, comm_l, sizes,
                                      frontier, sent, self.move_valid, gate)
        intra_outer = (self.outer[torch.clamp(best_c, max=sent)]
                       == self._outer_l)
        still_singleton = sizes[torch.clamp(comm_l, max=sent)] == 1
        return do_move & intra_outer & still_singleton, best_c, best_dq


class ReplicatedScannerBase:
    """Topology surface shared by the single-device backends (sort-reduce
    and ELL): local layout == replicated layout, all collectives identity."""

    def __init__(self, sentinel: int, n_valid, k: torch.Tensor,
                 n_streams: int = 1):
        """The vertex slots below ``sentinel`` are ``n_streams`` equal
        blocks, one per stream (a fleet's ``core.graph.FleetView``; a graph
        is one block).  ``n_valid`` is an int, or a (sentinel + 1,) tensor
        of per-vertex thresholds."""
        self.sentinel = sentinel
        self.n_streams = n_streams
        self.local_ids = torch.arange(sentinel + 1, dtype=torch.int32,
                                      device=k.device)
        block = max(sentinel // n_streams, 1)
        self.gate_ids = torch.remainder(self.local_ids, block)
        self.stream_of = torch.clamp(self.local_ids // block, max=n_streams)
        self.k_local = k
        valid = self.local_ids < n_valid
        self.move_valid: Optional[torch.Tensor] = valid
        self.frontier_valid = valid
        self._valid = valid
        self._ones = valid.to(torch.int32)

    def comm_local(self, comm: torch.Tensor) -> torch.Tensor:
        return comm

    def count_ones(self, comm_l: torch.Tensor) -> torch.Tensor:
        return self._ones

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def combine_sigma(self, sigma, add, sub):
        return sigma + add - sub

    def gather_comm(self, comm_l: torch.Tensor) -> torch.Tensor:
        return comm_l

    def gather_mask(self, mask_l: torch.Tensor) -> torch.Tensor:
        return mask_l

    def scan(self, comm, sigma, frontier) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def mark_neighbors(self, moved: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Delta screening — the streaming seed-frontier policy.
# ---------------------------------------------------------------------------

#: ``screening="auto"`` uses per-vertex flags while the touched set stays at
#: or below n_valid / AUTO_SCREEN_TOUCHED_DENOM, and the community-granular
#: set for bulkier batches.
AUTO_SCREEN_TOUCHED_DENOM = 16


def affected_frontier(touched: torch.Tensor, membership: torch.Tensor,
                      n_valid: int, mode: str = "community") -> torch.Tensor:
    """(cap + 1,) bool seed frontier from a touched-vertex mask.

    ``membership`` is (cap + 1,) community ids with the sentinel slot = cap.
    ``"community"``: touched endpoints plus ALL members of their current
    communities; ``"vertex"``: only the touched endpoints; ``"auto"``:
    vertex granularity when |touched| <= n_valid /
    ``AUTO_SCREEN_TOUCHED_DENOM``, community above — a device-side select,
    so a stream loop does not wait on the device for it.
    """
    cap = membership.shape[0] - 1
    valid = torch.arange(cap + 1, device=membership.device) < n_valid
    fv = touched & valid
    if mode == "vertex":
        return fv
    if mode not in ("community", "auto"):
        raise ValueError(f"unknown screening mode: {mode!r}")
    comm = torch.where(valid, torch.clamp(membership, max=cap), cap)
    # Mark affected communities, then pull every member of a marked one.
    mark = torch.zeros(cap + 1, dtype=torch.bool, device=membership.device)
    mark[torch.where(fv, comm, cap).to(torch.int64)] = True
    mark[cap] = False
    fc = (touched | mark[comm.to(torch.int64)]) & valid
    if mode == "community":
        return fc
    small = fv.sum() * AUTO_SCREEN_TOUCHED_DENOM <= n_valid
    return torch.where(small, fv, fc)


def resolve_screening_host(mode: Optional[str],
                           touched_frac: Optional[float]
                           ) -> Tuple[Optional[str], bool]:
    """Host-side ``"auto"`` screening of the batched drivers: the mode of a
    fleet step from the previous step's worst touched fraction (|touched| /
    n_valid, max over the streams).  Returns ``(mode, downgraded)``:
    modes other than ``"auto"`` pass unchanged; ``"auto"`` picks
    ``"vertex"`` at or below 1 / ``AUTO_SCREEN_TOUCHED_DENOM``, else
    ``"community"``, and with no measurement yet (the first step) the safe
    ``"community"``, flagged as a downgrade."""
    if mode != "auto":
        return mode, False
    if touched_frac is None:
        return "community", True
    if touched_frac * AUTO_SCREEN_TOUCHED_DENOM <= 1.0:
        return "vertex", False
    return "community", False


def normalize_screening(screening) -> Optional[str]:
    """Map a ``screening`` argument to a frontier mode:
    ``True`` -> ``"community"``, ``False``/``None`` -> ``None`` (warm start
    over all vertices), ``"community"``/``"vertex"``/``"auto"`` unchanged."""
    if screening is True:
        return "community"
    if screening in (False, None):
        return None
    if screening in ("community", "vertex", "auto"):
        return screening
    raise ValueError(f"screening must be bool, 'community', 'vertex' or "
                     f"'auto'; got {screening!r}")
