"""Backend and capacity policy of the PyTorch port — the policy half of
``repro.configs.louvain_arch``, kept here so that the port never imports
the JAX package."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

#: Accepted values of ``LouvainConfig.scan_backend``.
SCAN_BACKENDS = ("auto", "full", "compact", "ell", "ell_fused")

#: ``"auto"`` picks the frontier-compacted scanner when the seed frontier
#: covers at most this fraction of the vertices.
AUTO_COMPACT_MAX_FRONTIER_FRAC = 0.10

#: Compact work-buffer capacity as a fraction of ``e_cap``.  Frontier edge
#: slots beyond the cap make the round fall back to the full scan, so this
#: bounds compact-scan memory, not correctness.
COMPACT_WORK_FRAC = 0.25

#: Work-buffer floor — tiny graphs keep a sortable minimum.
COMPACT_WORK_MIN = 64


def compact_work_cap(e_cap: int, frac: float = COMPACT_WORK_FRAC) -> int:
    """Work-buffer capacity of the compacted scanner on ``e_cap``."""
    return max(1, min(int(e_cap), max(COMPACT_WORK_MIN, int(e_cap * frac))))


#: Accepted values of ``LouvainConfig.agg_backend`` and of the batch-apply
#: ``backend``.  ``"kernel"`` is the hand-written kernel (K3 and K4; the
#: reference calls it ``"pallas"``), ``"sort"`` the torch chain (the
#: reference's ``"sort"`` and ``"xla"``).
AGG_BACKENDS = ("auto", "sort", "kernel")


def _resolve_kernel_backend(backend: str, device, knob: str) -> str:
    if backend not in AGG_BACKENDS:
        raise ValueError(f"{knob} must be one of {AGG_BACKENDS}; "
                         f"got {backend!r}")
    if backend == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "sort"
    return backend


def resolve_agg_backend(backend: str, device: torch.device) -> str:
    """Map the ``agg_backend`` knob to a concrete aggregation backend.

    ``"sort"`` is the torch sort -> segment-sum -> scatter chain;
    ``"kernel"`` resolves the sorted groups in the CUDA kernel K3 (its plain
    version on a CPU tensor).  ``"auto"`` picks the kernel on a CUDA device
    and the sort chain on the CPU.
    """
    return _resolve_kernel_backend(backend, device, "agg_backend")


def resolve_apply_backend(backend: str, device: torch.device) -> str:
    """Map the batch-apply ``backend`` knob the same way: ``"kernel"`` is the
    CUDA kernel K4 (its plain version on a CPU tensor), ``"sort"`` the
    torch segment-reduction chain, ``"auto"`` the kernel on a CUDA device
    and the sort chain on the CPU — by the tensors' device, never by
    whether the kernel builds."""
    return _resolve_kernel_backend(backend, device, "apply backend")


#: K1 adds each K_{i->c} in float32 in slot order; the sort-reduce scan
#: adds it in float64 and rounds once.  The two agree bit for bit while
#: every partial sum is an integer below this, which holds when the weights
#: are non-negative integers and every vertex weight k_i lies below it (a
#: partial sum is at most k_i; a float32 k_i below 2^24 is exact).
FLOAT32_EXACT_SUM = 2 ** 24


def sums_exact_in_float32(weights: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether every K_{i->c} partial sum is exact in float32: the slot
    weights are non-negative integers and every vertex weight ``k`` lies
    below ``FLOAT32_EXACT_SUM``.  One host read."""
    inexact = torch.stack([
        torch.any((weights != torch.round(weights)) | (weights < 0)),
        torch.any(k >= FLOAT32_EXACT_SUM)])
    return not bool(inexact.any())


def resolve_scan_backend(backend: str, *, use_ell_kernel: bool = False,
                         frontier_frac: float | None = None,
                         device=None, weights: torch.Tensor | None = None,
                         k: torch.Tensor | None = None) -> str:
    """Map the ``scan_backend`` knob to a concrete scanner for ONE pass:
    one of ``"full" | "compact" | "ell" | "ell_fused"``, by the reference's
    rules (``"auto"`` + ELL family -> the fused kernel; ``"auto"`` + a small
    active frontier -> ``"compact"``; otherwise the full sort-reduce), and
    one of the port's own: ``"auto"`` with no small frontier takes the
    fused kernel K1 on a CUDA ``device`` when the pass's slot ``weights``
    and vertex weights ``k`` keep its float32 sums exact
    (``sums_exact_in_float32``), so its memberships equal the sort-reduce
    scan's.  On the CPU, or without ``weights``, ``"auto"`` keeps the
    reference's rules."""
    if backend not in SCAN_BACKENDS:
        raise ValueError(f"scan_backend must be one of {SCAN_BACKENDS}; "
                         f"got {backend!r}")
    if use_ell_kernel or backend in ("ell", "ell_fused"):
        if backend == "compact":
            raise ValueError(
                "scan_backend='compact' contradicts use_ell_kernel=True — "
                "the compacted scanner is a sort-reduce backend")
        if backend in ("auto", "ell_fused"):
            return "ell_fused"
        return "ell"
    if backend == "compact":
        return "compact" if frontier_frac is not None else "full"
    if backend == "auto":
        if (frontier_frac is not None
                and frontier_frac <= AUTO_COMPACT_MAX_FRONTIER_FRAC):
            return "compact"
        if (device is not None and torch.device(device).type == "cuda"
                and weights is not None
                and sums_exact_in_float32(weights, k)):
            return "ell_fused"
        return "full"
    return "full"


# ---------------------------------------------------------------------------
# Coarse-pass capacity ladder (the ``LouvainConfig.use_ladder`` knob).
# ---------------------------------------------------------------------------

#: Vertex-capacity floor of the ladder.
LADDER_MIN_N_CAP = 64

#: Edge-capacity floor of the ladder.
LADDER_MIN_E_CAP = 256

#: Headroom multiplier applied to the live counts before tier rounding.
LADDER_SLACK = 1.25

#: A pass re-buckets only when the candidate tier is at least this factor
#: below the current capacity.
LADDER_HYSTERESIS = 2


def _pow2_at_least(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


def resolve_coarse_capacity(n_comms: int, e_valid: int,
                            n_cap: int, e_cap: int) -> Tuple[int, int]:
    """Ladder tier ``(n_cap_new, e_cap_new)`` for the next pass of a coarse
    graph; ``(n_cap, e_cap)`` back means "don't re-bucket"."""
    n_tier = max(_pow2_at_least(int(n_comms * LADDER_SLACK)), LADDER_MIN_N_CAP)
    e_tier = max(_pow2_at_least(int(e_valid * LADDER_SLACK)), LADDER_MIN_E_CAP)
    n_new = n_tier if n_tier * LADDER_HYSTERESIS <= n_cap else n_cap
    e_new = e_tier if e_tier * LADDER_HYSTERESIS <= e_cap else e_cap
    return n_new, e_new


# ---------------------------------------------------------------------------
# Sharded paths: communication backend, state layout, re-sharding.
# ---------------------------------------------------------------------------

#: Accepted values of the sharded driver's ``comm_backend``: ``"gather"``
#: exchanges the owned membership slice, the moved mask and the dense
#: Sigma and community-size arrays every round; ``"delta"`` ships only the
#: movers as bit-packed (index, label) lanes and rebuilds Sigma and sizes
#: from the replicated vertex weights and membership, with a dense
#: fallback when a round's movers exceed the cap.
COMM_BACKENDS = ("auto", "gather", "delta")

#: Mover-buffer capacity as a fraction of ``v_per_shard``.
DELTA_MOVE_CAP_FRAC = 4

#: Mover-buffer floor — tiny shards keep a usable buffer.
DELTA_MOVE_CAP_MIN = 8


def delta_move_cap(v_per: int) -> int:
    """Mover-buffer capacity for a shard owning ``v_per`` vertices: a round
    overflows exactly when its movers do."""
    return max(1, min(int(v_per),
                      max(int(v_per) // DELTA_MOVE_CAP_FRAC,
                          DELTA_MOVE_CAP_MIN)))


def resolve_comm_backend(backend: str, n_shards: int) -> str:
    """``"auto"`` is ``"delta"`` on more than one shard and ``"gather"`` on
    one; explicit values pass through."""
    if backend not in COMM_BACKENDS:
        raise ValueError(f"comm_backend must be one of {COMM_BACKENDS}; "
                         f"got {backend!r}")
    if backend == "auto":
        return "delta" if n_shards > 1 else "gather"
    return backend


#: Accepted values of ``state_layout``: every shard holds the full
#: membership, Sigma, sizes and K (``"replicated"``), or per-vertex state
#: stays with its owner and only boundary labels and touched-community
#: deltas travel (``"hybrid"``).
STATE_LAYOUTS = ("auto", "replicated", "hybrid")

#: ``"auto"`` engages the hybrid layout only when the measured boundary
#: fraction is at most this.
HYBRID_BOUNDARY_FRAC_MAX = 0.5

#: Touched-community lane capacity as a multiple of the mover cap (a mover
#: touches at most two communities).
HYBRID_TOUCHED_CAP_FRAC = 2


def hybrid_touched_cap(v_per: int) -> int:
    """Touched-community lane capacity of a hybrid delta round."""
    return HYBRID_TOUCHED_CAP_FRAC * delta_move_cap(v_per)


def resolve_state_layout(layout: str, n_shards: int,
                         boundary_frac: float | None = None) -> str:
    """``"auto"`` is ``"hybrid"`` on more than one shard whose measured
    boundary fraction is at most ``HYBRID_BOUNDARY_FRAC_MAX``, else
    ``"replicated"`` (also without a measurement); explicit values pass
    through."""
    if layout not in STATE_LAYOUTS:
        raise ValueError(f"state_layout must be one of {STATE_LAYOUTS}; "
                         f"got {layout!r}")
    if layout == "auto":
        if (n_shards > 1 and boundary_frac is not None
                and boundary_frac <= HYBRID_BOUNDARY_FRAC_MAX):
            return "hybrid"
        return "replicated"
    return layout


# ---------------------------------------------------------------------------
# Skew-aware coarse re-sharding (the ``reshard`` knob).
#
# After an aggregation the coarse ids form a dense prefix, so the uniform
# owner ranges can park most coarse edges on one rank.  ``plan_reshard``
# measures that skew on the host and, above ``RESHARD_IMBALANCE_THRESHOLD``,
# splits the ids into contiguous ranges of about equal edge load.  Range s
# is relabelled onto the uniform block ``[s * v_per, s * v_per + width_s)``,
# so ``owner = id // v_per`` stays the layout law; the ids between
# ``width_s`` and ``v_per`` are gaps, which is why the pass loop carries a
# live-vertex mask after a re-shard.
# ---------------------------------------------------------------------------

#: Accepted values of ``reshard``.
RESHARD_MODES = ("none", "auto")

#: A coarse pass re-shards only when the worst rank's edge load exceeds this
#: multiple of the mean under the uniform layout.
RESHARD_IMBALANCE_THRESHOLD = 1.5

#: Per-rank block-width cap as a multiple of the fair share
#: ceil(n_live / n_shards).
RESHARD_WIDTH_SLACK = 4


def resolve_reshard(mode: str) -> str:
    """Validate the ``reshard`` knob (``"none"`` | ``"auto"``)."""
    if mode not in RESHARD_MODES:
        raise ValueError(f"reshard must be one of {RESHARD_MODES}; "
                         f"got {mode!r}")
    return mode


class ReshardPlan(NamedTuple):
    """A balanced contiguous owner split of a coarse graph: rank s owns the
    dense ids ``[bounds[s], bounds[s + 1])``, relabelled onto ``[s *
    v_per_shard, ...)``; ``e_per_shard`` is the power-of-two edge tier of
    the worst rank's load (with ``LADDER_SLACK``); ``load_frac_*`` are the
    worst rank's share of all edge slots before and after."""

    bounds: np.ndarray
    v_per_shard: int
    e_per_shard: int
    load_frac_before: float
    load_frac_after: float


def owner_load_frac(counts: np.ndarray, v_per: int, n_shards: int) -> float:
    """The worst rank's share of all edge slots under uniform ranges
    (``owner = id // v_per``, clamped to the last rank) of the per-vertex
    slot ``counts``; a total of zero gives ``1 / n_shards``."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    n_shards = max(int(n_shards), 1)
    if total <= 0 or counts.shape[0] == 0:
        return 1.0 / n_shards
    owner = np.minimum(np.arange(counts.shape[0]) // max(int(v_per), 1),
                       n_shards - 1)
    loads = np.bincount(owner, weights=counts, minlength=n_shards)
    return float(loads.max() / total)


def plan_reshard(counts: np.ndarray, n_shards: int, v_per_uniform: int, *,
                 threshold: float | None = None,
                 width_slack: int | None = None) -> Optional[ReshardPlan]:
    """A skew-aware owner split of the dense coarse ids whose per-vertex
    edge slots are ``counts``, or ``None`` on one rank, when the imbalance
    (max / mean under ``v_per_uniform``-wide ranges) is at most
    ``threshold``, or when the split cannot beat the uniform worst load.
    A greedy prefix-sum walk puts boundary s where the cumulative load first
    reaches s / n_shards of the total, no block wider than ``width_slack``
    fair shares.  Deterministic numpy."""
    counts = np.asarray(counts, np.int64)
    n_live = int(counts.shape[0])
    total = int(counts.sum())
    n_shards = int(n_shards)
    if n_shards <= 1 or n_live == 0 or total <= 0:
        return None
    thr = RESHARD_IMBALANCE_THRESHOLD if threshold is None else threshold
    slack = RESHARD_WIDTH_SLACK if width_slack is None else width_slack
    frac_before = owner_load_frac(counts, v_per_uniform, n_shards)
    if frac_before * n_shards <= thr:
        return None

    v_cap = _pow2_at_least(-(-n_live // n_shards) * max(int(slack), 1))
    cum = np.cumsum(counts)
    bounds = np.zeros((n_shards + 1,), np.int64)
    bounds[n_shards] = n_live
    for s in range(1, n_shards):
        prev = int(bounds[s - 1])
        b = int(np.searchsorted(cum, total * s / n_shards, side="left")) + 1
        lo = max(prev, n_live - (n_shards - s) * v_cap)
        hi = min(prev + v_cap, n_live)
        bounds[s] = min(max(b, lo), hi)

    widths = np.diff(bounds)
    v_per = max(_pow2_at_least(int(widths.max())),
                _pow2_at_least(-(-LADDER_MIN_N_CAP // n_shards)))
    csum = np.concatenate([np.zeros((1,), np.int64), cum])
    loads = csum[bounds[1:]] - csum[bounds[:-1]]
    frac_after = float(loads.max() / total)
    if frac_after >= frac_before:
        return None
    e_floor = -(-LADDER_MIN_E_CAP // n_shards)
    e_per = _pow2_at_least(max(int(loads.max() * LADDER_SLACK), e_floor))
    return ReshardPlan(bounds, int(v_per), int(e_per), frac_before,
                       frac_after)


# ---------------------------------------------------------------------------
# Multi-tenant fleet admission policy (the ``core/fleet.py`` serving layer).
#
# Every tenant graph is sharded across the ranks (the 1-D vertex partition
# of ``core/distributed.py``) and the tenants of one capacity envelope are
# batched per dispatch, as lanes of one flat layout.  Tenants are admitted
# into power-of-two envelopes ``(v_per_shard, e_per_shard, b_cap)``; those
# sharing an envelope share a bucket, and a whale tenant that outgrows its
# envelope migrates to a bigger bucket instead of regrowing the fleet.
# ---------------------------------------------------------------------------

#: Headroom multiplier on the worst rank's owned edge slots at admission:
#: the sharded streaming driver's 25% slack, so a tenant's first growth
#: event needs genuinely new volume.
FLEET_E_SLACK = 1.25

#: Per-rank vertex-block floor (tiny tenants keep a usable block).
FLEET_MIN_V_PER = 8

#: Per-rank edge-slot floor (keeps the per-rank sort non-trivial).
FLEET_MIN_E_PER = 32

#: A migration at least multiplies the edge capacity by this factor, the
#: geometric growth of the streaming drivers, so a whale cannot thrash the
#: bucket ladder.
FLEET_GROW_FACTOR = 2


class FleetEnvelope(NamedTuple):
    """Power-of-two per-tenant capacity envelope of a fleet bucket.  On
    ``n_shards`` ranks it implies ``v_cap = n_shards * v_per_shard`` vertex
    slots (the padded vertex count, also the sentinel) and ``e_cap =
    n_shards * e_per_shard`` directed edge slots."""

    v_per_shard: int
    e_per_shard: int
    b_cap: int           # per-step edge-batch capacity of every lane

    def v_cap(self, n_shards: int) -> int:
        return self.v_per_shard * n_shards

    def e_cap(self, n_shards: int) -> int:
        return self.e_per_shard * n_shards


def fleet_v_per_shard(n_cap: int, n_shards: int) -> int:
    """Power-of-two per-rank vertex block covering ``n_cap`` vertices."""
    return max(_pow2_at_least(-(-int(n_cap) // max(int(n_shards), 1))),
               FLEET_MIN_V_PER)


def fleet_envelope(n_cap: int, owned_max: int, b_cap: int,
                   n_shards: int) -> FleetEnvelope:
    """Admission envelope of one tenant.  ``owned_max`` is the worst rank's
    owned live directed slots under the ``fleet_v_per_shard`` owner map.
    The edge tier reserves ``FLEET_E_SLACK`` headroom plus room for one
    worst-case batch (``2 * b_cap`` directed slots on one rank) and rounds
    up to a power of two, so tenants of similar size share a bucket."""
    b_cap = max(_pow2_at_least(int(b_cap)), 1)
    e_need = int(int(owned_max) * FLEET_E_SLACK) + 2 * b_cap
    e_per = max(_pow2_at_least(e_need), FLEET_MIN_E_PER)
    return FleetEnvelope(fleet_v_per_shard(n_cap, n_shards), e_per, b_cap)


def plan_fleet(sizings, n_shards: int) -> Dict[FleetEnvelope, list]:
    """Group tenants into capacity buckets: ``sizings`` holds one ``(n_cap,
    owned_max, b_cap)`` per tenant in admission order; returns
    ``{envelope: [tenant index, ...]}`` in first-seen order."""
    buckets: Dict[FleetEnvelope, list] = {}
    for i, (n_cap, owned_max, b_cap) in enumerate(sizings):
        env = fleet_envelope(n_cap, owned_max, b_cap, n_shards)
        buckets.setdefault(env, []).append(i)
    return buckets


def migrate_envelope(env: FleetEnvelope, e_need: int) -> FleetEnvelope:
    """The envelope a whale tenant migrates into after an edge overflow
    needing ``e_need`` slots on its worst rank: geometric growth
    (``FLEET_GROW_FACTOR``), rounded to a power of two."""
    e_per = _pow2_at_least(max(FLEET_GROW_FACTOR * env.e_per_shard,
                               int(e_need)))
    return env._replace(e_per_shard=e_per)


# ---------------------------------------------------------------------------
# The paper's distributed phases as dry-run cells (``--arch louvain`` of
# ``launch/dryrun.py``), mirroring Table 1's largest graphs; |E| counts
# directed slots.  Each phase is a runnable algorithm over the ranks of a
# ``ShardGroup``, and a dry group (``ShardGroup.dry``) traces it on meta
# tensors at full scale.
#
# Variants:
#   "delta_c"  one local-move round whose state exchange ships the movers
#              only (``move_round_delta``), in place of the gather round's
#              three O(n_pad) collectives (``distributed.round_body``);
#   "a2a"      aggregation routing each partial coarse edge to the rank
#              owning its source community with one capacity-bounded
#              ``all_to_all`` (``aggregate_a2a_body``), in place of the
#              baseline's ``all_gather``, which puts the whole edge list on
#              every rank (45.6 GB at sk-2005 scale).
# ---------------------------------------------------------------------------

#: name -> (|V|, |E| directed slots, phase).
LOUVAIN_SHAPES: Dict[str, Tuple[int, int, str]] = {
    "web_3.8B_move": (50_636_154, 3_800_000_000, "move"),
    "web_3.8B_aggregate": (50_636_154, 3_800_000_000, "aggregate"),
    "road_108M_move": (50_912_018, 108_109_320, "move"),
    "road_108M_aggregate": (50_912_018, 108_109_320, "aggregate"),
}

#: The smoke size of every Louvain shape: (|V|, |E|).
LOUVAIN_SMOKE = (4096, 32768)

#: Mover cap of the ``delta_c`` round as a fraction of ``v_per_shard``, and
#: the ``a2a`` capacity per destination as a multiple of the fair share.
DELTA_C_MOVE_CAP_FRAC = 4
A2A_CAP_FACTOR = 4


def spec_for(group, n: int, e: int):
    """The ``ShardedGraphSpec`` of ``n`` vertices and ``e`` slots over the
    ranks of ``group`` (the reference's ``_spec_for``)."""
    from repro_torch.core.distributed import ShardedGraphSpec
    n_shards = int(group.world_size)
    v_per = -(-n // n_shards)
    e_per = -(-e // n_shards)
    return ShardedGraphSpec(n_shards, v_per, e_per, v_per * n_shards)


def move_round_delta(group, spec, move_cap_frac: int, src_l, dst_l, w_l,
                     comm, sigma, comm_sizes, k, m):
    """One local-move round with a delta-encoded state exchange (the
    reference's ``_move_round_delta``).

    The gather round all-gathers the membership and sums the dense Sigma
    and community sizes over the ranks.  Here each rank gathers only the
    (vertex, new community) pairs of its movers, at most ``v_per //
    move_cap_frac`` of them (``overflow``: the largest excess over that
    cap, over all ranks; movers past the cap are not applied), and every
    rank rebuilds membership, Sigma, sizes and its frontier from the
    replicated K, the replicated sizes ``comm_sizes`` and the gathered
    pairs.  The scan, the move rule (round-0 gate, singleton guard) and
    the neighbour marking are the gather scanner's
    (``distributed.ShardedScanner``); Sigma's sums run in float64 in vertex
    order, as the delta scanner's do.  Returns (comm', sigma', sizes',
    frontier (v_per,), dq, overflow)."""
    from repro_torch.core.comm import compact_movers
    from repro_torch.core.distributed import ShardedScanner
    from repro_torch.core.engine import gated_move_mask, round_gate
    from repro_torch.core.graph import segment_sum

    v_per, sent = spec.v_per_shard, spec.sentinel
    sc = ShardedScanner(group, spec, src_l, dst_l, w_l, k, m)
    frontier_l = torch.ones(v_per, dtype=torch.bool, device=k.device)
    best_c, best_dq = sc.scan(comm, sigma, frontier_l)
    own_l = sc.comm_local(comm)
    do_move = gated_move_mask(best_c, best_dq, own_l, comm_sizes,
                              frontier_l, sent,
                              gate=round_gate(sc.local_ids, 0, 2))
    dq_local = torch.sum(torch.where(do_move, best_dq, 0.0),
                         dtype=torch.float64).to(torch.float32)
    dq = group.psum(dq_local.reshape(1))[0]

    # Delta encoding: the (global vertex, new community) of the first
    # ``cap`` movers, empty slots (sent, sent).
    cap = max(v_per // move_cap_frac, 1)
    idx, lab, n_moved = compact_movers(do_move, best_c, cap, sent)
    gidx = torch.where(idx < v_per, sc.v0 + idx, sent).to(torch.int32)
    overflow = group.pmax((n_moved - cap).reshape(1))[0]
    g = group.all_gather(torch.stack([gidx, lab]), tiled=False)  # (S, 2, cap)
    g_idx, g_val = g[:, 0].reshape(-1), g[:, 1].reshape(-1)

    # Replicated reconstruction from the pairs; empty slots write the
    # sentinel's own entries and add nothing.
    live = g_idx < sent
    at = torch.clamp(g_idx, max=sent).to(torch.int64)
    old_c = comm[at]
    comm_new = comm.clone().scatter_(0, at, torch.where(live, g_val, old_c))
    new_c = torch.where(live, g_val, sent)
    old_c = torch.where(live, old_c, sent)
    k_moved = torch.where(live, k[at], 0.0)
    sigma_new = (sigma + segment_sum(k_moved, new_c, sent + 1)
                 - segment_sum(k_moved, old_c, sent + 1))
    one = live.to(comm_sizes.dtype)
    sizes_new = (comm_sizes + segment_sum(one, new_c, sent + 1)
                 - segment_sum(one, old_c, sent + 1))
    moved = torch.zeros(sent + 1, dtype=torch.bool, device=k.device)
    moved.scatter_(0, at, live)
    frontier_new = sc.mark_neighbors(moved) & sc.frontier_valid
    return comm_new, sigma_new, sizes_new, frontier_new, dq, overflow


def aggregate_a2a_body(group, spec, cap_factor: int, src_l, dst_l, w_l,
                       comm):
    """Owner-routed aggregation (the reference's ``_aggregate_a2a_body``):
    the local partial reduce, each live partial coarse edge routed to the
    rank owning its source community (``ci // v_per``) through one
    ``all_to_all`` of packed (ci, cj, w) records with ``cap_factor * (e_l
    // n_shards)`` slots per destination, and the owner's re-reduce.  Both
    reductions resolve their sorted groups in K3
    (``distributed.reduce_sorted_slots``).  A rank's traffic is 3 x
    n_shards x cap x 4 B, about ``cap_factor x e_l x 12 B``, against the
    gather baseline's ``n_shards x e_l x 12 B``.

    Returns (o_ci, o_cj, o_w) of ``n_shards * cap`` slots (the rank's
    coarse edges, padding (sent, sent, 0)), ``e_valid`` (coarse edges over
    all ranks) and ``dropped`` (live partials the per-destination cap
    refused, over all ranks), both 0-d."""
    from repro_torch.core.distributed import (reduce_sorted_slots,
                                              sorted_relabelled_slots)

    v_per, sent, S = spec.v_per_shard, spec.sentinel, spec.n_shards
    e_l = src_l.shape[0]
    dev = src_l.device
    p_ci, p_cj, p_w, n_live = reduce_sorted_slots(
        *sorted_relabelled_slots(src_l, dst_l, w_l, comm, sent), sent, e_l)

    # Destination sort: each destination's partials in (ci, cj) order,
    # ranked within it; partials past the capacity are dropped.
    cap = cap_factor * (e_l // S)
    dest = torch.where(p_ci < sent, p_ci // v_per, S)
    d_sorted, d_order = torch.sort(dest, stable=True)
    rank = (torch.arange(e_l, device=dev)
            - torch.searchsorted(d_sorted, d_sorted, side="left"))
    keep = (d_sorted < S) & (rank < cap)
    slot = torch.where(keep, d_sorted * cap + rank, S * cap)
    wire = torch.full((3, S * cap + 1), sent, dtype=torch.int32, device=dev)
    wire[2] = 0
    rec = torch.stack([p_ci, p_cj, p_w.view(torch.int32)])[:, d_order]
    wire.scatter_(1, slot.expand(3, -1),
                  torch.where(keep, rec, wire[:, -1:]))
    # One all_to_all: block p of the (S, 3, cap) records goes to rank p.
    recv = group.all_to_all(
        wire[:, :-1].view(3, S, cap).transpose(0, 1).contiguous())
    r_ci = recv[:, 0].reshape(-1)
    r_cj = recv[:, 1].reshape(-1)
    r_w = recv[:, 2].reshape(-1).view(torch.float32)

    # The owner's re-reduce of everything it was sent.
    key = r_ci.to(torch.int64) * (sent + 1) + r_cj.to(torch.int64)
    order = torch.sort(key, stable=True).indices
    o_ci, o_cj, o_w, owned = reduce_sorted_slots(
        r_ci[order], r_cj[order], r_w[order], sent, S * cap)
    e_valid = group.psum(owned.reshape(1))[0]
    dropped = group.psum((n_live - keep.to(torch.int32).sum())
                         .reshape(1))[0]
    return o_ci, o_cj, o_w, e_valid, dropped


def aggregate_gather_body(group, spec, src_l, dst_l, w_l, comm):
    """The gather baseline (the reference's ``_aggregate_gather_body``):
    ``distributed.aggregate_records``, the port's distributed aggregation.
    Returns (o_ci, o_cj, o_w) of ``e_l`` slots, ``e_valid`` and
    ``owned_max`` (the largest count of coarse edges a rank owns: above
    ``e_l`` the excess was dropped), both 0-d."""
    from repro_torch.core.distributed import aggregate_records
    return aggregate_records(group, spec, src_l, dst_l, w_l, comm)


class LouvainStep:
    """``step(batch)`` of one Louvain phase on this rank: ``batch`` holds
    the rank's edge slices ``src``/``dst``/``w`` ((e_per_shard,)) and the
    replicated ``comm``/``sigma``/``k`` ((n_pad + 1,)), ``m`` (0-d) and,
    for ``delta_c``, ``comm_sizes``.  ``arg_specs`` is that batch's
    ``{field: (shape, dtype)}``."""

    def __init__(self, group, spec, phase: str, variant: Tuple[str, ...]):
        self.group, self.spec, self.phase = group, spec, phase
        self.variant = tuple(variant)
        n1, e_l = spec.n_pad + 1, spec.e_per_shard
        self.arg_specs = {"src": ((e_l,), torch.int32),
                          "dst": ((e_l,), torch.int32),
                          "w": ((e_l,), torch.float32),
                          "comm": ((n1,), torch.int32),
                          "sigma": ((n1,), torch.float32),
                          "k": ((n1,), torch.float32),
                          "m": ((), torch.float32)}
        if phase == "move" and "delta_c" in self.variant:
            self.arg_specs["comm_sizes"] = ((n1,), torch.int32)

    def __call__(self, batch: dict):
        from repro_torch.core.distributed import round_body
        g, spec = self.group, self.spec
        edges = (batch["src"], batch["dst"], batch["w"])
        if self.phase == "move":
            if "delta_c" in self.variant:
                return move_round_delta(
                    g, spec, DELTA_C_MOVE_CAP_FRAC, *edges, batch["comm"],
                    batch["sigma"], batch["comm_sizes"], batch["k"],
                    batch["m"])
            frontier = torch.ones(spec.v_per_shard, dtype=torch.bool,
                                  device=batch["k"].device)
            return round_body(g, spec, *edges, batch["comm"],
                              batch["sigma"], batch["k"], frontier, 0, 2,
                              batch["m"])
        if "a2a" in self.variant:
            return aggregate_a2a_body(g, spec, A2A_CAP_FACTOR, *edges,
                                      batch["comm"])
        return aggregate_gather_body(g, spec, *edges, batch["comm"])


class LouvainArch:
    """The arch protocol over the paper's distributed phases (the
    reference's ``LouvainArch``): ``input_specs`` and ``build_step``."""

    arch_id = "louvain"
    family = "louvain"
    shapes: Tuple[str, ...] = tuple(LOUVAIN_SHAPES)

    def __init__(self):
        self.skip_notes: Dict[str, str] = {}

    def sizes(self, shape: str, smoke: bool = False) -> Tuple[int, int, str]:
        n, e, phase = LOUVAIN_SHAPES[shape]
        if smoke:
            n, e = LOUVAIN_SMOKE
        return n, e, phase

    def input_specs(self, shape: str, smoke: bool = False) -> dict:
        """The global, unpadded ``{field: (shape, dtype)}``; the edge
        arrays are padded to the ranks when the step is built."""
        n, e, _ = self.sizes(shape, smoke)
        return {"src": ((e,), torch.int32), "dst": ((e,), torch.int32),
                "w": ((e,), torch.float32), "comm": ((n + 1,), torch.int32),
                "sigma": ((n + 1,), torch.float32),
                "k": ((n + 1,), torch.float32), "m": ((), torch.float32)}

    def build_step(self, shape: str, group, smoke: bool = False,
                   variant: Tuple[str, ...] = ()) -> LouvainStep:
        """The phase of ``shape`` over the ranks of ``group`` (a
        ``ShardGroup``, or a ``RankGrid``, whose axes the vertex partition
        flattens over); variants ``"delta_c"`` (move) and ``"a2a"``
        (aggregate)."""
        if hasattr(group, "everyone"):
            group = group.everyone
        n, e, phase = self.sizes(shape, smoke)
        return LouvainStep(group, spec_for(group, n, e), phase, variant)


ARCH = LouvainArch()


def louvain_rank_runs(group, runs: list) -> list:
    """One rank of a spawned run of the Louvain phases
    (``collectives.launch``), for each dict of ``runs``: ``shape``,
    ``variant``, ``smoke`` (default True) and ``batch``, the step's global
    inputs as numpy: ``src``/``dst``/``w`` of ``n_shards * e_per_shard``
    slots in the step's layout (a move round reads each vertex's slots on
    its owner), and the replicated ``comm``/``sigma``/``k``/``m`` (and
    ``comm_sizes``).  Each result holds the step's outputs as numpy (the
    rank's share of the edge outputs) and the step's host seconds
    (``seconds``, ending in a sync on a card)."""
    import time

    dev = group.device
    out = []
    for run in runs:
        step = ARCH.build_step(run["shape"], group,
                               smoke=run.get("smoke", True),
                               variant=tuple(run.get("variant", ())))
        lo = group.rank * step.spec.e_per_shard
        hi = lo + step.spec.e_per_shard
        batch = {k: torch.from_numpy(np.array(
                     v[lo:hi] if k in ("src", "dst", "w") else v)).to(dev)
                 for k, v in run["batch"].items()}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        res = step(batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out.append({"out": [x.cpu().numpy() for x in res],
                    "seconds": time.perf_counter() - t})
    return out
