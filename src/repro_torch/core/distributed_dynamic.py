"""Sharded streaming Louvain of the PyTorch port
(``repro.core.distributed_dynamic``): warm start and delta screening over
the vertex partition of ``core/distributed.py``.

The graph is partitioned once, with vertex capacity ``graph.n_cap`` and
edge headroom per rank; then every edge batch is

  * **applied in the layout** (``apply_batch_shard``): each rank builds the
    batch's directed slots that it owns (slot (u, v) lives on owner(u)) and
    resolves them against its own slots with the single-device apply's
    sort-reduce (``core/delta.sort_reduce_apply_slots``, the kernel K4 on
    the card);
  * **screened**: the touched endpoints are owned where they changed, so
    the replicated touched mask is one ``all_gather`` of the owned slices,
    and the seed frontier is ``engine.affected_frontier`` of it;
  * **re-optimised** from the previous replicated membership by the sharded
    pass loop (``distributed.sharded_louvain_passes``), which never changes
    the resident slots.

A batch that would overflow ``e_per_shard`` grows the capacity (every rank
pads its slice to the doubled width: the live slots already form a sorted
prefix, which is what the reference's host re-bucket gives) and is applied
again.  Every host branch reads a replicated value.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.louvain_arch import (resolve_comm_backend,
                                              resolve_reshard,
                                              resolve_state_layout)
from repro_torch.core.collectives import ShardGroup
from repro_torch.core.delta import (EdgeBatch, sort_reduce_apply_slots,
                                    sort_slots)
from repro_torch.core.distributed import (LaneLayout, ShardedGraphSpec,
                                          measure_boundary_frac,
                                          partition_graph_host, rank_slice,
                                          sentinel_forced_membership,
                                          sharded_louvain_passes,
                                          sharded_modularity)
from repro_torch.core.dynamic import BatchUpdateStats
from repro_torch.core.engine import affected_frontier, normalize_screening
from repro_torch.core.graph import CSRGraph
from repro_torch.core.louvain import LouvainConfig, pad_membership


def _lane_batch(b_src, b_dst, b_w, b_valid, n_limit, sent: int):
    """One tenant's batch arrays, or T lanes' ((T, b_cap) arrays with T
    live counts and T limits), as (T, b_cap) arrays with (T, 1) live
    counts and limits (a missing limit is ``sent``)."""
    if b_src.dim() == 1:
        b_src, b_dst, b_w = b_src[None], b_dst[None], b_w[None]
        b_valid = [b_valid]
        n_limit = None if n_limit is None else [n_limit]
    t = b_src.shape[0]
    cols = [torch.as_tensor(np.asarray(x, np.int64),
                            device=b_src.device).view(t, 1)
            for x in (b_valid, [sent] * t if n_limit is None else n_limit)]
    return (b_src, b_dst, b_w, *cols)


def shard_batch_slots(spec: ShardedGraphSpec, shard_ix: int, src_l, dst_l,
                      w_l, b_src, b_dst, b_w, b_valid,
                      n_limit=None):
    """The unified slot list of one rank's batch apply: ``(all_src,
    all_dst, all_w, rank, is_batch)``, the rank's ``(e_per_shard,)`` slots
    (rank 0) and then the batch's directed slots that it owns.

    An undirected entry {u, v} -> w is slot (u, v) on owner(u) and (v, u)
    on owner(v); a self loop is one slot, as in the CSR apply.  Entries with
    an endpoint ``>= n_limit`` (the CSR ``n_cap``; ``n_pad`` may exceed it)
    are dead.  The batch's slots are interleaved ``fwd0, rev0, fwd1, rev1,
    ...`` with rank ``1 + i``: rank order is list order, so one stable key
    sort gives the reference's (src, dst, rank) order (the reference lists
    every forward slot before every reverse one; a forward and a reverse
    slot of one key come from two entries, so their ranks differ).

    The T lanes of a sharded fleet bucket take (T, b_cap) batch arrays in
    tenant ids with T live counts and T limits: the slots are then the
    flat ones of their ``LaneLayout`` (lane i's at ``[i * e_per, (i + 1) *
    e_per)``), the batches follow lane by lane, and lane i's entry j ranks
    ``1 + i * b_cap + j``.  Keys of two lanes never meet, so each lane
    resolves as its tenant alone."""
    sent = spec.sentinel
    b_src, b_dst, b_w, bv, lim = _lane_batch(b_src, b_dst, b_w, b_valid,
                                             n_limit, sent)
    t, b_cap = b_src.shape
    lanes = LaneLayout(spec, t)
    v_per = spec.v_per_shard
    dev = src_l.device
    u = b_src.to(torch.int32)
    v = b_dst.to(torch.int32)
    b_live = ((torch.arange(b_cap, device=dev) < bv) & (u < lim)
              & (v < lim))
    own_u = torch.div(u, v_per, rounding_mode="floor") == int(shard_ix)
    own_v = torch.div(v, v_per, rounding_mode="floor") == int(shard_ix)
    live_fwd = b_live & own_u
    live_rev = b_live & own_v & (u != v)
    lane_ix = torch.arange(t, device=dev)[:, None]
    uf, vf = lanes.flat_ids(u, lane_ix), lanes.flat_ids(v, lane_ix)
    fsent = lanes.flat.sentinel

    def interleave(fwd, rev, fill):
        return torch.stack([torch.where(live_fwd, fwd, fill),
                            torch.where(live_rev, rev, fill)],
                           -1).reshape(-1)

    all_src = torch.cat([src_l, interleave(uf, vf, fsent)])
    all_dst = torch.cat([dst_l, interleave(vf, uf, fsent)])
    all_w = torch.cat([w_l, interleave(b_w, b_w, 0.0)]).to(torch.float32)
    n_old = src_l.shape[0]
    is_batch = torch.cat([torch.zeros(n_old, dtype=torch.bool, device=dev),
                          torch.ones(2 * t * b_cap, dtype=torch.bool,
                                     device=dev)])
    rank = torch.cat([torch.zeros(n_old, dtype=torch.int32, device=dev),
                      1 + torch.arange(2 * t * b_cap, dtype=torch.int32,
                                       device=dev) // 2])
    return all_src, all_dst, all_w, rank, is_batch


def sorted_shard_batch_slots(spec: ShardedGraphSpec, shard_ix: int, src_l,
                             dst_l, w_l, b_src, *args, **kwargs):
    """The sorted slot list that K4 resolves in one rank's batch apply:
    ``(s_src, s_dst, s_w, s_batch)`` (``shard_batch_slots``'s arguments;
    ``sent`` is its layout's sentinel, the flat one over lanes)."""
    n_lanes = b_src.shape[0] if b_src.dim() == 2 else 1
    return sort_slots(*shard_batch_slots(spec, shard_ix, src_l, dst_l, w_l,
                                         b_src, *args, **kwargs),
                      LaneLayout(spec, n_lanes).flat.sentinel)


def apply_batch_shard(spec: ShardedGraphSpec, shard_ix: int, src_l, dst_l,
                      w_l, b_src, b_dst, b_w, b_valid,
                      n_limit=None, backend: str = "auto"):
    """One rank's batch apply: the batch's directed slots that rank
    ``shard_ix`` owns (``shard_batch_slots``), resolved against its
    ``(e_per_shard,)`` slots by the single-device apply's sort-reduce, so
    the union of every rank's slots is the ``apply_edge_batch`` result.
    ``backend``: ``"kernel"`` (K4), ``"sort"`` or ``"auto"``.

    Returns ``(src', dst', w', touched_own (v_per,), e_new)``; ``e_new`` is
    the uncapped live slot count (a 0-d tensor; above ``e_per_shard`` the
    apply overflowed) and ``touched_own`` marks the owned vertices whose
    incident weights changed.

    Over the T lanes of a sharded fleet bucket (``shard_batch_slots``) it
    is still one slot-list build, one stable key sort and one group
    resolve (ONE K4 launch for all lanes); each lane's records then compact
    into its own ``e_per_shard`` block (``sort_reduce_apply_slots`` with
    ``lanes``), touched_own is the rank's (T * v_per,) flat block and
    e_new the (T,) per-lane counts: a lane above ``e_per_shard`` (a whale)
    leaves the others as they would be alone.
    """
    n_lanes = b_src.shape[0] if b_src.dim() == 2 else 1
    flat = LaneLayout(spec, n_lanes).flat
    sent, v_per = flat.sentinel, flat.v_per_shard
    v0 = int(shard_ix) * v_per
    out_src, out_dst, out_w, e_new, chg_src, _ = sort_reduce_apply_slots(
        *shard_batch_slots(spec, shard_ix, src_l, dst_l, w_l, b_src, b_dst,
                           b_w, b_valid, n_limit),
        sent, spec.e_per_shard, backend,
        lanes=(v0, spec.v_per_shard, n_lanes))
    # Every changed slot's src is owned here (K4 records one per changed
    # group, the sort chain every slot of it: read as a set); the mirror
    # rank marks the other endpoint through its own (v, u) slot.
    loc = torch.clamp(torch.where(chg_src < sent, chg_src - v0, v_per),
                      0, v_per).to(torch.int64)
    touched = torch.zeros(v_per + 1, dtype=torch.bool, device=src_l.device)
    touched[loc] = True
    return (out_src, out_dst, out_w, touched[:v_per],
            e_new if b_src.dim() == 2 else e_new[0])


def sharded_batch_apply(group: ShardGroup, spec: ShardedGraphSpec, src_l,
                        dst_l, w_l, batch, n_valid, n_limit=None,
                        backend: str = "auto"):
    """The batch apply of one rank of ``group`` (the reference's
    ``make_sharded_batch_apply``): ``apply_batch_shard`` on its slots, one
    ``all_gather`` of the touched-owned slices and one ``pmax`` of the
    uncapped slot counts.  Returns ``(src', dst', w', touched (n_pad + 1,),
    e_max, n_valid')``: the replicated touched mask, the largest rank's
    slot count and the valid-vertex prefix extended past the highest
    touched id, both host ints read from replicated values in one
    transfer.

    ``batch`` may be a ``FleetBatch`` of the T lanes of a sharded fleet
    bucket, with T live counts ``n_valid`` and T limits ``n_limit`` (the
    tenants' n_cap, which may differ within a bucket): the slots and the
    touched mask are then the flat ones of their ``LaneLayout``, and
    e_max and n_valid' are (T,) host arrays, all read in one transfer."""
    lanes_in = batch.src.dim() == 2
    n_lanes = batch.src.shape[0] if lanes_in else 1
    lanes = LaneLayout(spec, n_lanes)
    src2, dst2, w2, touched_own, e_new = apply_batch_shard(
        spec, group.shard_index(), src_l, dst_l, w_l, batch.src, batch.dst,
        batch.weight, batch.b_valid, n_limit, backend)
    touched = torch.cat([group.all_gather(touched_own),
                         torch.zeros(1, dtype=torch.bool,
                                     device=touched_own.device)])
    idx = torch.arange(spec.n_pad, device=touched.device)
    top = torch.max(torch.where(lanes.rows(touched), idx, -1), 1).values
    host = torch.cat([group.pmax(e_new.to(torch.int64).view(n_lanes)),
                      top.to(torch.int64)]).cpu().numpy()
    group.branch_reads += 1
    e_max = host[:n_lanes]
    nv = np.maximum(np.asarray(n_valid, np.int64).reshape(n_lanes),
                    host[n_lanes:] + 1)
    if not lanes_in:
        return src2, dst2, w2, touched, int(e_max[0]), int(nv[0])
    return src2, dst2, w2, touched, e_max, nv


def _grow_slots(spec: ShardedGraphSpec, src_l, dst_l, w_l,
                e_per_new: int):
    """One rank's slots in a wider layout: the live slots stay the sorted
    prefix they are, padding ``(sent, sent, 0)`` fills the rest (the
    reference re-buckets the gathered live slots on the host into the same
    arrays)."""
    extra = int(e_per_new) - spec.e_per_shard
    if extra < 0:
        raise ValueError(f"cannot shrink e_per_shard {spec.e_per_shard} "
                         f"-> {e_per_new}")
    sent = spec.sentinel

    def pad(x, fill):
        return torch.cat([x, torch.full((extra,), fill, dtype=x.dtype,
                                        device=x.device)])

    return (pad(src_l, sent), pad(dst_l, sent), pad(w_l, 0.0),
            spec._replace(e_per_shard=int(e_per_new)))


@dataclasses.dataclass
class ShardedDynamicResult:
    """A sharded stream's outcome, the reference's fields, plus the host
    partition's seconds."""

    membership: np.ndarray       # (n_valid,) final community per vertex
    n_communities: int
    batch_stats: List[BatchUpdateStats]
    total_seconds: float
    n_regrows: int               # capacity-growth events
    spec: ShardedGraphSpec       # final layout (e_per_shard may have grown)
    comm_backend: str = "gather"          # resolved exchange backend
    comm_rounds: int = 0                  # engine rounds across the stream
    comm_fallback_rounds: int = 0         # rounds the delta caps overflowed
    bytes_on_wire: int = 0                # priced move-phase bytes
    #: Bytes the move phases handed to the collectives, over all ranks
    #: (the port's wire; ``bytes_on_wire`` keeps the reference's price).
    wire_bytes: int = 0
    reshard_passes: int = 0               # skew-aware owner re-shards
    reshard_bytes: int = 0                # their priced one-time bytes
    #: Worst rank load fraction before / after a re-shard across the
    #: stream (None when no pass re-sharded).
    max_shard_load_frac_before: Optional[float] = None
    max_shard_load_frac_after: Optional[float] = None
    #: Largest per-rank coarse edge tier any pass ran at.
    coarse_e_per_max: int = 0
    #: Resolved state layout, its boundary-mover bytes across the stream and
    #: the fine partition's measured boundary fraction (None unless
    #: measured).
    state_layout: str = "replicated"
    halo_bytes: int = 0
    boundary_frac: Optional[float] = None
    #: Summed per-pass seconds of every batch's pass loop.
    pass_seconds_total: float = 0.0
    #: The host partition's seconds (set-up, inside ``total_seconds``).
    partition_seconds: float = 0.0

    @property
    def updates_per_second(self) -> float:
        edges = sum(s.batch_size for s in self.batch_stats)
        return edges / max(self.total_seconds, 1e-12)

    @property
    def bytes_per_round(self) -> float:
        return self.bytes_on_wire / max(self.comm_rounds, 1)

    @property
    def halo_bytes_per_round(self) -> float:
        return self.halo_bytes / max(self.comm_rounds, 1)


def louvain_dynamic_sharded(
    graph: CSRGraph, group: ShardGroup, batches: Sequence[EdgeBatch],
    prev: Optional[np.ndarray] = None,
    config: LouvainConfig = LouvainConfig(), *, screening=True,
    track_modularity: bool = False, grow_capacity: bool = True,
    e_per_shard: Optional[int] = None, apply_backend: str = "auto",
) -> ShardedDynamicResult:
    """Stream edge batches through warm-started sharded Louvain on one rank
    of ``group``; every rank calls it with the same graph, batches and
    arguments (the reference's ``louvain_dynamic_sharded`` with a
    ``ShardGroup`` in place of ``(mesh, axes)``).

    The graph is partitioned once with vertex capacity ``graph.n_cap`` and
    ``e_per_shard`` slots per rank (default: 25% slack plus room for one
    worst-case batch, ``2 * b_cap``).  Each batch is applied in the layout
    (K4 on the card), delta-screened into a seed frontier (``screening``:
    ``True``/``"community"``, ``"vertex"``, ``"auto"`` or ``False``) and
    re-optimised from the previous membership by the sharded pass loop
    with ``config``'s knobs (``comm_backend``, ``state_layout``,
    ``refine``, ``reshard``, ``pipeline_fetch``, ``use_ladder``).  A batch
    that overflows ``e_per_shard`` doubles it and is applied again with
    ``grow_capacity``, else raises ``ValueError``.  ``prev`` is the
    membership before the stream; ``None`` runs one cold pass loop.
    ``apply_backend``: ``"auto"`` (K4 on the card, the sort chain on the
    CPU), ``"kernel"`` or ``"sort"``; equal results.
    """
    t_start = time.perf_counter()
    screen_mode = normalize_screening(screening)
    n_shards = group.world_size
    cb = resolve_comm_backend(config.comm_backend, n_shards)
    resolve_reshard(config.reshard)
    dev = group.device
    n_live = int(graph.n_valid)
    src_g, dst_g, w_g, spec = partition_graph_host(graph, n_shards,
                                                   n_target=graph.n_cap)
    bfrac = (measure_boundary_frac(src_g, dst_g, spec, n_live)
             if n_shards > 1 and config.state_layout != "replicated"
             else None)
    sl = resolve_state_layout(config.state_layout, n_shards, bfrac)
    if e_per_shard is None:
        b_max = max((b.b_cap for b in batches), default=1)
        e_per_shard = spec.e_per_shard + spec.e_per_shard // 4 + 2 * b_max
    src_l, dst_l, w_l = rank_slice(src_g, dst_g, w_g, spec,
                                   group.shard_index(), dev)
    del src_g, dst_g, w_g
    if int(e_per_shard) > spec.e_per_shard:
        src_l, dst_l, w_l, spec = _grow_slots(spec, src_l, dst_l, w_l,
                                              int(e_per_shard))
    partition_seconds = time.perf_counter() - t_start
    n_limit = graph.n_cap      # logical vertex capacity (n_pad may exceed it)

    pass_kw = dict(max_passes=config.max_passes,
                   max_iterations=config.max_iterations,
                   initial_tolerance=config.initial_tolerance,
                   tolerance_drop=config.tolerance_drop,
                   aggregation_tolerance=config.aggregation_tolerance,
                   gate_fraction=config.gate_fraction,
                   use_pruning=config.use_pruning,
                   use_ladder=config.use_ladder, comm_backend=cb,
                   state_layout=sl, refine=config.refine,
                   reshard=config.reshard,
                   pipeline_fetch=config.pipeline_fetch)
    acc = dict(comm_rounds=0, comm_fallback_rounds=0, bytes_on_wire=0,
               wire_bytes=0, halo_bytes=0, reshard_passes=0, reshard_bytes=0,
               coarse_e_per_max=0, pass_seconds_total=0.0,
               max_shard_load_frac_before=None,
               max_shard_load_frac_after=None)

    def run_passes(n_live_, **kw):
        gc, nc, rows = sharded_louvain_passes(group, src_l, dst_l, w_l, spec,
                                              n_live_, **kw, **pass_kw)
        acc["comm_rounds"] += sum(r["comm_rounds"] for r in rows)
        acc["comm_fallback_rounds"] += sum(r["comm_fallback_rounds"]
                                           for r in rows)
        acc["bytes_on_wire"] += sum(r["comm_bytes"] for r in rows)
        acc["wire_bytes"] += sum(r["wire_bytes"] for r in rows)
        acc["halo_bytes"] += sum(r["halo_bytes"] for r in rows)
        acc["pass_seconds_total"] += sum(r["seconds"] for r in rows)
        for r in rows[1:]:      # coarse tiers only (row 0 is the fine pass)
            acc["coarse_e_per_max"] = max(acc["coarse_e_per_max"],
                                          r["e_per_shard"])
        for r in rows:
            if r["reshard"]:
                acc["reshard_passes"] += 1
                acc["reshard_bytes"] += r["reshard_bytes"]
                for key in ("max_shard_load_frac_before",
                            "max_shard_load_frac_after"):
                    acc[key] = max(acc[key] or 0.0, r[key])
        return sentinel_forced_membership(gc, n_live_, spec.n_pad), nc

    if prev is None:
        mem, n_comms = run_passes(n_live)
    else:
        mem = torch.from_numpy(pad_membership(
            np.asarray(prev, np.int32)[:spec.n_pad], spec.n_pad)).to(dev)
        n_comms = int(len(np.unique(np.asarray(prev)[:n_live])))

    stats: List[BatchUpdateStats] = []
    counts: List[torch.Tensor] = []
    n_regrows = 0
    for batch in batches:
        t0 = time.perf_counter()
        out = sharded_batch_apply(group, spec, src_l, dst_l, w_l, batch,
                                  n_live, n_limit, apply_backend)
        if out[4] > spec.e_per_shard:
            if not grow_capacity:
                raise ValueError(
                    f"sharded edge batch overflows capacity: a rank needs "
                    f"{out[4]} slots > e_per_shard={spec.e_per_shard}")
            # Grow the pre-apply slots and apply the batch again.
            src_l, dst_l, w_l, spec = _grow_slots(
                spec, src_l, dst_l, w_l,
                max(2 * spec.e_per_shard, out[4]))
            n_regrows += 1
            out = sharded_batch_apply(group, spec, src_l, dst_l, w_l, batch,
                                      n_live, n_limit, apply_backend)
        src_l, dst_l, w_l, touched, _, n_live = out
        t1 = time.perf_counter()

        frontier = (affected_frontier(touched, mem, n_live, screen_mode)
                    if screen_mode is not None else None)
        mem, n_comms = run_passes(n_live, init_membership=mem,
                                  init_frontier=frontier)
        t2 = time.perf_counter()
        # Read after the stream, in one transfer.
        counts.append(torch.stack([
            touched.sum(),
            frontier.sum() if frontier is not None
            else torch.tensor(n_live, device=dev)]))
        stats.append(BatchUpdateStats(
            batch_size=int(batch.b_valid), n_touched=-1, frontier_size=-1,
            n_vertices=n_live, n_communities=n_comms,
            apply_seconds=t1 - t0, update_seconds=t2 - t1,
            modularity=(sharded_modularity(group, src_l, dst_l, w_l, mem)
                        if track_modularity else None)))
    if counts:
        for s, (tc, fs) in zip(stats, torch.stack(counts).tolist()):
            s.n_touched, s.frontier_size = int(tc), int(fs)

    membership = mem[:n_live].cpu().numpy()
    return ShardedDynamicResult(
        membership=membership,
        n_communities=int(len(np.unique(membership))),
        batch_stats=stats, total_seconds=time.perf_counter() - t_start,
        n_regrows=n_regrows, spec=spec, comm_backend=cb, state_layout=sl,
        boundary_frac=bfrac, partition_seconds=partition_seconds, **acc)
