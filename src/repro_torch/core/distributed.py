"""Sharded static GVE-Louvain over ``torch.distributed``
(``repro.core.distributed``).

  - 1-D **vertex partition**: rank s owns the vertices ``[s * v_per, (s +
    1) * v_per)`` and every directed slot whose source it owns, in one
    ``(e_per_shard,)`` slice on its device.  Every rank builds the same host
    partition (``partition_graph_host``, deterministic numpy) and keeps its
    slice.
  - **Replicated community state** (``state_layout="replicated"``): C,
    Sigma and K, ``(n_pad + 1,)`` each, on every rank.  K is owned per
    vertex (all of a vertex's slots live on its owner), so the replicated K
    is an ``all_gather`` of the owned slices.  Per round, the ``"gather"``
    backend (``ShardedScanner``) gathers the owned membership slices and
    moved masks and sums the dense Sigma deltas and community sizes across
    ranks; the ``"delta"`` backend (``DeltaShardedScanner``) ships only the
    movers, bit-packed, and rebuilds Sigma and sizes from the replicated K
    and membership.
  - **Hybrid state layout** (``state_layout="hybrid"``,
    ``HybridShardedScanner``): the membership stays fresh only on a rank's
    own block and on the other ranks' boundary vertices; each rank ships
    its boundary movers and its movers' per-community (Sigma, size) deltas,
    and one owned-slice ``all_gather`` re-replicates the membership at the
    end of the phase.
  - **Distributed aggregation**: each rank reduces its relabelled slots,
    an ``all_gather`` shares the partial records, and each rank re-reduces
    the rows it owns in the coarse partition.  Both reductions resolve
    their sorted groups in the kernel K3 (``coarsen_records``).
  - **Skew-aware re-sharding** (``reshard="auto"``): after an aggregation
    whose coarse edges pile onto few ranks, the coarse ids are relabelled
    onto balanced owner blocks (``plan_reshard``); the layout then has gaps,
    and the pass carries a live-vertex mask in place of ``id < n_live``.

Every rank runs the same pass loop and takes every host decision (sweep
stop, overflow branch, ladder tier, re-shard, overflow retry, pass stop)
from a replicated value, so no two ranks branch apart.  Float sums across
ranks are gathers of the partials added in rank order
(``ShardGroup.psum``).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.louvain_arch import (LADDER_SLACK, _pow2_at_least,
                                              delta_move_cap,
                                              hybrid_touched_cap,
                                              plan_reshard,
                                              resolve_coarse_capacity,
                                              resolve_comm_backend,
                                              resolve_reshard,
                                              resolve_state_layout)
from repro_torch.core.aggregate import coarsen_records
from repro_torch.core.collectives import ShardGroup
from repro_torch.core.comm import (CommPlan, boundary_mask, comm_plan,
                                   compact_movers, label_bits, pack_bits,
                                   packed_lanes, phase_bytes, reshard_bytes,
                                   size_delta_width, topk_touched_deltas,
                                   unpack_bits)
from repro_torch.core.engine import (ConstrainedScanner, EngineConfig,
                                     MoveEngine, MoveState,
                                     assert_outer_sane,
                                     mask_cross_outer_slots, sanitize_outer,
                                     valid_ids)
from repro_torch.core.graph import CSRGraph, scatter_slots, segment_sum
from repro_torch.core.louvain import _leiden_warm_membership, pad_membership
from repro_torch.core.modularity import delta_modularity

_NEG_INF = float("-inf")


class AggregationOverflow(RuntimeError):
    """A shard owns more coarse edges than ``e_per_shard`` (community-
    ownership skew).  Carries ``owned_max``."""

    def __init__(self, owned_max: int, e_per_shard: int):
        super().__init__(
            f"aggregation overflow: a shard owns {owned_max} coarse edges "
            f"> capacity {e_per_shard}; re-partition with more headroom "
            "(community skew)")
        self.owned_max = owned_max


class ShardedGraphSpec(NamedTuple):
    """Static layout facts for a vertex-partitioned edge list."""

    n_shards: int
    v_per_shard: int     # owned vertices per shard
    e_per_shard: int     # padded edge slots per shard
    n_pad: int           # n_shards * v_per_shard

    @property
    def sentinel(self) -> int:
        return self.n_pad


class LaneLayout(NamedTuple):
    """``n_lanes`` tenants of one ``spec`` side by side (the lanes of a
    sharded fleet bucket, ``core/fleet.py``) as ONE sharded layout,
    ``flat``: vertex v of lane i, owned by rank r = v // v_per, has the flat
    id ``r * (T * v_per) + i * v_per + (v - r * v_per)``, and the flat
    sentinel is ``T * n_pad``.  So each rank's owned flat ids stay one
    contiguous block (owned-slice gathers keep their shape), a lane's
    vertices are a contiguous block inside it (the engine's per-stream dQ
    blocks), and flat ids keep the order within a lane (sort keys and
    min-id tie breaks compare what they compare for the tenant alone).  A
    rank keeps lane i's slots at ``[i * e_per, (i + 1) * e_per)`` of its
    flat slot list.  With one lane every map is the identity."""

    spec: ShardedGraphSpec
    n_lanes: int = 1

    @property
    def flat(self) -> ShardedGraphSpec:
        s, t = self.spec, self.n_lanes
        return ShardedGraphSpec(s.n_shards, t * s.v_per_shard,
                                t * s.e_per_shard, t * s.n_pad)

    def flat_ids(self, x: torch.Tensor, lane) -> torch.Tensor:
        """Tenant ids of lane(s) ``lane`` (an int or a tensor broadcasting
        against ``x``) -> int32 flat ids; ids outside [0, n_pad) become
        the flat sentinel."""
        if self.n_lanes == 1:
            return x.to(torch.int32)
        v_per, n_pad = self.spec.v_per_shard, self.spec.n_pad
        x64 = x.to(torch.int64)
        f = ((x64 // v_per) * (self.n_lanes * v_per) + lane * v_per
             + x64 % v_per)
        return torch.where((x64 >= 0) & (x64 < n_pad), f,
                           self.n_lanes * n_pad).to(torch.int32)

    def tenant_ids(self, f: torch.Tensor) -> torch.Tensor:
        """Flat ids -> int32 ids in their own tenant's layout (the flat
        sentinel -> n_pad)."""
        if self.n_lanes == 1:
            return f.to(torch.int32)
        v_per, n_pad = self.spec.v_per_shard, self.spec.n_pad
        f64 = f.to(torch.int64)
        v = (f64 // (self.n_lanes * v_per)) * v_per + f64 % v_per
        return torch.where(f64 < self.n_lanes * n_pad, v,
                           n_pad).to(torch.int32)

    def lane_of(self, f: torch.Tensor) -> torch.Tensor:
        """The lane of each flat id (``n_lanes`` for the sentinel)."""
        v_per = self.spec.v_per_shard
        f64 = f.to(torch.int64)
        return torch.where(f64 < self.flat.n_pad,
                           (f64 % (self.n_lanes * v_per)) // v_per,
                           self.n_lanes)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """A flat vertex-indexed array (``(T * n_pad [+ 1],)``) -> its (T,
        n_pad) rows, lane by lane in tenant id order."""
        s, t = self.spec, self.n_lanes
        return (x[:t * s.n_pad].view(s.n_shards, t, s.v_per_shard)
                .transpose(0, 1).reshape(t, s.n_pad))

    def flat_rows(self, rows: torch.Tensor, fill) -> torch.Tensor:
        """Inverse of ``rows``: (T, n_pad) -> (T * n_pad + 1,), ``fill`` at
        the flat sentinel."""
        s, t = self.spec, self.n_lanes
        body = (rows.reshape(t, s.n_shards, s.v_per_shard).transpose(0, 1)
                .reshape(-1))
        return torch.cat([body, torch.full((1,), fill, dtype=rows.dtype,
                                           device=rows.device)])

    def flat_membership(self, mem: torch.Tensor) -> torch.Tensor:
        """(T, n_pad + 1) replicated memberships in tenant ids -> the flat
        (T * n_pad + 1,) membership: positions and labels mapped."""
        lane = torch.arange(self.n_lanes, device=mem.device)[:, None]
        return self.flat_rows(self.flat_ids(mem[:, :self.spec.n_pad], lane),
                              self.flat.sentinel)

    def tenant_rows(self, comm: torch.Tensor) -> torch.Tensor:
        """Inverse of ``flat_membership``: (T, n_pad + 1) rows in tenant
        ids, the sentinel column at n_pad."""
        n_pad = self.spec.n_pad
        body = self.tenant_ids(self.rows(comm))
        return torch.cat([body, torch.full((self.n_lanes, 1), n_pad,
                                           dtype=torch.int32,
                                           device=comm.device)], 1)

    def flat_slots(self, slots) -> Tuple[torch.Tensor, ...]:
        """The lanes' ``(src, dst, w)`` slices of one rank, in their own
        ids, as the rank's flat slot list (lane i's at ``[i * e_per, (i +
        1) * e_per)``)."""
        return tuple(torch.cat([self.flat_ids(x[k], i) if k < 2 else x[k]
                                for i, x in enumerate(slots)])
                     for k in range(3))

    def lane_slots(self, src, dst, w, lane: int) -> Tuple[torch.Tensor, ...]:
        """Lane ``lane``'s ``(src, dst, w)`` block of a flat slot list, in
        its own ids."""
        blk = slice(lane * self.spec.e_per_shard,
                    (lane + 1) * self.spec.e_per_shard)
        return self.tenant_ids(src[blk]), self.tenant_ids(dst[blk]), w[blk]

    def thresholds(self, counts, device) -> torch.Tensor:
        """(T * n_pad + 1,) per-vertex thresholds of (T,) per-lane live
        counts (``engine.valid_ids``): flat id f of lane i is live iff f <
        its threshold, the flat id of count_i (the sentinel at or past
        n_pad); the sentinel slot's is 0."""
        c = torch.as_tensor(np.asarray(counts, np.int64), device=device)
        thr = self.flat_ids(c, torch.arange(self.n_lanes, device=device))
        ids = torch.arange(self.flat.n_pad + 1, device=device)
        out = thr.to(torch.int64)[torch.clamp(self.lane_of(ids),
                                              max=self.n_lanes - 1)]
        out[-1] = 0
        return out


# ---------------------------------------------------------------------------
# Host partition.
# ---------------------------------------------------------------------------

def bucket_slots_host(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                      spec: ShardedGraphSpec
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Owner bucketing of live directed slots into the padded per-shard
    layout of ``spec``: global ``(n_shards * e_per_shard,)`` numpy arrays,
    shard s's slice at ``[s * e_per, (s + 1) * e_per)``, padding
    ``(n_pad, n_pad, 0)``.  Raises ``ValueError`` when a shard owns more
    than ``e_per_shard`` slots."""
    n_shards, v_per, e_per = spec.n_shards, spec.v_per_shard, spec.e_per_shard
    n_pad = spec.n_pad
    owner = np.asarray(src) // v_per
    counts = np.bincount(owner, minlength=n_shards)
    if counts.size > n_shards or (counts.max(initial=0) > e_per):
        raise ValueError(
            f"slots do not fit the shard layout: max owned "
            f"{int(counts.max(initial=0))} > e_per_shard={e_per}")
    s_out = np.full((n_shards, e_per), n_pad, np.int32)
    d_out = np.full((n_shards, e_per), n_pad, np.int32)
    w_out = np.zeros((n_shards, e_per), np.float32)
    if owner.size and not np.all(owner[1:] >= owner[:-1]):
        order = np.argsort(owner, kind="stable")
        src, dst, w, owner = src[order], dst[order], w[order], owner[order]
    starts = np.searchsorted(owner, np.arange(n_shards))
    ends = np.searchsorted(owner, np.arange(n_shards), side="right")
    for s in range(n_shards):
        cnt = ends[s] - starts[s]
        s_out[s, :cnt] = src[starts[s]:ends[s]]
        d_out[s, :cnt] = dst[starts[s]:ends[s]]
        w_out[s, :cnt] = w[starts[s]:ends[s]]
    return s_out.reshape(-1), d_out.reshape(-1), w_out.reshape(-1)


def partition_graph_host(graph: CSRGraph, n_shards: int, *,
                         n_target: Optional[int] = None,
                         e_per_shard: Optional[int] = None):
    """1-D vertex partition of a ``CSRGraph`` -> global padded numpy edge
    arrays and their ``ShardedGraphSpec``, as the reference lays them out
    (``n_target`` / ``e_per_shard`` reserve headroom)."""
    n = int(n_target if n_target is not None else graph.n_valid)
    v_per = -(-n // n_shards)
    n_pad = v_per * n_shards
    src = graph.src.cpu().numpy()
    dst = graph.indices.cpu().numpy()
    w = graph.weights.cpu().numpy()
    live = src < graph.n_cap
    src, dst, w = src[live], dst[live], w[live]
    owner = src // v_per
    e_per = max(int(np.bincount(owner, minlength=n_shards).max()), 1,
                int(e_per_shard or 0))
    spec = ShardedGraphSpec(n_shards, v_per, e_per, n_pad)
    return (*bucket_slots_host(src, dst, w, spec), spec)


def rank_slice(src_g, dst_g, w_g, spec: ShardedGraphSpec, rank: int,
               device) -> Tuple[torch.Tensor, ...]:
    """Rank ``rank``'s ``(e_per_shard,)`` slices of global numpy edge
    arrays, on ``device``."""
    lo, hi = rank * spec.e_per_shard, (rank + 1) * spec.e_per_shard

    def put(x, dt):
        return torch.from_numpy(np.array(np.asarray(x)[lo:hi],
                                         dtype=dt)).to(device)

    return put(src_g, np.int32), put(dst_g, np.int32), put(w_g, np.float32)


# ---------------------------------------------------------------------------
# The sharded scan and the exchange backends.
# ---------------------------------------------------------------------------

def best_moves_shard(src_l, dst_l, w_l, src_loc, comm, sigma, k_l,
                     frontier_l, m, v0: int, v_per: int, sent: int):
    """Per-shard best (community, dQ) for the owned vertices, by sort-reduce
    over the shard's slots (the reference's ``_best_moves_shard``):
    ``(best_c (v_per,) int32, best_dq (v_per,) float32)``.  A vertex's
    slots all live on its shard, in CSR order, so each (vertex, community)
    group sums the weights a single-device scan sums, in the same order.
    ``m`` is 0-d, or (v_per,): each owned vertex's own lane's m."""
    cdst = comm[dst_l]
    own_comm_l = comm[v0:v0 + v_per]
    own_edge = (cdst == comm[src_l]) & (dst_l != src_l)
    k_to_own = segment_sum(torch.where(own_edge, w_l, 0.0), src_loc,
                           v_per + 1)

    key = src_loc * (sent + 1) + cdst.to(torch.int64)
    s_key, order = torch.sort(key, stable=True)
    s_src = src_loc[order]
    s_c = cdst[order]
    s_w = torch.where(dst_l[order] == src_l[order], 0.0, w_l[order])
    new_group = torch.ones_like(s_key, dtype=torch.bool)
    new_group[1:] = s_key[1:] != s_key[:-1]
    gid = torch.cumsum(new_group, 0) - 1
    k_i_to_c = segment_sum(s_w, gid, s_w.shape[0])[gid]

    sig_own_l = sigma[own_comm_l]
    valid_row = s_src < v_per
    row = torch.clamp(s_src, max=v_per - 1)
    dq = delta_modularity(
        k_i_to_c, torch.where(valid_row, k_to_own[s_src], 0.0),
        torch.where(valid_row, k_l[row], 0.0),
        sigma[torch.clamp(s_c, max=sent)],
        torch.where(valid_row, sig_own_l[row], 0.0),
        m[row] if m.dim() else m)
    valid = (valid_row & (s_c != comm[src_l[order]]) & (s_c < sent)
             & frontier_l[row])
    dq = torch.where(valid, dq, _NEG_INF)
    best_dq = torch.full((v_per + 1,), _NEG_INF, dtype=torch.float32,
                         device=dq.device)
    best_dq.scatter_reduce_(0, s_src, dq, "amax", include_self=True)
    best_dq = torch.where(torch.isfinite(best_dq), best_dq, _NEG_INF)
    is_best = valid & (dq == best_dq[s_src])
    best_c = torch.full((v_per + 1,), sent, dtype=torch.int32,
                        device=dq.device)
    best_c.scatter_reduce_(0, s_src, torch.where(is_best, s_c, sent),
                           "amin", include_self=True)
    return best_c[:v_per], best_dq[:v_per]


class ShardedScanner:
    """Engine backend of one rank: the sort-reduce scan over its slots and
    the gather exchange (``MoveEngine``'s protocol).  The local layout is
    the rank's ``v_per_shard`` owned vertices; C and Sigma are the
    replicated ``(n_pad + 1,)`` arrays.  Per round: ``all_gather`` of the
    owned membership slices and of the moved masks, and a rank-order sum
    of the dense Sigma deltas, the community sizes and dQ.

    With ``n_lanes`` > 1 the rank holds the lanes of a sharded fleet bucket
    in their ``LaneLayout`` (``spec`` is one tenant's layout): every array
    is the flat layout's, each lane is one of the engine's streams (its own
    m, dQ, tolerance and stop), and the Weyl round gate hashes each
    vertex's id in its own tenant's layout, so a lane runs what its tenant
    runs alone.  ``m`` is 0-d or one per lane."""

    def __init__(self, group: ShardGroup, spec: ShardedGraphSpec, src_l,
                 dst_l, w_l, k, m, n_lanes: int = 1):
        self.lanes = LaneLayout(spec, n_lanes)
        spec = self.lanes.flat
        v_per, sent = spec.v_per_shard, spec.sentinel
        lane_v = self.lanes.spec.v_per_shard
        dev = src_l.device
        self.group, self.spec = group, spec
        self.src_l, self.dst_l, self.w_l = src_l, dst_l, w_l
        m = torch.as_tensor(m, dtype=torch.float32, device=dev)
        self.k = k
        self.m = m if m.dim() == 0 else m.repeat_interleave(lane_v)
        self.sentinel = sent
        self.n_streams = n_lanes
        self.v0 = group.shard_index() * v_per
        self.local_ids = self.v0 + torch.arange(v_per, dtype=torch.int32,
                                                device=dev)
        self.gate_ids = self.lanes.tenant_ids(self.local_ids)
        self.stream_of = torch.arange(v_per, dtype=torch.int64,
                                      device=dev) // lane_v
        self.k_local = k[self.v0:self.v0 + v_per]
        self.src_loc = torch.where(src_l >= sent, v_per,
                                   src_l - self.v0).to(torch.int64)
        self.move_valid = None           # invalid slots carry comm == sent
        self.frontier_valid = self.local_ids < spec.n_pad
        self._lane_ix = None

    def scan(self, comm, sigma, frontier):
        return best_moves_shard(self.src_l, self.dst_l, self.w_l,
                                self.src_loc, comm, sigma, self.k_local,
                                frontier, self.m, self.v0,
                                self.spec.v_per_shard, self.sentinel)

    def comm_local(self, comm):
        return comm[self.v0:self.v0 + self.spec.v_per_shard]

    def count_ones(self, comm_l):
        return torch.where(comm_l < self.sentinel, 1, 0).to(torch.int32)

    def psum(self, x):
        return self.group.psum(x)

    def combine_sigma(self, sigma, add, sub):
        # One gather of both partials; with one rank this is exactly the
        # single-device engine's sigma + add - sub.
        both = self.group.psum(torch.stack([add, sub]))
        return sigma + both[0] - both[1]

    def gather_comm(self, comm_l):
        full = self.group.all_gather(comm_l)
        return torch.cat([full, torch.full((1,), self.sentinel,
                                           dtype=torch.int32,
                                           device=full.device)])

    def gather_mask(self, mask_l):
        full = self.group.all_gather(mask_l)
        return torch.cat([full, torch.zeros(1, dtype=torch.bool,
                                            device=full.device)])

    def mark_neighbors(self, moved):
        marked = segment_sum(moved[self.dst_l].to(torch.int32), self.src_loc,
                             self.spec.v_per_shard + 1)
        return marked[:self.spec.v_per_shard] > 0

    def resync_comm(self, comm):
        """The membership a phase returns: replicated already here."""
        return comm

    def per_lane(self, over: np.ndarray, dense, delta):
        """Each lane's state from the dense exchange where its round
        overflowed (``over``, per lane) and from the delta exchange
        elsewhere; either is None when no lane takes it.  Lanes never share
        a vertex or community id, so the choice is a select by lane."""
        if delta is None:
            return dense
        if dense is None:
            return delta
        if self._lane_ix is None:
            self._lane_ix = self.lanes.lane_of(torch.arange(
                self.sentinel + 1, device=self.k.device))
        pick = torch.from_numpy(np.append(over, False)).to(
            self.k.device)[self._lane_ix]
        return tuple(torch.where(pick, d, x) for d, x in zip(dense, delta))


class DeltaShardedScanner(ShardedScanner):
    """Movers-only exchange (the reference's ``DeltaShardedScanner``).

    Per round each rank ships one fused int32 word per lane: its mover
    count, its float32 dQ (as bits) and its movers as bit-packed (index,
    label) pairs in the tenant's own layout (``compact_movers``,
    ``pack_bits``: a lane's word is the tenant's word alone).  Every rank
    rebuilds the rest from replicated state: a mover shifts its K_i from
    its old community to its new one (K and the pre-round membership are
    replicated), the community sizes move by +-1 (integer-exact), and the
    moved mask is the label compare.  The gathered counts are replicated,
    so the overflow test (one host read per round, counted in
    ``group.branch_reads``) takes the same branch on every rank: a lane
    whose movers exceed the cap on any rank runs the gather exchange that
    round.  The movers arrive in rank order, each rank's in ascending
    vertex order, so Sigma's sums run in global vertex order, as on one
    rank.
    """

    def __init__(self, group: ShardGroup, spec: ShardedGraphSpec, src_l,
                 dst_l, w_l, k, m, n_lanes: int = 1):
        super().__init__(group, spec, src_l, dst_l, w_l, k, m, n_lanes)
        lane = self.lanes.spec
        self.move_cap = delta_move_cap(lane.v_per_shard)
        self.idx_width = label_bits(lane.v_per_shard + 1)
        self.lab_width = label_bits(lane.n_pad + 1)
        # One fused (index, label) pair per mover when it fits an int32.
        self.pair_width = self.idx_width + self.lab_width
        if self.pair_width <= 31:
            self.mover_lanes = packed_lanes(self.move_cap, self.pair_width)
        else:
            self.pair_width = None
            self.mover_lanes = (packed_lanes(self.move_cap, self.idx_width)
                                + packed_lanes(self.move_cap, self.lab_width))

    def community_sizes(self, comm, comm_l):
        # The replicated membership holds every rank's slice: one local
        # integer reduction equals the summed per-rank ones.
        sent = self.sentinel
        body = comm[:sent]
        return segment_sum(torch.where(body < sent, 1, 0).to(torch.int32),
                           torch.clamp(body, max=sent), sent + 1)

    def _unpack(self, g_mov):
        """(S, T, move_cap) lane indices and tenant labels of every rank's
        movers, from the gathered (S, T, lanes) mover words."""
        mcap = self.move_cap
        if self.pair_width is not None:
            pairs = unpack_bits(g_mov, self.pair_width, mcap)
            return pairs & ((1 << self.idx_width) - 1), pairs >> self.idx_width
        li = packed_lanes(mcap, self.idx_width)
        return (unpack_bits(g_mov[..., :li], self.idx_width, mcap),
                unpack_bits(g_mov[..., li:], self.lab_width, mcap))

    def _pack_movers(self, flag, best_c):
        """(lanes (T, L), counts (T,)): each lane's flagged owned vertices'
        (lane index, tenant label) pairs, bit-packed; dead buffer slots
        decode to index ``v_per`` of the tenant."""
        lane = self.lanes.spec
        lane_v = lane.v_per_shard
        flag = flag.view(self.n_streams, lane_v)
        lab = self.lanes.tenant_ids(best_c).view(self.n_streams, lane_v)
        if self.pair_width is not None:
            pv = (torch.arange(lane_v, dtype=torch.int32, device=flag.device)
                  | (lab << self.idx_width))
            _, pair_buf, n = compact_movers(flag, pv, self.move_cap, lane_v)
            return pack_bits(pair_buf, self.pair_width), n
        idx_buf, lab_buf, n = compact_movers(flag, lab, self.move_cap,
                                             lane.n_pad)
        return torch.cat([pack_bits(idx_buf, self.idx_width),
                          pack_bits(lab_buf, self.lab_width)], -1), n

    def _scatter_movers(self, comm, g_mov):
        """``comm`` with every rank's gathered movers written in.  Dead
        buffer slots (index v_per) are masked out here, where the
        reference's scatter dropped them out of bounds."""
        lane = self.lanes.spec
        lane_v, t = lane.v_per_shard, self.n_streams
        idxs, labs = self._unpack(g_mov)
        live = idxs < lane_v
        dev = comm.device
        ix = torch.arange(t, dtype=torch.int64, device=dev)[None, :, None]
        base = (torch.arange(g_mov.shape[0], dtype=torch.int64,
                             device=dev)[:, None, None] * (t * lane_v)
                + ix * lane_v)
        gid = (base + idxs)[live]
        lab = self.lanes.flat_ids(torch.clamp(labs, max=lane.n_pad)[live],
                                  ix.expand(labs.shape)[live])
        out = comm.clone()
        out[gid] = lab
        return out, gid, lab

    @staticmethod
    def _rank_order_dq(col):
        """The gathered per-rank float32 dQ bits (S, T) summed in rank
        order in float64, rounded once: (T,)."""
        parts = col.contiguous().view(torch.float32)
        dq = parts[0].to(torch.float64)
        for r in range(1, parts.shape[0]):
            dq = dq + parts[r].to(torch.float64)
        return dq.to(torch.float32)

    def _gather_words(self, cols):
        """ONE collective of every lane's fused word (``cols``: (T, k)
        int32 pieces, concatenated per lane): (S, T, W)."""
        wire = torch.cat(cols, 1)
        g = self.group.all_gather(wire.reshape(-1), tiled=False)
        return g.view(g.shape[0], self.n_streams, wire.shape[1])

    def exchange_round(self, comm, sigma, sizes, comm_l, do_move, best_c,
                       dq_local):
        sent, t = self.sentinel, self.n_streams
        lanes, n_moved = self._pack_movers(do_move, best_c)
        # ONE fused collective: mover count, the local dQ's bits, lanes.
        g = self._gather_words([n_moved.view(t, 1),
                                dq_local.to(torch.float32).view(t, 1)
                                .view(torch.int32), lanes])
        dq = self._rank_order_dq(g[:, :, 1])
        # Replicated by construction: every rank reads the same counts.
        self.group.branch_reads += 1
        over = (g[:, :, 0].amax(0) > self.move_cap).cpu().numpy()
        dense = delta = None
        if over.any():
            moved_k = torch.where(do_move, self.k_local, 0.0)
            add = segment_sum(moved_k, torch.where(do_move, best_c, sent),
                              sent + 1)
            sub = segment_sum(moved_k, torch.where(do_move, comm_l, sent),
                              sent + 1)
            comm_d = self.gather_comm(torch.where(do_move, best_c, comm_l))
            dense = (comm_d, self.combine_sigma(sigma, add, sub),
                     self.community_sizes(comm_d, comm_l))
        if not over.all():
            comm_x, gid, lab = self._scatter_movers(comm, g[:, :, 2:])
            old = comm[gid]
            kv = self.k[gid]
            one = torch.ones_like(lab)
            delta = (comm_x,
                     sigma + segment_sum(kv, lab, sent + 1)
                     - segment_sum(kv, old, sent + 1),
                     sizes.index_add(0, lab.to(torch.int64), one)
                     .index_add(0, old.to(torch.int64), -one))
        comm_new, sigma_new, sizes_new = self.per_lane(over, dense, delta)
        # A move always changes the label: the moved mask is a compare.
        return (comm_new, sigma_new, sizes_new, comm_new != comm,
                over.astype(np.int64), dq)


class HybridShardedScanner(DeltaShardedScanner):
    """Owner-partitioned working state (the reference's
    ``HybridShardedScanner``, state layout ``"hybrid"``).

    The membership is kept fresh only where a rank's scan reads it: its own
    ``v_per_shard`` block and each other rank's boundary set (vertices with
    a cross-rank slot, ``comm.boundary_mask``; slots are symmetric, so
    every remote ``dst`` a rank reads is in its owner's boundary).  Remote
    interior labels go stale mid-phase and are never read; the engine reads
    the membership only through ``comm_local``, the scan and the moved
    mask, so nothing inherited reads the stale labels (the sizes are seeded
    at the phase start, when the membership is replicated).

    Only ``k_local`` is read: each rank folds its own movers into
    per-community Sigma add / sub and size deltas, compacts each lane's
    touched communities in its tenant's id order
    (``topk_touched_deltas``), and ships them with its boundary movers in
    one fused int32 word per lane and round.  The replicated Sigma then
    becomes ``sigma + A - S`` with ``A`` / ``S`` the ranks' adds / subs
    summed in rank order in float64 and rounded once: the gather
    exchange's ``combine_sigma`` bit for bit at any world size, since a
    rank that did not touch a community adds nothing there.  (Add and sub
    travel as two float32 lanes per touched community; the reference ships
    their difference, and its byte pricing, which ``comm_bytes`` carries,
    counts one lane: ``wire_bytes`` counts both.)  Sizes move by integer
    deltas, exact in any order.

    The delta flavor (this class) keeps the policy mover cap and
    ``hybrid_touched_cap`` per lane; a lane that overflows either on any
    rank (one host read of the gathered counts, counted in
    ``group.branch_reads``) takes the dense resync that round.
    ``HybridGatherScanner`` prices worst-case caps and never overflows.
    ``resync_comm`` re-replicates the membership at the end of the phase
    with one owned-slice ``all_gather``.
    """

    can_overflow = True     # the delta flavor: policy caps + dense fallback

    def __init__(self, group: ShardGroup, spec: ShardedGraphSpec, src_l,
                 dst_l, w_l, k, m, n_lanes: int = 1):
        super().__init__(group, spec, src_l, dst_l, w_l, k, m, n_lanes)
        v_per, sent = self.spec.v_per_shard, self.sentinel
        lane_v = self.lanes.spec.v_per_shard
        if self.can_overflow:
            self.touched_cap = hybrid_touched_cap(lane_v)
        else:
            # Worst-case caps: every owned vertex a boundary mover, each
            # touching a distinct old and new community.
            self.move_cap = lane_v
            self.touched_cap = 2 * lane_v
            if self.pair_width is not None:
                self.mover_lanes = packed_lanes(lane_v, self.pair_width)
            else:
                self.mover_lanes = (packed_lanes(lane_v, self.idx_width)
                                    + packed_lanes(lane_v, self.lab_width))
        self.siz_width = size_delta_width(lane_v)
        # Computed once per phase from this phase's slots: aggregation,
        # ladder and re-shard boundaries build a new scanner.
        self.bnd_own = boundary_mask(src_l, dst_l, self.v0, v_per, sent)

    def resync_comm(self, comm):
        """The end of the phase: one ``all_gather`` of the fresh owned
        slices overwrites every stale remote-interior label."""
        return self.gather_comm(self.comm_local(comm))

    def exchange_round(self, comm, sigma, sizes, comm_l, do_move, best_c,
                       dq_local):
        v_per, sent = self.spec.v_per_shard, self.sentinel
        lane = self.lanes.spec
        lane_v, t = lane.v_per_shard, self.n_streams
        tcap, lab_w = self.touched_cap, self.lab_width
        dev = comm.device
        comm_own = torch.where(do_move, best_c, comm_l)

        # The sender's fold from the partitioned K: the dense paths' segment
        # sums over this rank's vertices, in the same order.
        moved_k = torch.where(do_move, self.k_local, 0.0)
        tgt = torch.where(do_move, best_c, sent)
        old = torch.where(do_move, comm_l, sent)
        add = segment_sum(moved_k, tgt, sent + 1)
        sub = segment_sum(moved_k, old, sent + 1)
        moves = do_move.to(torch.int32)
        cnt_add = segment_sum(moves, tgt, sent + 1)
        cnt_sub = segment_sum(moves, old, sent + 1)
        touched = (cnt_add > 0) | (cnt_sub > 0)
        # Each lane's touched communities in its tenant's id order; empty
        # slots hold the sentinel, whose add, sub and counts are 0.
        lane_ix = torch.arange(t, device=dev)[:, None]
        c_buf, a_buf, n_t = topk_touched_deltas(
            self.lanes.rows(add), self.lanes.rows(touched), tcap, lane.n_pad)
        at = self.lanes.flat_ids(c_buf, lane_ix).to(torch.int64)
        s_buf, z_buf = sub[at], (cnt_add - cnt_sub)[at]
        # Only boundary movers travel, as (row index, label) pairs.
        lanes, n_bnd = self._pack_movers(do_move & self.bnd_own, best_c)

        # ONE fused collective: [boundary movers, touched, dQ] header,
        # mover lanes, touched ids, Sigma adds, Sigma subs, size deltas
        # offset by v_per; one word per lane.
        g = self._gather_words([
            n_bnd.view(t, 1), n_t.view(t, 1),
            dq_local.to(torch.float32).view(t, 1).view(torch.int32), lanes,
            pack_bits(c_buf, lab_w), a_buf.view(torch.int32),
            s_buf.view(torch.int32), pack_bits(z_buf + lane_v,
                                               self.siz_width)])
        dq = self._rank_order_dq(g[:, :, 2])
        over = np.zeros(t, bool)
        if self.can_overflow:
            # Replicated by construction: every rank reads the same counts.
            self.group.branch_reads += 1
            cnts = g[:, :, :2].amax(0).cpu().numpy()
            over = (cnts[:, 0] > self.move_cap) | (cnts[:, 1] > tcap)
        dense = delta = None
        if over.any():
            # Dense resync: the owned slices are fresh, so one gather
            # rebuilds the replicated membership; the moved mask comes from
            # do_move (the stale pre-round labels make a compare unsound).
            dense = (self.gather_comm(comm_own),
                     self.combine_sigma(sigma, add, sub),
                     sizes + self.group.psum(cnt_add - cnt_sub),
                     self.gather_mask(do_move))
        if not over.all():
            l_m = lanes.shape[1]
            l_t = packed_lanes(tcap, lab_w)
            o_t = 3 + l_m
            o_a = o_t + l_t
            o_s = o_a + tcap
            o_z = o_s + tcap
            base = comm.clone()
            base[self.v0:self.v0 + v_per] = comm_own
            comm_new, _, _ = self._scatter_movers(base, g[:, :, 3:o_t])
            acc_a = torch.zeros(sent + 1, dtype=torch.float64, device=dev)
            acc_s = torch.zeros(sent + 1, dtype=torch.float64, device=dev)
            sizes_new = sizes
            for r in range(g.shape[0]):
                # Rank by rank, in rank order: the touched ids of one rank
                # are unique, so each add is deterministic (its empty slots
                # add zeros at the sentinel).
                cs = self.lanes.flat_ids(torch.clamp(
                    unpack_bits(g[r, :, o_t:o_a], lab_w, tcap),
                    max=lane.n_pad), lane_ix).reshape(-1).to(torch.int64)
                acc_a.index_add_(0, cs, g[r, :, o_a:o_s].contiguous()
                                 .view(torch.float32).reshape(-1)
                                 .to(torch.float64))
                acc_s.index_add_(0, cs, g[r, :, o_s:o_z].contiguous()
                                 .view(torch.float32).reshape(-1)
                                 .to(torch.float64))
                dz = unpack_bits(g[r, :, o_z:], self.siz_width,
                                 tcap) - lane_v
                sizes_new = sizes_new.index_add(0, cs, dz.reshape(-1))
            # Fresh wherever the moved mask is read: the own block and the
            # remote boundary; stale interior labels compare equal.
            delta = (comm_new, sigma + acc_a.to(torch.float32)
                     - acc_s.to(torch.float32), sizes_new, comm_new != comm)
        comm_new, sigma_new, sizes_new, moved = self.per_lane(over, dense,
                                                              delta)
        return comm_new, sigma_new, sizes_new, moved, over.astype(np.int64), dq


class HybridGatherScanner(HybridShardedScanner):
    """The hybrid layout over the gather backend: worst-case caps (every
    owned vertex a boundary mover, ``2 * v_per`` touched communities), so
    the exchange never overflows and reads no branch."""

    can_overflow = False


#: comm_backend -> scanner class of the replicated layout.
COMM_SCANNERS = {"gather": ShardedScanner, "delta": DeltaShardedScanner}

#: comm_backend -> scanner class of the hybrid layout.
HYBRID_SCANNERS = {"gather": HybridGatherScanner,
                   "delta": HybridShardedScanner}


def _scanner_cls(backend: str, state_layout: str):
    """The scanner of a concrete (comm backend, state layout) pair."""
    table = HYBRID_SCANNERS if state_layout == "hybrid" else COMM_SCANNERS
    return table[backend]


def sharded_comm_plan(spec: ShardedGraphSpec, backend: str,
                      state_layout: str = "replicated") -> CommPlan:
    """Bytes-on-wire plan of one engine round of ``spec`` (policy caps)."""
    return comm_plan(backend, spec.n_shards, spec.v_per_shard, spec.n_pad,
                     delta_move_cap(spec.v_per_shard),
                     state_layout=state_layout,
                     touched_cap=hybrid_touched_cap(spec.v_per_shard))


def measure_boundary_frac(src_g, dst_g, spec: ShardedGraphSpec,
                          n_live: Optional[int] = None) -> float:
    """Host-side share of live vertices with at least one cross-shard slot,
    over global numpy edge arrays (what ``state_layout="auto"`` reads)."""
    src = np.asarray(src_g).ravel()
    dst = np.asarray(dst_g).ravel()
    sent, v_per = spec.sentinel, spec.v_per_shard
    live = (src < sent) & (dst < sent)
    if n_live is None:
        n_live = int(np.unique(src[live]).size)
    remote = live & (src // v_per != dst // v_per)
    n_bnd = int(np.unique(src[remote]).size)
    return n_bnd / max(int(n_live), 1)


# ---------------------------------------------------------------------------
# Phases of one pass.
# ---------------------------------------------------------------------------

def distributed_move(group: ShardGroup, spec: ShardedGraphSpec, src_l, dst_l,
                     w_l, comm0, sigma0, k, frontier_g, m, tolerance, *,
                     config: EngineConfig, comm_backend: str = "gather",
                     state_layout: str = "replicated", n_lanes: int = 1):
    """The local-moving phase of one rank (``make_distributed_move``):
    returns (comm, sigma, iters, dq_sum, rounds, fallbacks, wire_bytes),
    all replicated (a hybrid phase re-replicates its membership before it
    returns).  ``frontier_g`` is the replicated (n_pad + 1,) seed frontier.

    With ``n_lanes`` > 1 the arrays are the flat ones of the ``LaneLayout``
    of ``n_lanes`` tenants of ``spec`` (a sharded fleet bucket), ``m`` and
    ``tolerance`` hold one value per lane, and iters, dq_sum, rounds and
    fallbacks come back per lane: each lane's equal its tenant's phase
    alone.  ``wire_bytes`` counts the bytes the phase handed to the
    collectives (rounds and resync), over all ranks: every rank hands the
    same shapes, so it is ``world_size`` times this rank's."""
    scanner = _scanner_cls(comm_backend, state_layout)(
        group, spec, src_l, dst_l, w_l, k, m, n_lanes)
    v0 = scanner.v0
    frontier0 = (frontier_g[v0:v0 + scanner.spec.v_per_shard]
                 & scanner.frontier_valid)
    wire0 = group.wire_bytes
    st = MoveEngine(scanner, config).run(comm0, sigma0, frontier0, tolerance)
    comm = scanner.resync_comm(st.comm)
    return (comm, st.sigma, st.iters, st.dq_sum,
            st.iters * config.gate_fraction, st.comm_fb,
            (group.wire_bytes - wire0) * group.world_size)


def round_body(group: ShardGroup, spec: ShardedGraphSpec, src_l, dst_l, w_l,
               comm, sigma, k, frontier_l, round_ix: int, gate_fraction: int,
               m):
    """One synchronous local-move round of one rank (the reference's
    ``_round_body``): ``MoveEngine.one_round`` over the gather exchange
    (``ShardedScanner``) from (comm, sigma) and the rank's frontier.
    Returns (comm', sigma', frontier', dq), comm and sigma replicated."""
    scanner = ShardedScanner(group, spec, src_l, dst_l, w_l, k, m)
    engine = MoveEngine(scanner, EngineConfig(gate_fraction=gate_fraction))
    zero = torch.zeros(1, dtype=torch.float32, device=k.device)
    live = torch.ones(spec.v_per_shard, dtype=torch.bool, device=k.device)
    st = MoveState(comm, sigma, frontier_l, np.zeros(1, np.int64), zero,
                   zero, live)
    st = engine.one_round(st, frontier_l, round_ix)
    return st.comm, st.sigma, st.frontier, st.dq[0]


def distributed_refine(group: ShardGroup, spec: ShardedGraphSpec, src_l,
                       dst_l, w_l, outer, k, n_live, m, tolerance, *,
                       config: EngineConfig, comm_backend: str = "gather",
                       state_layout: str = "replicated"):
    """The Leiden refinement phase of one rank (``make_distributed_refine``):
    from singletons, the constrained sweep over the cross-outer-masked slots
    inside ``ConstrainedScanner``; ``k``/``m`` stay the full graph's.
    ``n_live`` is the live count of a dense prefix or the (n_pad + 1,) live
    mask of a re-sharded layout.  Returns (comm, iters, dq_sum, rounds,
    fallbacks, wire_bytes)."""
    sent = spec.sentinel
    outer_s = sanitize_outer(outer, n_live, sent)
    # The reference's ConstrainedScanner checks the (sanitized) outer ids
    # eagerly: a stale one fails loudly here.
    assert_outer_sane(outer_s, n_live, sent)
    dst_m, w_m = mask_cross_outer_slots(src_l, dst_l, w_l, outer_s, sent)
    scanner = ConstrainedScanner(
        _scanner_cls(comm_backend, state_layout)(group, spec, src_l, dst_m,
                                                 w_m, k, m),
        outer_s, gate_fraction=config.gate_fraction)
    ids = torch.arange(sent + 1, dtype=torch.int32, device=k.device)
    live_v = valid_ids(ids, n_live, sent)
    comm0 = torch.where(live_v, ids, sent)
    frontier0 = scanner.frontier_valid & live_v[
        torch.clamp(scanner.local_ids, max=sent)]
    wire0 = group.wire_bytes
    st = MoveEngine(scanner, config).run(comm0, k, frontier0, tolerance)
    comm = scanner.resync_comm(st.comm)
    return (comm, st.iters, st.dq_sum, st.iters * config.gate_fraction,
            st.comm_fb, (group.wire_bytes - wire0) * group.world_size)


def sorted_relabelled_slots(src_l, dst_l, w_l, comm, sent: int):
    """A rank's slots relabelled ``(C[src], C[dst], w)`` and put in
    (ci, cj) order by one stable sort (the reference's ``lexsort((cj,
    ci))``): the input of the aggregation's first K3 launch."""
    ci = comm[src_l]
    cj = comm[dst_l]
    key = ci.to(torch.int64) * (sent + 1) + cj.to(torch.int64)
    order = torch.sort(key, stable=True).indices
    return ci[order], cj[order], w_l[order]


def reduce_sorted_slots(s_ci, s_cj, s_w, sent: int, cap: int):
    """One record per group of (ci, cj)-sorted slots, resolved by K3
    (``coarsen_records``) and scattered to positions ``0 .. groups - 1``
    of ``(cap,)`` buffers (padding ``(sent, sent, 0)``); groups at
    positions past ``cap`` are dropped.  Returns (ci, cj, w, groups) with
    ``groups`` a 0-d tensor counting the live groups, dropped ones
    included."""
    emit, pos, r_ci, r_cj, r_w = coarsen_records(s_ci, s_cj, s_w, sent,
                                                 "kernel")
    keep = emit & (pos < cap)
    o_ci, o_cj, o_w = scatter_slots(torch.where(keep, pos, cap), r_ci, r_cj,
                                    r_w, sent, cap)
    return o_ci, o_cj, o_w, emit.to(torch.int32).sum()


def owner_sorted_slots(g_ci, g_cj, g_w, v0: int, v_per: int, sent: int):
    """Of every rank's gathered partial records, the rows this rank owns in
    the coarse partition (``v0 <= ci < v0 + v_per``; the others become
    padding), put in (ci, cj) order: the input of the second K3 launch."""
    mine = (g_ci >= v0) & (g_ci < v0 + v_per)
    m_ci = torch.where(mine, g_ci, sent)
    m_cj = torch.where(mine, g_cj, sent)
    m_w = torch.where(mine, g_w, 0.0)
    key = m_ci.to(torch.int64) * (sent + 1) + m_cj.to(torch.int64)
    order = torch.sort(key, stable=True).indices
    return m_ci[order], m_cj[order], m_w[order]


def distributed_aggregate(group: ShardGroup, spec: ShardedGraphSpec, src_l,
                          dst_l, w_l, comm):
    """Distributed coarsening (``make_distributed_aggregate``): the local
    partial reduce, one ``all_gather`` of the partial records, the
    owner-side re-reduce.  ``comm`` is the renumbered replicated
    membership.  Returns (src_l', dst_l', w_l', e_valid, owned_max): this
    rank's coarse slots in the same ``(e_per_shard,)`` layout (coarse
    vertex v owned by rank v // v_per) and the replicated total and
    largest per-rank count of coarse slots, as host ints.  A rank owning
    more than ``e_per_shard`` drops the excess, and ``owned_max`` shows
    it."""
    o_ci, o_cj, o_w, e_valid, owned_max = aggregate_records(
        group, spec, src_l, dst_l, w_l, comm)
    return o_ci, o_cj, o_w, int(e_valid), int(owned_max)


def aggregate_records(group: ShardGroup, spec: ShardedGraphSpec, src_l,
                      dst_l, w_l, comm):
    """``distributed_aggregate`` with ``e_valid`` and ``owned_max`` left
    as 0-d tensors on the device (the reference's outputs)."""
    v_per, sent = spec.v_per_shard, spec.sentinel
    e_l = src_l.shape[0]
    p_ci, p_cj, p_w, _ = reduce_sorted_slots(
        *sorted_relabelled_slots(src_l, dst_l, w_l, comm, sent), sent, e_l)
    wire = group.all_gather(torch.stack([p_ci, p_cj, p_w.view(torch.int32)]),
                            tiled=False)                  # (S, 3, e_l)
    g_ci = wire[:, 0].reshape(-1)
    g_cj = wire[:, 1].reshape(-1)
    g_w = wire[:, 2].reshape(-1).view(torch.float32)
    v0 = group.shard_index() * v_per
    o_ci, o_cj, o_w, owned = reduce_sorted_slots(
        *owner_sorted_slots(g_ci, g_cj, g_w, v0, v_per, sent), sent, e_l)
    return o_ci, o_cj, o_w, group.psum(owned), group.pmax(owned)


def _vertex_k(group: ShardGroup, spec: ShardedGraphSpec, src_l, w_l):
    """Replicated (n_pad + 1,) K: each rank's owned sums, gathered."""
    v_per, sent = spec.v_per_shard, spec.sentinel
    v0 = group.shard_index() * v_per
    loc = torch.where(src_l >= sent, v_per, src_l - v0).to(torch.int64)
    k_own = segment_sum(w_l, loc, v_per + 1)[:v_per]
    k = group.all_gather(k_own)
    return torch.cat([k, torch.zeros(1, dtype=k.dtype, device=k.device)])


def _total_weight(group: ShardGroup, w_l, n_lanes: int = 1) -> torch.Tensor:
    """Replicated m = sum(w) / 2 (float64 partials in rank order, rounded
    once): 0-d, or one per lane of a ``LaneLayout``'s flat slots."""
    part = torch.stack([torch.sum(x, dtype=torch.float64)
                        for x in w_l.view(n_lanes, -1)])
    m = group.psum(part).to(torch.float32) * 0.5
    return m[0] if n_lanes == 1 else m


def _warm_comm_sigma(mem, k, n_valid):
    """(comm0, sigma0) resuming a move phase from the replicated ``mem``:
    valid vertices without an assignment take their own singleton; Sigma
    comes from the current K.  ``n_valid`` is the live count of a dense
    prefix or the (n_pad + 1,) bool live mask of a re-sharded layout."""
    n_pad = mem.shape[0] - 1
    idx = torch.arange(n_pad + 1, dtype=torch.int32, device=mem.device)
    valid = valid_ids(idx, n_valid, n_pad)
    assigned = torch.where(mem < n_pad, mem.to(torch.int32), idx)
    comm0 = torch.where(valid, assigned, n_pad).to(torch.int32)
    sigma0 = segment_sum(k[:n_pad], comm0[:n_pad], n_pad + 1)
    return comm0, sigma0


def sharded_modularity(group: ShardGroup, src_l, dst_l, w_l, comm) -> float:
    """Q of a replicated (n_pad + 1,) membership on the sharded slots."""
    sent = comm.shape[0] - 1
    internal = torch.sum(torch.where(comm[src_l] == comm[dst_l], w_l, 0.0),
                         dtype=torch.float64).view(1)
    total = torch.sum(w_l, dtype=torch.float64).view(1)
    both = group.psum(torch.cat([internal, total]))
    m = both[1] * 0.5
    src_v = torch.where(src_l >= sent, sent, src_l).to(torch.int64)
    k_part = segment_sum(w_l.to(torch.float64), src_v, sent + 1)
    k = group.psum(k_part)
    sig = segment_sum(k[:sent], torch.clamp(comm[:sent], max=sent), sent + 1)
    sig[sent] = 0.0
    q = both[0] / (2.0 * m) - torch.sum((sig / (2.0 * m)) ** 2)
    return float(q)


def replicated_renumber(comm: torch.Tensor):
    """Dense relabel of a replicated (n_pad + 1,) community array: returns
    (ids, n_comms) with invalid slots and the sentinel at n_pad.  A (T,
    n_pad + 1) stack of such arrays (a fleet bucket's lanes, each in its
    own tenant's ids) is relabelled row by row, with (T,) host counts."""
    n_pad = comm.shape[-1] - 1
    idx = torch.arange(n_pad + 1, device=comm.device)
    valid = (comm < n_pad) & (idx < n_pad)
    cs = torch.where(valid, comm, n_pad).to(torch.int64)
    present = torch.zeros(comm.shape, dtype=torch.int32, device=comm.device)
    present.scatter_(-1, cs, 1)
    present[..., n_pad] = 0
    new_id = torch.cumsum(present, -1, dtype=torch.int32) - present
    counts = present.sum(-1)
    n_comms = int(counts) if comm.dim() == 1 else counts.cpu().numpy()
    new_id[..., n_pad] = n_pad
    return (torch.where(valid, torch.gather(new_id, -1, cs),
                        n_pad).to(torch.int32), n_comms)


def sentinel_forced_membership(global_comm, n_valid, n_pad: int):
    """Replicated (n_pad + 1,) membership from a pass-loop fold, invalid
    slots forced to the layout sentinel; a (T, n_pad + 1) stack takes (T,)
    live counts."""
    dev = global_comm.device
    nv = torch.as_tensor(np.asarray(n_valid, np.int64), device=dev)
    if global_comm.dim() == 2:
        nv = nv[:, None]
    gc = torch.where(torch.arange(n_pad, device=dev) < nv,
                     global_comm[..., :n_pad], n_pad).to(torch.int32)
    return torch.cat([gc, torch.full((*gc.shape[:-1], 1), n_pad,
                                     dtype=torch.int32, device=dev)], -1)


def _gather_host(group: ShardGroup, src_l, dst_l, w_l):
    """Every rank's slots gathered to the host: the global numpy arrays of
    the reference's layout (shard s's slice at ``[s * e_per, (s + 1) *
    e_per)``)."""
    return [group.all_gather(x).cpu().numpy() for x in (src_l, dst_l, w_l)]


def _rebucket_live_host(src_g, dst_g, w_g, old_sent: int,
                        spec_new: ShardedGraphSpec):
    """Re-bucket the live slots of global numpy arrays into ``spec_new``'s
    layout, doubling ``e_per_shard`` until the ownership fits (the
    reference's ``_rebucket_live_host``); returns the global arrays and the
    final spec.  A vertex id beyond the layout raises ``ValueError``."""
    src, dst, w = (np.asarray(x) for x in (src_g, dst_g, w_g))
    live = src < old_sent
    src, dst, w = src[live], dst[live], w[live]
    if len(src) and int(src.max()) >= spec_new.n_pad:
        raise ValueError(
            f"live vertex id {int(src.max())} does not fit the target "
            f"layout (n_pad={spec_new.n_pad})")
    while True:
        try:
            return (*bucket_slots_host(src, dst, w, spec_new), spec_new)
        except ValueError:
            spec_new = spec_new._replace(
                e_per_shard=2 * spec_new.e_per_shard)


def _rebucket_live(group: ShardGroup, src_l, dst_l, w_l, old_sent: int,
                   spec_new: ShardedGraphSpec, host=None):
    """``_rebucket_live_host`` of every rank's slots (``host``: their
    ``_gather_host`` arrays, when the caller has them already); returns this
    rank's slices and the final spec."""
    if host is None:
        host = _gather_host(group, src_l, dst_l, w_l)
    *glob, spec = _rebucket_live_host(*host, old_sent, spec_new)
    return (*rank_slice(*glob, spec, group.shard_index(), src_l.device),
            spec)


def _reshard_relabel(bounds: np.ndarray, v_per: int, n_pad_new: int,
                     old_cap: int) -> np.ndarray:
    """Monotone relabel LUT of a skew-aware owner split: the dense coarse id
    range ``[bounds[s], bounds[s + 1])`` lands on ``[s * v_per, s * v_per +
    width_s)``; everything else (the old sentinel included) maps to
    ``n_pad_new``.  Returns an (old_cap + 1,) int32 array, strictly
    increasing on the live ids, so every ordered reduction keeps its
    order."""
    n_live = int(bounds[-1])
    lut = np.full(old_cap + 1, n_pad_new, np.int64)
    ids = np.arange(n_live)
    owner = np.searchsorted(bounds, ids, side="right") - 1
    lut[:n_live] = owner * v_per + (ids - bounds[owner])
    return lut.astype(np.int32)


def _reshard_coarse_host(src_g, dst_g, w_g, old_sent: int, plan):
    """Apply a ``ReshardPlan`` to the global numpy arrays of a coarse
    graph: both endpoints of every live slot go through the LUT and the
    slots re-bucket into the balanced layout.  Returns ``(src', dst', w',
    spec', lut, live_mask)``; ``live_mask`` is the (n_pad' + 1,) bool mask
    of live ids in the gappy layout."""
    n_shards = len(plan.bounds) - 1
    spec_new = ShardedGraphSpec(n_shards, plan.v_per_shard, plan.e_per_shard,
                                n_shards * plan.v_per_shard)
    lut = _reshard_relabel(plan.bounds, plan.v_per_shard, spec_new.n_pad,
                           old_sent)
    src, dst, w = (np.asarray(x) for x in (src_g, dst_g, w_g))
    live = src < old_sent
    out = bucket_slots_host(lut[src[live]], lut[dst[live]], w[live],
                            spec_new)
    live_mask = np.zeros(spec_new.n_pad + 1, bool)
    live_mask[lut[:int(plan.bounds[-1])]] = True
    return (*out, spec_new, lut, live_mask)


def boundary_frac(group: ShardGroup, spec: ShardedGraphSpec, src_l, dst_l,
                  n_live: int) -> float:
    """``measure_boundary_frac`` of the slots spread over the ranks: each
    rank counts its owned vertices with a cross-rank slot, and the integer
    counts are summed."""
    v0 = group.shard_index() * spec.v_per_shard
    n_bnd = boundary_mask(src_l, dst_l, v0, spec.v_per_shard,
                          spec.sentinel).sum(dtype=torch.int64).view(1)
    return int(group.psum(n_bnd)) / max(int(n_live), 1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sharded_louvain_passes(
    group: ShardGroup, src_l, dst_l, w_l, spec: ShardedGraphSpec,
    n_live: int, *, init_membership=None, init_frontier=None,
    max_passes: int = 10, max_iterations: int = 20,
    initial_tolerance: float = 0.01, tolerance_drop: float = 10.0,
    aggregation_tolerance: float = 0.8, gate_fraction: int = 2,
    use_pruning: bool = True, use_ladder: bool = False,
    comm_backend: str = "gather", state_layout: str = "replicated",
    refine: str = "none", reshard: str = "none",
    pipeline_fetch: bool = False, regrow: bool = True):
    """The host pass loop on one rank's slots (the reference's
    ``sharded_louvain_passes``), run by every rank in lockstep.

    ``init_membership`` / ``init_frontier`` ((n_pad + 1,) replicated)
    warm-start pass 0; later passes restart from singletons on the coarse
    graph (with ``refine="leiden"``, from the outer partition on it).  The
    rank's slots are never changed in place (aggregation makes new ones),
    so a streaming caller keeps them resident.  With ``use_ladder`` coarse
    graphs re-bucket down to the power-of-two tier that fits them.  An
    aggregation that overflows ``e_per_shard`` is retried with ``regrow``:
    first the owner map shrinks to the tier that fits the live vertices
    (not on a re-sharded layout), then ``e_per_shard`` grows; without
    ``regrow`` it raises ``AggregationOverflow``.

    ``reshard="auto"`` checks, after each aggregation on more than one
    rank, the coarse edge load per rank under the uniform owner map
    (``plan_reshard``); above the threshold the coarse ids are relabelled
    onto balanced blocks (``_reshard_coarse_host``) in place of the ladder
    tier, the fold and the Leiden warm start go through the same LUT, and
    the next pass carries the layout's live mask.  The ladder and the
    re-shard share one gather of the coarse graph to the host.

    ``comm_backend`` / ``state_layout`` are the concrete exchange and
    layout.  ``pipeline_fetch`` runs the next aggregation before the pass's
    stop decision is read (the reference's dispatch order; the same
    results).

    Returns (membership (n_pad,), n_communities, stats): the rows carry the
    reference's columns (``comm_backend``, ``comm_rounds``,
    ``comm_fallback_rounds``, ``comm_bytes``, ``state_layout``,
    ``halo_bytes``, ``boundary_frac``, ``reshard``, ``reshard_bytes``,
    ``max_shard_load_frac_before`` / ``_after``, ``seconds``, ...) and
    ``phase_seconds``, the pass's local-move, refine and aggregate times.
    The port adds ``wire_bytes``: the bytes the pass's move and refine
    phases handed to the collectives, over all ranks, where ``comm_bytes``
    keeps the reference's price of the same rounds.  Per rank and round the
    wire exceeds the price by ``4 * (n_pad + 1)`` B in a replicated gather
    round and in every fallback round (Sigma's add and sub travel as two
    dense arrays; in a hybrid fallback the size deltas are the extra
    array), by ``4 * touched_cap`` B in every hybrid round (add and sub as
    two float32 lanes per touched community), and by nothing in a delta
    round; a hybrid Leiden pass also ships its refine phase's resync
    (``4 * v_per`` B a rank), which the price counts once a pass.
    """
    if refine not in ("none", "leiden"):
        raise ValueError(f"refine must be 'none' or 'leiden', got {refine!r}")
    reshard_on = resolve_reshard(reshard) == "auto"
    refine_on = refine == "leiden"
    config = EngineConfig(max_iterations=max_iterations,
                          use_pruning=use_pruning,
                          gate_fraction=gate_fraction)
    dev = src_l.device
    phase = dict(config=config, comm_backend=comm_backend,
                 state_layout=state_layout)

    n_pad, sent = spec.n_pad, spec.sentinel
    global_comm = torch.arange(n_pad, dtype=torch.int32, device=dev)
    report_comm = global_comm
    tol = float(initial_tolerance)
    stats = []
    n_report = n_live
    leiden_warm = None
    live = None          # None: a dense prefix [0, n_live); else a mask
    for p in range(max_passes):
        t_pass0 = time.perf_counter()
        # The live-vertex operand of the warm start, the refine sweep and
        # the Leiden fold: the count, or the mask of a re-sharded layout.
        nv = n_live if live is None else live
        k = _vertex_k(group, spec, src_l, w_l)
        m = _total_weight(group, w_l)
        ones_frontier = torch.ones(sent + 1, dtype=torch.bool, device=dev)
        if p == 0 and init_membership is not None:
            comm0, sigma0 = _warm_comm_sigma(init_membership, k, nv)
            frontier0 = (ones_frontier if init_frontier is None
                         else init_frontier)
        elif leiden_warm is not None:
            comm0, sigma0 = _warm_comm_sigma(leiden_warm, k, nv)
            frontier0 = ones_frontier
        else:
            idx = torch.arange(sent + 1, dtype=torch.int32, device=dev)
            comm0 = torch.where(valid_ids(idx, nv, sent), idx, sent)
            sigma0 = k
            frontier0 = ones_frontier
        comm, _, iters, dq_sum, rounds, fallbacks, wire = distributed_move(
            group, spec, src_l, dst_l, w_l, comm0, sigma0, k, frontier0, m,
            tol, **phase)
        _sync(dev)
        t_move = time.perf_counter()
        refine_iters = None
        outer_ren = None
        rounds_extra = fb_extra = 0
        if refine_on:
            (refined, refine_iters, _, r_rounds, r_fb,
             r_wire) = distributed_refine(
                group, spec, src_l, dst_l, w_l, comm, k, nv, m, tol,
                **phase)
            outer_ren, n_outer = replicated_renumber(comm)
            comm_ren, n_comms = replicated_renumber(refined)
            rounds_extra, fb_extra = r_rounds, r_fb
            wire += r_wire
        else:
            comm_ren, n_comms = replicated_renumber(comm)
        _sync(dev)
        t_refine = time.perf_counter()
        pending_agg = None
        if pipeline_fetch and p < max_passes - 1:
            pending_agg = distributed_aggregate(group, spec, src_l, dst_l,
                                                w_l, comm_ren)
        if refine_on:
            report_comm = outer_ren[torch.clamp(global_comm, max=sent)]
            n_report = n_outer
        global_comm = comm_ren[torch.clamp(global_comm, max=sent)]
        if not refine_on:
            report_comm = global_comm
            n_report = n_comms
        rounds_i = rounds + rounds_extra
        fb_i = fallbacks + fb_extra
        plan = sharded_comm_plan(spec, comm_backend, state_layout)
        stats.append({"iterations": iters, "n_communities": n_report,
                      "n_vertices": n_live, "n_pad": sent,
                      "e_per_shard": spec.e_per_shard,
                      "dq_sum": float(dq_sum),
                      "comm_backend": comm_backend,
                      "comm_rounds": rounds_i,
                      "comm_fallback_rounds": fb_i,
                      "comm_bytes": phase_bytes(plan, rounds_i, fb_i),
                      "wire_bytes": wire,
                      "state_layout": state_layout,
                      "halo_bytes": plan.halo_round_bytes * rounds_i,
                      "boundary_frac": (
                          boundary_frac(group, spec, src_l, dst_l, n_live)
                          if state_layout == "hybrid" else None),
                      "seconds": time.perf_counter() - t_pass0,
                      "refine_iterations": refine_iters,
                      "n_refined": n_comms if refine_on else None,
                      "reshard": False, "reshard_bytes": 0,
                      "max_shard_load_frac_before": None,
                      "max_shard_load_frac_after": None,
                      "phase_seconds": {"local_move": t_move - t_pass0,
                                        "refine": t_refine - t_move,
                                        "aggregate": 0.0}})
        converged = iters <= 1
        low_shrink = n_report / max(n_live, 1) > aggregation_tolerance
        if converged or low_shrink or p == max_passes - 1:
            break
        t_agg = time.perf_counter()
        if refine_on:
            # Outer-on-coarse warm start, before any owner-map change:
            # coarse ids [0, n_comms) whatever the next layout.
            warm_flat = _leiden_warm_membership(
                comm_ren, outer_ren, nv, n_comms)[:n_comms].cpu().numpy()
        while True:
            if pending_agg is not None:
                a_src, a_dst, a_w, e_valid, owned = pending_agg
                pending_agg = None
            else:
                a_src, a_dst, a_w, e_valid, owned = distributed_aggregate(
                    group, spec, src_l, dst_l, w_l, comm_ren)
            if owned <= spec.e_per_shard:
                src_l, dst_l, w_l = a_src, a_dst, a_w
                break
            if not regrow:
                raise AggregationOverflow(owned, spec.e_per_shard)
            # Community skew: coarse ids form a dense prefix that an owner
            # map sized for the original vertex range parks on the first
            # ranks.  Shrink the owner map first (a re-sharded layout's
            # live ids are not a prefix: only the edges grow there), then
            # grow e_per_shard.
            old_sent = spec.sentinel
            v_tight = _pow2_at_least(-(-n_live // spec.n_shards))
            if live is None and v_tight < spec.v_per_shard:
                tier = ShardedGraphSpec(spec.n_shards, v_tight,
                                        spec.e_per_shard,
                                        spec.n_shards * v_tight)
            else:
                tier = spec._replace(e_per_shard=_pow2_at_least(
                    max(owned, 2 * spec.e_per_shard)))
            src_l, dst_l, w_l, spec = _rebucket_live(
                group, src_l, dst_l, w_l, old_sent, tier)
            if spec.sentinel != old_sent:
                # Rewrite the renumbered membership that feeds the retried
                # aggregation into the new sentinel space.
                sent = spec.sentinel
                body = comm_ren[:spec.n_pad]
                ids = torch.arange(spec.n_pad, device=dev)
                comm_ren = torch.cat([
                    torch.where(ids < n_live, torch.clamp(body, max=sent),
                                sent).to(torch.int32),
                    torch.full((1,), sent, dtype=torch.int32, device=dev)])
        host = None         # the coarse graph on the host, gathered once
        resharded = False
        if reshard_on and spec.n_shards > 1:
            host = _gather_host(group, src_l, dst_l, w_l)
            counts = np.bincount(host[0][host[0] < spec.sentinel],
                                 minlength=max(n_comms, 1))
            if use_ladder:
                n_new, _ = resolve_coarse_capacity(
                    n_comms, e_valid, spec.n_pad,
                    spec.e_per_shard * spec.n_shards)
                v_uniform = -(-n_new // spec.n_shards)
            else:
                v_uniform = spec.v_per_shard
            rplan = plan_reshard(counts, spec.n_shards, v_uniform)
            if rplan is not None:
                old_sent = spec.sentinel
                cost = reshard_bytes(spec.n_shards * spec.e_per_shard,
                                     spec.n_shards * rplan.e_per_shard)
                *glob, spec, lut, live_mask = _reshard_coarse_host(
                    *host, old_sent, rplan)
                src_l, dst_l, w_l = rank_slice(*glob, spec,
                                               group.shard_index(), dev)
                sent = spec.sentinel
                # The fold (values) and the Leiden warm start (index and
                # values) go through the same monotone LUT.
                lut_t = torch.from_numpy(lut).to(dev)
                global_comm = lut_t[torch.clamp(global_comm, max=old_sent)]
                if refine_on:
                    warm = np.full(spec.n_pad + 1, sent, np.int32)
                    warm[lut[:n_comms]] = lut[warm_flat]
                    leiden_warm = torch.from_numpy(warm).to(dev)
                live = torch.from_numpy(live_mask).to(dev)
                resharded = True
                stats[-1].update(
                    reshard=True, reshard_bytes=cost,
                    max_shard_load_frac_before=rplan.load_frac_before,
                    max_shard_load_frac_after=rplan.load_frac_after,
                    comm_bytes=phase_bytes(plan, rounds_i, fb_i,
                                           reshard_cost=cost))
        if not resharded:
            # Aggregation emits dense coarse ids: a dense prefix again.
            live = None
        if use_ladder and not resharded:
            n_new, e_new = resolve_coarse_capacity(
                n_comms, e_valid, spec.n_pad,
                spec.e_per_shard * spec.n_shards)
            if (n_new, e_new) != (spec.n_pad,
                                  spec.e_per_shard * spec.n_shards):
                old_sent = spec.sentinel
                e_tier = _pow2_at_least(max(
                    -(-e_new // spec.n_shards), int(owned * LADDER_SLACK), 1))
                v_new = -(-n_new // spec.n_shards)
                tier = ShardedGraphSpec(spec.n_shards, v_new, e_tier,
                                        spec.n_shards * v_new)
                if tier != spec:
                    src_l, dst_l, w_l, spec = _rebucket_live(
                        group, src_l, dst_l, w_l, old_sent, tier, host)
                    sent = spec.sentinel
        if refine_on and not resharded:
            leiden_warm = torch.from_numpy(
                pad_membership(warm_flat, spec.n_pad)).to(dev)
        n_live = n_comms
        _sync(dev)
        stats[-1]["phase_seconds"]["aggregate"] = time.perf_counter() - t_agg
        stats[-1]["seconds"] = time.perf_counter() - t_pass0
        tol /= tolerance_drop
    return report_comm, n_report, stats


def distributed_louvain(
    graph: CSRGraph, group: ShardGroup, *, max_passes: int = 10,
    max_iterations: int = 20, initial_tolerance: float = 0.01,
    tolerance_drop: float = 10.0, aggregation_tolerance: float = 0.8,
    gate_fraction: int = 2, use_pruning: bool = True, init_membership=None,
    init_frontier=None, e_per_shard: Optional[int] = None,
    use_ladder: bool = True, comm_backend: str = "auto",
    state_layout: str = "replicated", refine: str = "none",
    reshard: str = "none", pipeline_fetch: bool = False):
    """End-to-end sharded GVE-Louvain on one rank of ``group``; every rank
    of the group calls it with the same graph and arguments.

    The reference's ``distributed_louvain`` with a ``ShardGroup`` in place
    of ``(mesh, axes)``.  ``graph`` may lie on any device: its slots are
    partitioned on the host and this rank's slice moves to
    ``group.device``.  ``comm_backend`` ("gather" | "delta" | "auto": delta
    on more than one rank) and ``state_layout`` ("replicated" | "hybrid" |
    "auto": hybrid on more than one rank when the measured boundary
    fraction is at most ``HYBRID_BOUNDARY_FRAC_MAX``) never change a
    membership.  ``reshard="auto"`` re-balances the coarse owner ranges by
    measured load after each aggregation (a no-op on one rank and on
    balanced graphs); it renames the coarse vertices, so the round gate
    and the labels can differ from ``reshard="none"``'s, as in the
    reference (whose contract for it is quality parity).

    Returns (membership (n,) numpy, n_communities, pass_stats).
    """
    n_shards = group.world_size
    cb = resolve_comm_backend(comm_backend, n_shards)
    resolve_reshard(reshard)
    src_g, dst_g, w_g, spec = partition_graph_host(
        graph, n_shards, e_per_shard=e_per_shard)
    n = int(graph.n_valid)
    sl = resolve_state_layout(
        state_layout, n_shards,
        boundary_frac=(measure_boundary_frac(src_g, dst_g, spec, n)
                       if state_layout == "auto" and n_shards > 1
                       else None))
    dev = group.device
    src_l, dst_l, w_l = rank_slice(src_g, dst_g, w_g, spec,
                                   group.shard_index(), dev)
    del src_g, dst_g, w_g
    mem0 = fr0 = None
    if init_membership is not None:
        mem = np.minimum(np.asarray(init_membership, np.int64),
                         spec.n_pad).astype(np.int32)[:spec.n_pad]
        mem0 = torch.from_numpy(pad_membership(mem, spec.n_pad)).to(dev)
    if init_frontier is not None:
        fr = np.zeros(spec.n_pad + 1, bool)
        src_fr = np.asarray(init_frontier, bool)
        fr[: min(len(src_fr), spec.n_pad)] = src_fr[: spec.n_pad]
        fr0 = torch.from_numpy(fr).to(dev)
    global_comm, _, stats = sharded_louvain_passes(
        group, src_l, dst_l, w_l, spec, n, init_membership=mem0,
        init_frontier=fr0, max_passes=max_passes,
        max_iterations=max_iterations, initial_tolerance=initial_tolerance,
        tolerance_drop=tolerance_drop,
        aggregation_tolerance=aggregation_tolerance,
        gate_fraction=gate_fraction, use_pruning=use_pruning,
        use_ladder=use_ladder, comm_backend=cb, state_layout=sl,
        refine=refine, reshard=reshard, pipeline_fetch=pipeline_fetch)
    membership = global_comm[:n].cpu().numpy()
    return membership, int(len(np.unique(membership))), stats


# ---------------------------------------------------------------------------
# A rank's entry for ``collectives.launch`` (JAX-free, so spawned ranks
# import only the port).
# ---------------------------------------------------------------------------

def rank_runs(group: ShardGroup, graphs: dict, runs: list) -> dict:
    """Run ``distributed_louvain`` on this rank for each ``(name, kwargs)``
    of ``runs``, on ``graphs[name]``: a dict of the ``CSRGraph`` buffers as
    numpy arrays (``indptr``, ``indices``, ``weights``, ``src``,
    ``n_valid``, ``e_valid``).  A run whose kwargs hold ``"expect"`` (an
    exception class name) must raise it; its result is the message.  A run
    whose kwargs hold ``"regrow"`` calls the pass loop with it on the
    partitioned graph (``regrow=False``: no overflow retry).  A run whose
    kwargs hold ``"batches"`` (``EdgeBatch`` buffer dicts: ``src``,
    ``dst``, ``weight``, ``b_valid``) streams them through
    ``louvain_dynamic_sharded``, with ``"config"`` a dict of
    ``LouvainConfig`` fields; its result is the ``ShardedDynamicResult``.
    A run whose kwargs hold ``"tenants"`` serves a fleet through
    ``serve_fleet``: each tenant id maps to ``{"graph": name, "batches":
    [...], "prev": membership or None}``, with ``"config"`` as above and
    ``serve_fleet``'s other keywords; its result is the ``FleetResult``.
    Returns ``{"results": [...], "staged_bytes", "collectives",
    "branch_reads"}``."""
    from repro_torch.core.distributed_dynamic import louvain_dynamic_sharded
    from repro_torch.core.fleet import serve_fleet
    from repro_torch.interop import (config_from_dict, edge_batch_from_numpy,
                                     graph_from_numpy)

    def batches_of(dicts):
        return [edge_batch_from_numpy(**b, device=group.device)
                for b in dicts]

    def run(g, kwargs):
        if "tenants" in kwargs:
            tenants = kwargs.pop("tenants")
            config = config_from_dict(kwargs.pop("config", {}))
            return serve_fleet(
                {tid: graph_from_numpy(**graphs[t["graph"]],
                                       device=group.device)
                 for tid, t in tenants.items()},
                {tid: batches_of(t["batches"]) for tid, t in tenants.items()},
                group, {tid: t["prev"] for tid, t in tenants.items()
                        if t.get("prev") is not None}, config, **kwargs)
        if "batches" in kwargs:
            batches = batches_of(kwargs.pop("batches"))
            config = config_from_dict(kwargs.pop("config", {}))
            return louvain_dynamic_sharded(g, group, batches, config=config,
                                           **kwargs)
        if "regrow" not in kwargs:
            return distributed_louvain(g, group, **kwargs)
        *glob, spec = partition_graph_host(g, group.world_size)
        sl = rank_slice(*glob, spec, group.shard_index(), group.device)
        cb = resolve_comm_backend(kwargs.pop("comm_backend", "auto"),
                                  group.world_size)
        return sharded_louvain_passes(group, *sl, spec, g.n_valid,
                                      comm_backend=cb, use_ladder=True,
                                      **kwargs)

    out = []
    for name, kwargs in runs:
        kwargs = dict(kwargs)
        expect = kwargs.pop("expect", None)
        g = graph_from_numpy(**graphs[name], device=group.device)
        if expect is None:
            out.append(run(g, kwargs))
            continue
        try:
            run(g, kwargs)
        except Exception as exc:  # noqa: BLE001 — checked by name
            if type(exc).__name__ != expect:
                raise
            out.append(str(exc))
        else:
            raise AssertionError(f"{name} {kwargs}: {expect} not raised")
    return {"results": out, "staged_bytes": group.staged_bytes,
            "collectives": group.collectives,
            "branch_reads": group.branch_reads}
