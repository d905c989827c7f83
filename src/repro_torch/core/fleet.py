"""Multi-tenant sharded serving fleet of the PyTorch port
(``repro.core.fleet``): every tenant graph is vertex-partitioned across the
ranks of a ``ShardGroup`` AND the tenants of one capacity envelope advance
together, one dispatch per bucket and stream step.

  * **Bucketed capacity envelopes.**  ``FleetRouter.admit`` places a tenant
    in its power-of-two ``(v_per_shard, e_per_shard, b_cap)`` envelope
    (``configs.louvain_arch.fleet_envelope``); the tenants of one envelope
    form a bucket.  A whale tenant that overflows its envelope migrates to
    the grown envelope's bucket (``migrate_envelope``): its pre-apply slots
    grow on the card, the overflowing step is replayed for it alone exactly
    once, its old lane freezes and it joins (or founds) the bucket of its
    new envelope, leaving its cohabitants untouched.
  * **Lanes on each rank.**  The reference vmaps its shard_map'd step over
    a bucket's tenants; torch has no vmap over a process group, so a
    bucket's tenants run as the lanes of one flat sharded layout
    (``core.distributed.LaneLayout``).  The step is the solo streaming
    step's own code run over lanes: ``sharded_batch_apply`` (one slot-list
    build, one stable key sort and ONE K4 launch per rank for all lanes,
    then each lane's records into its own block), ``affected_frontier``,
    and pass 0 of ``sharded_louvain_passes`` (K, per-lane m, the warm
    start, ``distributed_move`` over the lanes, per-lane renumbering).  A
    lane is each one of the engine's streams: its own m, dQ, tolerance,
    stop, Weyl gate ids and exchange caps, so it computes what its tenant
    computes alone.  A one-lane bucket is the solo path.
  * **Accept or replay.**  A lane is accepted when its tenant alone would
    stop after pass 0 (converged, low shrink, or ``max_passes == 1``);
    otherwise the solo pass loop (``sharded_louvain_passes``, the very call
    ``louvain_dynamic_sharded`` makes) replays it from its pre-step
    membership, which reproduces pass 0 bit for bit and continues.

**Correctness bar**: every tenant's membership equals, bit for bit, the one
``louvain_dynamic_sharded`` gives it alone on the same group.

**Dispatch order and ``"auto"`` screening.**  The reference dispatches step
t of every bucket before it validates step t - 1, so step t resolves
``"auto"`` (on the host, per bucket: ``engine.resolve_screening_host``) from
the worst touched fraction validated through step t - 2; steps 0 and 1 see
no measurement (``"community"``, flagged as downgraded); a bucket
redispatched after a replay or a migration join sees step t - 1's, and a
newly founded bucket inherits its source's.  The port's engine reads its
stop on the host every sweep anyway, so it validates each step before it
dispatches the next and dispatches nothing speculatively; it keeps, per
bucket, the measurement the reference's speculative dispatch would have
seen, so its recorded modes, and so its memberships, are the reference's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.louvain_arch import (FleetEnvelope, fleet_envelope,
                                              fleet_v_per_shard,
                                              migrate_envelope,
                                              resolve_apply_backend,
                                              resolve_comm_backend,
                                              resolve_state_layout)
from repro_torch.core.collectives import ShardGroup
from repro_torch.core.comm import phase_bytes
from repro_torch.core.delta import EdgeBatch, FleetBatch
from repro_torch.core.distributed import (LaneLayout, ShardedGraphSpec,
                                          _total_weight, _vertex_k,
                                          _warm_comm_sigma,
                                          distributed_move,
                                          measure_boundary_frac,
                                          partition_graph_host, rank_slice,
                                          replicated_renumber,
                                          sentinel_forced_membership,
                                          sharded_comm_plan,
                                          sharded_louvain_passes)
from repro_torch.core.distributed_dynamic import (_grow_slots,
                                                  sharded_batch_apply)
from repro_torch.core.engine import (EngineConfig, affected_frontier,
                                     normalize_screening,
                                     resolve_screening_host)
from repro_torch.core.graph import CSRGraph
from repro_torch.core.louvain import LouvainConfig, PassStats, pad_membership

__all__ = ["FleetResult", "FleetRouter", "serve_fleet"]


def _fleet_spec(env: FleetEnvelope, n_shards: int) -> ShardedGraphSpec:
    return ShardedGraphSpec(n_shards, env.v_per_shard, env.e_per_shard,
                            env.v_per_shard * n_shards)


@dataclasses.dataclass
class _Tenant:
    """One tenant on this rank: its slots (this rank's slices, in its own
    ids) and replicated membership in its envelope's layout."""

    tid: str
    n_cap: int                  # logical vertex capacity (CSR n_cap)
    env: FleetEnvelope
    src: torch.Tensor           # (e_per_shard,) this rank's slots
    dst: torch.Tensor
    w: torch.Tensor
    mem: torch.Tensor           # (n_pad + 1,) replicated membership
    n_valid: int
    stats: List[PassStats] = dataclasses.field(default_factory=list)
    migrations: List[dict] = dataclasses.field(default_factory=list)
    n_fallbacks: int = 0
    #: Boundary fraction of the admitted partition: drives the per-bucket
    #: state_layout="auto" resolution (the worst lane wins).
    boundary_frac: Optional[float] = None


@dataclasses.dataclass(eq=False)
class _Bucket:
    """One capacity envelope's lanes during a serve call."""

    env: FleetEnvelope
    spec: ShardedGraphSpec
    lanes: List[_Tenant]
    state_layout: str = "replicated"       # resolved for this bucket
    frozen: set = dataclasses.field(default_factory=set)  # migrated away
    #: The worst touched fraction of the last validated step, and the one
    #: before it: what the reference's next speculative dispatch sees.
    touched_frac: Optional[float] = None
    seen_frac: Optional[float] = None


@dataclasses.dataclass
class _Step:
    """One bucket dispatch, run and waiting for its validation."""

    bucket: _Bucket
    t: int
    act: List[int]              # lanes with a live batch, in lane order
    pre: list                   # per lane: (src, dst, w, mem, n_valid)
    post: list                  # per lane: (src, dst, w, mem) after it
    frontier: Optional[torch.Tensor]   # (T, n_pad) seed frontiers
    batch: FleetBatch           # the lanes' batches as dispatched
    mode: Optional[str]         # screening mode the step ran with
    downgraded: bool
    seconds: float
    scalars: dict               # (T,) host arrays
    wire_bytes: int


@dataclasses.dataclass
class FleetResult:
    """Per-tenant results of one ``FleetRouter.serve`` call."""

    membership: Dict[str, np.ndarray]
    n_communities: Dict[str, int]
    pass_stats: Dict[str, List[PassStats]]
    total_seconds: float
    #: Bucket dispatches that ran a step (one per bucket and step with a
    #: live batch).  The reference also counts the speculative dispatches
    #: it replaces after a replay or a migration join and those of buckets
    #: whose lanes are all idle; the port makes neither.
    n_dispatches: int = 0
    n_fallbacks: int = 0        # lanes replayed through the solo pass loop
    n_migrations: int = 0       # whale bucket migrations
    bytes_on_wire: int = 0      # priced move-phase exchange bytes
    comm_rounds: int = 0
    comm_backend: str = "gather"
    #: Envelope -> tenant ids, the bucket layout at the END of the serve.
    buckets: Dict[FleetEnvelope, List[str]] = dataclasses.field(
        default_factory=dict)
    #: Per-bucket resolved working-state layout; ``state_layout`` is the
    #: fleet-level summary ("mixed" when buckets disagree under "auto").
    bucket_layouts: Dict[FleetEnvelope, str] = dataclasses.field(
        default_factory=dict)
    state_layout: str = "replicated"
    halo_bytes: int = 0         # boundary-mover share of bytes_on_wire
    #: Worst admitted boundary fraction across the served tenants.
    boundary_frac: Optional[float] = None
    #: The bytes the move phases handed to the collectives, over all ranks:
    #: every dispatch's lanes and every replay pass (``bytes_on_wire``
    #: keeps the reference's price).
    wire_bytes: int = 0
    #: Per step, host seconds of the buckets' applies (each ending in its
    #: host read of the counts) and of the rest of the step (screening,
    #: move phase, renumbering, replays, migrations).
    apply_seconds: List[float] = dataclasses.field(default_factory=list)
    update_seconds: List[float] = dataclasses.field(default_factory=list)

    @property
    def bytes_per_dispatch(self) -> float:
        return self.bytes_on_wire / max(self.n_dispatches, 1)

    @property
    def halo_bytes_per_round(self) -> float:
        return self.halo_bytes / max(self.comm_rounds, 1)


class FleetRouter:
    """Admission and routing of the multi-tenant sharded serving fleet on
    one rank of ``group``; every rank makes the same calls with the same
    arguments.

    ``admit`` places each tenant in its envelope; ``serve`` advances every
    tenant's stream with one dispatch per bucket and step (see the module
    docstring for the parity contract).  ``screening`` takes the usual
    modes; ``"auto"`` (the default) is resolved on the host per bucket and
    recorded, with its downgrade flag, in each tenant's ``PassStats``.
    ``config.refine`` must stay ``"none"``: refinement runs inside every
    solo pass, pass 0 included, which the fleet step does not reproduce.
    ``apply_backend``: ``"auto"`` (K4 on the card, the sort chain on the
    CPU), ``"kernel"`` or ``"sort"``.
    """

    def __init__(self, group: ShardGroup,
                 config: LouvainConfig = LouvainConfig(), *,
                 screening="auto", apply_backend: str = "auto"):
        if config.refine != "none":
            raise ValueError("FleetRouter requires config.refine='none' "
                             "(refinement changes pass 0, which the fleet "
                             "step must reproduce bit for bit)")
        self.group = group
        self.config = config
        self.n_shards = group.world_size
        self.screen_req = normalize_screening(screening)
        self.comm_backend = resolve_comm_backend(config.comm_backend,
                                                 self.n_shards)
        resolve_apply_backend(apply_backend, group.device)
        self.apply_backend = apply_backend
        self.tenants: Dict[str, _Tenant] = {}
        self._engine = EngineConfig(max_iterations=config.max_iterations,
                                    use_pruning=config.use_pruning,
                                    gate_fraction=config.gate_fraction)
        self._buckets: List[_Bucket] = []

    # -- admission ---------------------------------------------------------

    def admit(self, tid: str, graph: CSRGraph,
              prev: Optional[np.ndarray] = None,
              b_cap: int = 1) -> FleetEnvelope:
        """Admit a tenant: partition it into its envelope's layout and warm
        it up.  ``b_cap`` is the largest per-step batch capacity its
        streams will carry (rounded up to a power of two).  ``prev=None``
        runs one cold solo pass loop for the resident membership (the
        machinery ``louvain_dynamic_sharded`` uses, so a later solo run
        from the same ``prev`` matches bit for bit)."""
        if tid in self.tenants:
            raise ValueError(f"tenant {tid!r} already admitted")
        v_per = fleet_v_per_shard(graph.n_cap, self.n_shards)
        n_pad = v_per * self.n_shards
        # The first partition measures the worst owned-slot count; the
        # second lands directly in the envelope's slot layout.
        _, _, _, spec0 = partition_graph_host(graph, self.n_shards,
                                              n_target=n_pad)
        env = fleet_envelope(graph.n_cap, spec0.e_per_shard, b_cap,
                             self.n_shards)
        spec = _fleet_spec(env, self.n_shards)
        src_g, dst_g, w_g, spec2 = partition_graph_host(
            graph, self.n_shards, n_target=n_pad,
            e_per_shard=env.e_per_shard)
        assert spec2 == spec, (spec2, spec)
        n_live = int(graph.n_valid)
        bfrac = measure_boundary_frac(src_g, dst_g, spec, n_live)
        dev = self.group.device
        src, dst, w = rank_slice(src_g, dst_g, w_g, spec,
                                 self.group.shard_index(), dev)
        del src_g, dst_g, w_g
        if prev is None:
            mem, _, _ = self._run_solo_passes(
                spec, src, dst, w, n_live,
                state_layout=resolve_state_layout(
                    self.config.state_layout, self.n_shards, bfrac))
        else:
            mem = torch.from_numpy(pad_membership(
                np.asarray(prev, np.int32)[:spec.n_pad], spec.n_pad)).to(dev)
        self.tenants[tid] = _Tenant(tid=tid, n_cap=graph.n_cap, env=env,
                                    src=src, dst=dst, w=w, mem=mem,
                                    n_valid=n_live, boundary_frac=bfrac)
        return env

    def _run_solo_passes(self, spec, src, dst, w, n_live,
                         init_membership=None, init_frontier=None,
                         state_layout: Optional[str] = None):
        """The solo pass loop at this router's knobs: admission cold starts,
        replays and migrations all run it, the very call
        ``louvain_dynamic_sharded`` makes.  ``state_layout`` is the
        caller's resolved per-bucket (or per-admission) layout;
        memberships do not depend on it."""
        cfg = self.config
        layout = (state_layout if state_layout is not None
                  else resolve_state_layout(cfg.state_layout, self.n_shards))
        gc, nc, rows = sharded_louvain_passes(
            self.group, src, dst, w, spec, n_live,
            init_membership=init_membership, init_frontier=init_frontier,
            max_passes=cfg.max_passes, max_iterations=cfg.max_iterations,
            initial_tolerance=cfg.initial_tolerance,
            tolerance_drop=cfg.tolerance_drop,
            aggregation_tolerance=cfg.aggregation_tolerance,
            gate_fraction=cfg.gate_fraction, use_pruning=cfg.use_pruning,
            use_ladder=cfg.use_ladder, comm_backend=self.comm_backend,
            state_layout=layout, refine="none", reshard=cfg.reshard,
            pipeline_fetch=cfg.pipeline_fetch)
        return sentinel_forced_membership(gc, n_live, spec.n_pad), nc, rows

    # -- serving -----------------------------------------------------------

    def serve(self, streams: Dict[str, Sequence[EdgeBatch]]) -> FleetResult:
        """Advance every tenant's stream: one dispatch per bucket and step,
        each step validated before the next is dispatched."""
        t_start = time.perf_counter()
        for tid in streams:
            if tid not in self.tenants:
                raise ValueError(f"tenant {tid!r} not admitted")
        n_steps = max((len(s) for s in streams.values()), default=0)

        self._n_dispatches = self._n_fallbacks = self._n_migrations = 0
        self._bytes = self._rounds = self._halo = self._wire = 0
        self._apply_s = [0.0] * n_steps
        self._update_s = [0.0] * n_steps
        by_env: Dict[FleetEnvelope, List[_Tenant]] = {}
        for tid in streams:
            ten = self.tenants[tid]
            by_env.setdefault(ten.env, []).append(ten)
        # Layout per bucket: "auto" takes the WORST admitted boundary
        # fraction over the bucket's lanes, so hybrid engages only when
        # every cohabitant tenant is interior-dominated.
        self._buckets = [
            _Bucket(env, _fleet_spec(env, self.n_shards), tenants,
                    resolve_state_layout(
                        self.config.state_layout, self.n_shards,
                        max((t.boundary_frac for t in tenants
                             if t.boundary_frac is not None),
                            default=None)))
            for env, tenants in by_env.items()]

        steps: List[Optional[_Step]] = []
        for t in range(n_steps):
            redo = self._validate(steps) if steps else []
            steps = [self._dispatch(B, t, streams, fresh=B in redo)
                     for B in list(self._buckets)]
        if steps:
            self._validate(steps)

        membership: Dict[str, np.ndarray] = {}
        n_comms: Dict[str, int] = {}
        for B in self._buckets:
            for i, ten in enumerate(B.lanes):
                if i in B.frozen:
                    continue
                m = ten.mem[:ten.n_valid].cpu().numpy()
                membership[ten.tid] = m
                n_comms[ten.tid] = int(len(np.unique(m))) if len(m) else 0
        buckets_out = {B.env: [t.tid for i, t in enumerate(B.lanes)
                               if i not in B.frozen]
                       for B in self._buckets}
        layouts_out = {B.env: B.state_layout for B in self._buckets
                       if buckets_out.get(B.env)}
        layout_set = set(layouts_out.values())
        summary_layout = (layout_set.pop() if len(layout_set) == 1
                          else "mixed" if layout_set
                          else resolve_state_layout(
                              self.config.state_layout, self.n_shards))
        fracs = [self.tenants[tid].boundary_frac for tid in streams
                 if self.tenants[tid].boundary_frac is not None]
        self._buckets = []
        return FleetResult(
            membership=membership,
            n_communities=n_comms,
            pass_stats={tid: self.tenants[tid].stats for tid in streams},
            total_seconds=time.perf_counter() - t_start,
            n_dispatches=self._n_dispatches,
            n_fallbacks=self._n_fallbacks,
            n_migrations=self._n_migrations,
            bytes_on_wire=self._bytes,
            comm_rounds=self._rounds,
            comm_backend=self.comm_backend,
            buckets={env: tids for env, tids in buckets_out.items() if tids},
            bucket_layouts=layouts_out,
            state_layout=summary_layout,
            halo_bytes=self._halo,
            boundary_frac=max(fracs) if fracs else None,
            wire_bytes=self._wire,
            apply_seconds=self._apply_s,
            update_seconds=self._update_s)

    def _dispatch(self, B: _Bucket, t: int, streams,
                  fresh: bool) -> Optional[_Step]:
        """Run bucket ``B``'s step ``t`` over its lanes with a live batch
        (None when it has none).  ``fresh``: the reference would redispatch
        ``B`` after validating step t - 1 (a replay or a migration join),
        so its screening sees that step's measurement, not the one
        before."""
        bc = B.env.b_cap
        spec = B.spec
        act: List[int] = []
        rows: List[EdgeBatch] = []
        for i, ten in enumerate(B.lanes):
            if i in B.frozen:
                continue
            st = streams.get(ten.tid, ())
            if t < len(st):
                b = st[t]
                if b.b_cap > bc:
                    raise ValueError(
                        f"tenant {ten.tid!r} batch b_cap={b.b_cap} exceeds "
                        f"its admitted envelope b_cap={bc}")
                if int(b.b_valid) > 0:
                    act.append(i)
                    rows.append(b)
        mode, downgraded = resolve_screening_host(
            self.screen_req, B.touched_frac if fresh else B.seen_frac)
        if not act:
            return None
        t0 = time.perf_counter()
        group, dev = self.group, self.group.device
        n_pad, sent = spec.n_pad, spec.sentinel
        lanes = LaneLayout(spec, len(act))
        tens = [B.lanes[i] for i in act]

        def pad(x, fill, dtype):
            x = x.to(device=dev, dtype=dtype)
            return torch.cat([x, torch.full((bc - x.shape[0],), fill,
                                            dtype=dtype, device=dev)])

        batch = FleetBatch(
            src=torch.stack([pad(b.src, sent, torch.int32) for b in rows]),
            dst=torch.stack([pad(b.dst, sent, torch.int32) for b in rows]),
            weight=torch.stack([pad(b.weight, 0.0, torch.float32)
                                for b in rows]),
            b_valid=np.array([int(b.b_valid) for b in rows], np.int64))
        src2, dst2, w2, touched, e_max, nv2 = sharded_batch_apply(
            group, spec, *lanes.flat_slots([(ten.src, ten.dst, ten.w)
                                            for ten in tens]),
            batch, [ten.n_valid for ten in tens],
            [ten.n_cap for ten in tens], self.apply_backend)
        t1 = time.perf_counter()

        # Screening, the warm start and pass 0 of the solo pass loop, over
        # the lanes.
        mem_f = lanes.flat_membership(torch.stack([ten.mem for ten in tens]))
        thr = lanes.thresholds(nv2, dev)
        if mode is not None:
            frontier = affected_frontier(touched, mem_f, thr, mode)
        else:
            frontier = (torch.arange(lanes.flat.n_pad + 1, device=dev)
                        < thr)
        k = _vertex_k(group, lanes.flat, src2, w2)
        m = _total_weight(group, w2, len(act))
        comm0, sigma0 = _warm_comm_sigma(mem_f, k, thr)
        comm, _, iters, dq_sum, rounds, fbs, wire = distributed_move(
            group, spec, src2, dst2, w2, comm0, sigma0, k, frontier, m,
            np.full(len(act), float(self.config.initial_tolerance)),
            config=self._engine, comm_backend=self.comm_backend,
            state_layout=B.state_layout, n_lanes=len(act))
        comm_ren, n_comms = replicated_renumber(lanes.tenant_rows(comm))
        mem2 = sentinel_forced_membership(comm_ren, nv2, n_pad)
        fr_rows = lanes.rows(frontier)
        counts = torch.stack([
            dq_sum.to(torch.float64),
            lanes.rows(touched).sum(1).to(torch.float64),
            fr_rows.sum(1).to(torch.float64)]).cpu().numpy()
        post = [lanes.lane_slots(src2, dst2, w2, j) + (mem2[j],)
                for j in range(len(act))]
        self._n_dispatches += 1
        t2 = time.perf_counter()
        self._apply_s[t] += t1 - t0
        self._update_s[t] += t2 - t1
        return _Step(
            bucket=B, t=t, act=act,
            pre=[(ten.src, ten.dst, ten.w, ten.mem, ten.n_valid)
                 for ten in tens],
            post=post, frontier=fr_rows if mode is not None else None,
            batch=batch, mode=mode, downgraded=downgraded, seconds=t2 - t0,
            scalars=dict(e_max=e_max, iters=np.asarray(iters),
                         n_comms=n_comms, dq_sum=counts[0],
                         rounds=np.asarray(rounds), fallbacks=np.asarray(fbs),
                         touched_n=counts[1].astype(np.int64),
                         frontier_n=(counts[2].astype(np.int64)
                                     if mode is not None else nv2),
                         nv=nv2),
            wire_bytes=wire)

    def _validate(self, steps: List[Optional[_Step]]) -> List[_Bucket]:
        """Check every step of one dispatch round: price it, accept or
        replay each lane, migrate whales.  Returns the buckets whose state
        changed after their step (replays, migration joins, new buckets):
        the reference redispatches those."""
        for B in self._buckets:
            B.seen_frac = B.touched_frac
        redo: List[_Bucket] = []
        migrations = []
        cfg = self.config
        for p in steps:
            if p is None:
                continue
            t0 = time.perf_counter()
            B, sc = p.bucket, p.scalars
            spec = B.spec
            # The price of the batched collectives: EVERY lane's payload
            # for the most rounds any lane ran, as the reference prices
            # its vmapped step.
            plan = sharded_comm_plan(spec, self.comm_backend, B.state_layout)
            r_exec = int(sc["rounds"].max())
            fb_exec = int(sc["fallbacks"].max())
            self._bytes += len(B.lanes) * phase_bytes(plan, r_exec, fb_exec)
            self._halo += len(B.lanes) * plan.halo_round_bytes * r_exec
            self._rounds += r_exec
            self._wire += p.wire_bytes
            # The worst touched fraction of the bucket drives a later
            # dispatch's host-side "auto" screening.
            B.touched_frac = max(int(sc["touched_n"][j])
                                 / max(int(sc["nv"][j]), 1)
                                 for j in range(len(p.act)))
            patched = False
            for j, i in enumerate(p.act):
                ten = B.lanes[i]
                nv_i = int(sc["nv"][j])
                overflow = int(sc["e_max"][j]) > spec.e_per_shard
                accepted = (not overflow) and (
                    int(sc["iters"][j]) <= 1
                    or int(sc["n_comms"][j]) / max(nv_i, 1)
                    > cfg.aggregation_tolerance
                    or cfg.max_passes <= 1)
                stat = PassStats(
                    iterations=int(sc["iters"][j]),
                    n_communities=int(sc["n_comms"][j]),
                    n_vertices=nv_i,
                    dq_sum=float(sc["dq_sum"][j]),
                    seconds=p.seconds, phase_seconds={},
                    frontier_size=int(sc["frontier_n"][j]),
                    n_cap=spec.n_pad, e_cap=spec.e_per_shard * spec.n_shards,
                    screening=p.mode, scan_backend="sharded",
                    downgraded=p.downgraded)
                if overflow:
                    migrations.append((p, j, int(sc["e_max"][j])))
                    continue
                src, dst, w, mem2 = p.post[j]
                ten.src, ten.dst, ten.w, ten.n_valid = src, dst, w, nv_i
                if accepted:
                    ten.mem = mem2
                    ten.stats.append(stat)
                    continue
                # Pass 0 is not where the tenant alone stops: replay the
                # lane through the solo pass loop from its PRE-step
                # membership (it reproduces pass 0 and goes on).
                fr = None
                if p.mode is not None:
                    fr = torch.cat([p.frontier[j], torch.zeros(
                        1, dtype=torch.bool, device=p.frontier.device)])
                ten.mem, nc_i, rows = self._run_solo_passes(
                    spec, src, dst, w, nv_i, init_membership=p.pre[j][3],
                    init_frontier=fr, state_layout=B.state_layout)
                ten.n_fallbacks += 1
                self._n_fallbacks += 1
                self._rounds += sum(r["comm_rounds"] for r in rows[1:])
                self._bytes += sum(r["comm_bytes"] for r in rows[1:])
                self._halo += sum(r["halo_bytes"] for r in rows[1:])
                self._wire += sum(r["wire_bytes"] for r in rows)
                ten.stats.append(dataclasses.replace(
                    stat, iterations=sum(r["iterations"] for r in rows),
                    n_communities=nc_i))
                patched = True
            if patched:
                redo.append(B)
            self._update_s[p.t] += time.perf_counter() - t0
        for p, j, e_need in migrations:
            t0 = time.perf_counter()
            dest = self._migrate(p, j, e_need)
            if dest not in redo:
                redo.append(dest)
            self._update_s[p.t] += time.perf_counter() - t0
        return redo

    def _migrate(self, p: _Step, j: int, e_need: int) -> _Bucket:
        """Whale migration: grow the lane's PRE-apply slots into the grown
        envelope, replay the overflowing step for it alone exactly once,
        and join (or found) the destination bucket.  The source lane is
        frozen; its cohabitants keep their state."""
        B = p.bucket
        i = p.act[j]
        ten = B.lanes[i]
        env = migrate_envelope(ten.env, e_need)
        src, dst, w, mem_pre, nv_pre = p.pre[j]
        # The live slots are each rank's sorted prefix: padding them on the
        # card is the reference's host re-bucket.
        src, dst, w, spec_new = _grow_slots(B.spec, src, dst, w,
                                            env.e_per_shard)
        batch = EdgeBatch(src=p.batch.src[j], dst=p.batch.dst[j],
                          weight=p.batch.weight[j],
                          b_valid=int(p.batch.b_valid[j]))
        while True:
            out = sharded_batch_apply(self.group, spec_new, src, dst, w,
                                      batch, nv_pre, ten.n_cap,
                                      self.apply_backend)
            if out[4] <= spec_new.e_per_shard:
                break
            env = migrate_envelope(env, out[4])
            src, dst, w, spec_new = _grow_slots(spec_new, src, dst, w,
                                                env.e_per_shard)
        src2, dst2, w2, touched, _, n_live = out
        frontier = (affected_frontier(touched, mem_pre, n_live, p.mode)
                    if p.mode is not None else None)
        mem2, nc, rows = self._run_solo_passes(
            spec_new, src2, dst2, w2, n_live, init_membership=mem_pre,
            init_frontier=frontier, state_layout=B.state_layout)
        self._rounds += sum(r["comm_rounds"] for r in rows)
        self._bytes += sum(r["comm_bytes"] for r in rows)
        self._halo += sum(r["halo_bytes"] for r in rows)
        self._wire += sum(r["wire_bytes"] for r in rows)
        ten.stats.append(PassStats(
            iterations=sum(r["iterations"] for r in rows),
            n_communities=nc, n_vertices=n_live,
            dq_sum=sum(r["dq_sum"] for r in rows),
            seconds=0.0, phase_seconds={},
            frontier_size=(int(frontier.sum()) if frontier is not None
                           else n_live),
            n_cap=spec_new.n_pad,
            e_cap=spec_new.e_per_shard * spec_new.n_shards,
            screening=p.mode, scan_backend="sharded",
            downgraded=p.downgraded))
        ten.env = env
        ten.migrations.append(dict(step=p.t, e_need=e_need,
                                   e_per_shard=env.e_per_shard))
        self._n_migrations += 1
        B.frozen.add(i)
        ten.src, ten.dst, ten.w, ten.mem, ten.n_valid = (src2, dst2, w2,
                                                         mem2, n_live)
        for dest in self._buckets:
            if dest is not B and dest.env == env:
                # Join at the destination's validated post-step state.
                dest.lanes.append(ten)
                return dest
        dest = _Bucket(env, spec_new, [ten], B.state_layout,
                       touched_frac=B.touched_frac)
        self._buckets.append(dest)
        return dest


def serve_fleet(graphs: Dict[str, CSRGraph],
                streams: Dict[str, Sequence[EdgeBatch]],
                group: ShardGroup,
                prevs: Optional[Dict[str, np.ndarray]] = None,
                config: LouvainConfig = LouvainConfig(), *,
                screening="auto", apply_backend: str = "auto") -> FleetResult:
    """Admit every tenant and serve every stream on one rank of ``group``.
    ``prevs`` maps a tenant id to its previous membership (the others get a
    cold solo pass loop at admission); a tenant's batch capacity is the
    largest of its stream."""
    router = FleetRouter(group, config, screening=screening,
                         apply_backend=apply_backend)
    prevs = prevs or {}
    for tid, graph in graphs.items():
        b_cap = max((b.b_cap for b in streams.get(tid, ())), default=1)
        router.admit(tid, graph, prev=prevs.get(tid), b_cap=b_cap)
    return router.serve(streams)
