"""Padded CSR graph container of the PyTorch port (``repro.core.graph``).

A graph lives in buffers of fixed capacity (``n_cap`` vertex slots,
``e_cap`` directed edge slots) on one device.  The slot contract is the JAX
package's, element for element:

  - undirected edge {i,j}, i != j   -> two directed slots (i,j,w) and (j,i,w)
  - self loop {i,i}                 -> ONE slot (i,i,w)
  - pad slots hold ``(indices=n_cap, w=0, src=n_cap)``
  - K_i  = sum of slot weights out of i, with a trailing sentinel slot (= 0)
  - m    = (sum of all slot weights) / 2

``n_valid``/``e_valid`` are host ints: PyTorch runs eagerly, so the pass
loop reads them without a device round trip.

Float segment sums (``segment_sum``) accumulate in float64 and round once
to float32.  CUDA adds a segment's values with atomics in no fixed order;
the float64 sum of integer-valued summands is exact, so the result does not
depend on that order, and it equals the reference's float32 sum while the
sums stay below 2^24.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (every entry point's
    default) needs a card: without one this raises instead of quietly
    running on the CPU, so a CPU run is always one the caller asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def segment_sum(values: torch.Tensor, segments: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` for in-range segment ids; floating values
    accumulate in float64 (see the module docstring)."""
    acc = torch.float64 if values.is_floating_point() else values.dtype
    out = torch.zeros(num_segments, dtype=acc, device=values.device)
    out.index_add_(0, segments, values.to(acc))
    return out.to(values.dtype)


def scatter_slots(pos: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  w: torch.Tensor, sent: int, cap: int):
    """(cap,) slot buffers (src, dst, w) from records scattered to ``pos``.

    Position ``cap`` is the scratch slot of every record that is not kept
    (dropped with it); slots nobody writes stay padding ``(sent, sent, 0)``.
    """
    pos = pos.to(torch.int64)
    dev = src.device
    out_src = torch.full((cap + 1,), sent, dtype=torch.int32,
                         device=dev).scatter_(0, pos, src)[:cap]
    out_dst = torch.full((cap + 1,), sent, dtype=torch.int32,
                         device=dev).scatter_(0, pos, dst)[:cap]
    out_w = torch.zeros(cap + 1, dtype=torch.float32,
                        device=dev).scatter_(0, pos, w)[:cap]
    return out_src, out_dst, out_w


@dataclasses.dataclass
class CSRGraph:
    """Padded CSR graph; all tensors live on one device.

    indptr  : (n_cap + 1,) int32 — offsets; rows >= n_valid are empty.
    indices : (e_cap,) int32 — neighbor ids; padding slots hold ``n_cap``.
    weights : (e_cap,) float32 — edge weights; padding slots hold 0.
    src     : (e_cap,) int32 — row id of each slot; pad = n_cap.
    n_valid : number of valid vertices.
    e_valid : number of valid edge slots (a compact prefix).
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    weights: torch.Tensor
    src: torch.Tensor
    n_valid: int
    e_valid: int

    @property
    def n_cap(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def e_cap(self) -> int:
        return self.indices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def vertex_weights(self) -> torch.Tensor:
        """(n_cap + 1,) float32 — K_i, with a trailing sentinel slot (= 0)."""
        return segment_sum(self.weights, self.src, self.n_cap + 1)

    @property
    def n_streams(self) -> int:
        """A graph is one stream (a fleet's ``FleetView`` holds S)."""
        return 1

    def total_weight(self) -> torch.Tensor:
        """0-d float32 m = sum(w) / 2, kept on the device: the sum
        accumulates in float64 and rounds once, so it does not depend on
        the buffer's padding or summation order while it is exact in
        float64 (integer weights below 2^53)."""
        return torch.sum(self.weights, dtype=torch.float64).to(
            torch.float32) * 0.5


def _host_or_tensor(x, np_dtype, dtype: torch.dtype,
                    dev: torch.device) -> torch.Tensor:
    """Cast like ``np.asarray(x, np_dtype)`` (host arrays are cast on the
    host, as the reference ``build_csr`` does) and move to ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    arr = np.ascontiguousarray(np.asarray(x, dtype=np_dtype))
    return torch.from_numpy(arr).to(dev)


def build_csr(src, dst, weight, n: int, *, n_cap: int | None = None,
              e_cap: int | None = None, symmetrize: bool = False,
              dedup: bool = True, device="cuda") -> CSRGraph:
    """The padded CSR of a directed slot list, built on ``device``.

    ``symmetrize=True`` adds reverse slots for every i != j pair; ``dedup``
    merges parallel slots by summing weights (in float64, then cast, like
    the reference).  Buffers equal ``repro.core.graph.build_csr``'s.
    """
    dev = resolve_device(device)
    src = _host_or_tensor(src, np.int32, torch.int32, dev)
    dst = _host_or_tensor(dst, np.int32, torch.int32, dev)
    weight = _host_or_tensor(weight, np.float32, torch.float32, dev)
    if symmetrize:
        off = src != dst
        src, dst = (torch.cat([src, dst[off]]), torch.cat([dst, src[off]]))
        weight = torch.cat([weight, weight[off]])
    if dedup and src.numel():
        key = src.to(torch.int64) * (n + 1) + dst.to(torch.int64)
        key, order = torch.sort(key, stable=True)
        src, dst, weight = src[order], dst[order], weight[order]
        first = torch.ones_like(key, dtype=torch.bool)
        first[1:] = key[1:] != key[:-1]
        gid = torch.cumsum(first, 0) - 1
        wsum = segment_sum(weight.to(torch.float64), gid, int(gid[-1]) + 1)
        src, dst, weight = src[first], dst[first], wsum.to(torch.float32)

    # CSR order.
    key = src.to(torch.int64) * (n + 1) + dst.to(torch.int64)
    order = torch.sort(key, stable=True).indices
    src, dst, weight = src[order], dst[order], weight[order]

    e = src.numel()
    n_cap = int(n_cap if n_cap is not None else n)
    e_cap = int(e_cap if e_cap is not None else e)
    if n_cap < n or e_cap < e:
        raise ValueError(f"capacity below graph size: n={n} > n_cap={n_cap} "
                         f"or e={e} > e_cap={e_cap}")

    counts = torch.bincount(src.to(torch.int64), minlength=n_cap)
    indptr = torch.zeros(n_cap + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    pad_i = torch.full((e_cap - e,), n_cap, dtype=torch.int32, device=dev)
    pad_w = torch.zeros(e_cap - e, dtype=torch.float32, device=dev)
    return CSRGraph(indptr=indptr, indices=torch.cat([dst, pad_i]),
                    weights=torch.cat([weight, pad_w]),
                    src=torch.cat([src, pad_i]), n_valid=int(n), e_valid=e)


def from_networkx(g, *, n_cap: int | None = None, e_cap: int | None = None,
                  device="cuda") -> CSRGraph:
    """Build from an undirected graph object with the networkx interface
    (``number_of_nodes``, ``nodes``, ``edges(data=True)``); unit weights by
    default.  The object is duck-typed: this package never imports
    networkx."""
    n = g.number_of_nodes()
    nodes = {v: i for i, v in enumerate(g.nodes())}
    src, dst, w = [], [], []
    for u, v, data in g.edges(data=True):
        wt = float(data.get("weight", 1.0))
        iu, iv = nodes[u], nodes[v]
        src.append(iu)
        dst.append(iv)
        w.append(wt)
        if iu != iv:
            src.append(iv)
            dst.append(iu)
            w.append(wt)
    return build_csr(np.array(src, np.int32), np.array(dst, np.int32),
                     np.array(w, np.float32), n, n_cap=n_cap, e_cap=e_cap,
                     device=device)


def rebucket_capacity(graph, *, n_cap_new: int, e_cap_new: int):
    """Copy a graph into buffers of another capacity (shrink OR grow).

    Live data must fit the target and sit in a compact edge prefix (true of
    ``build_csr`` and ``aggregate_graph`` outputs).  Vertex-id arrays
    rewrite the sentinel (old ``n_cap`` -> new); valid ids are < ``n_valid``
    and survive either direction unchanged.  ``graph`` may be a
    ``FleetGraph``: every stream goes to the one new capacity.
    """
    n_cap, e_cap = graph.n_cap, graph.e_cap
    lim = min(n_cap, n_cap_new)

    def remap(x):
        return torch.where(x >= lim, torch.full_like(x, n_cap_new), x)

    def resize_e(x, fill):
        if e_cap_new <= e_cap:
            return x[..., :e_cap_new].contiguous()
        return torch.cat([x, torch.full(x.shape[:-1] + (e_cap_new - e_cap,),
                                        fill, dtype=x.dtype,
                                        device=x.device)], -1)

    indptr = graph.indptr
    if n_cap_new <= n_cap:
        indptr = indptr[..., : n_cap_new + 1]
    else:
        indptr = torch.cat([indptr, indptr[..., -1:].expand(
            *indptr.shape[:-1], n_cap_new - n_cap)], -1)
    return dataclasses.replace(
        graph, indptr=indptr.contiguous(),
        indices=remap(resize_e(graph.indices, n_cap)),
        weights=resize_e(graph.weights, 0.0),
        src=remap(resize_e(graph.src, n_cap)))


def rebucket_graph(graph: CSRGraph, n_cap_new: int,
                   e_cap_new: int) -> CSRGraph:
    """``rebucket_capacity`` after checking that the live data fits."""
    if graph.n_valid > n_cap_new or graph.e_valid > e_cap_new:
        raise ValueError(
            f"graph does not fit target capacity: n_valid={graph.n_valid} > "
            f"n_cap_new={n_cap_new} or e_valid={graph.e_valid} > "
            f"e_cap_new={e_cap_new}")
    return rebucket_capacity(graph, n_cap_new=int(n_cap_new),
                             e_cap_new=int(e_cap_new))


def empty_like_caps(n_cap: int, e_cap: int, device="cuda") -> CSRGraph:
    """An all-padding graph buffer (used as the coarse-graph target)."""
    dev = resolve_device(device)
    return CSRGraph(
        indptr=torch.zeros(n_cap + 1, dtype=torch.int32, device=dev),
        indices=torch.full((e_cap,), n_cap, dtype=torch.int32, device=dev),
        weights=torch.zeros(e_cap, dtype=torch.float32, device=dev),
        src=torch.full((e_cap,), n_cap, dtype=torch.int32, device=dev),
        n_valid=0, e_valid=0)


def connected_total_weight_check(graph: CSRGraph) -> float:
    """Debug helper: host-side 2m."""
    return float(graph.weights.cpu().numpy().sum())


# ---------------------------------------------------------------------------
# A fleet of equal-capacity graphs (batched multi-stream serving).
# ---------------------------------------------------------------------------

#: Flat vertex and sort-key ids of a fleet are int32 on the card (the
#: kernels K3/K4 take int32 keys and one int32 sentinel).
_INT32_LIMIT = 2 ** 31


@dataclasses.dataclass
class FleetGraph:
    """S graphs of one ``(n_cap, e_cap)`` envelope, stacked along axis 0.

    indptr  : (S, n_cap + 1) int32; indices, src : (S, e_cap) int32 in
    stream-local vertex ids (padding ``n_cap``); weights : (S, e_cap)
    float32; n_valid, e_valid : (S,) host int64 arrays.  ``stream(s)``
    takes stream s out as a ``CSRGraph``; ``view()`` is the flat layout in
    which one launch serves every stream (``FleetView``).
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    weights: torch.Tensor
    src: torch.Tensor
    n_valid: np.ndarray
    e_valid: np.ndarray

    def __post_init__(self):
        self.n_valid = np.asarray(self.n_valid, np.int64).reshape(-1)
        self.e_valid = np.asarray(self.e_valid, np.int64).reshape(-1)
        if (self.n_streams * (self.n_cap + 1) + 1 >= _INT32_LIMIT
                or self.n_streams * self.e_cap >= _INT32_LIMIT):
            raise ValueError(
                f"fleet of {self.n_streams} streams at n_cap {self.n_cap}, "
                f"e_cap {self.e_cap} exceeds the int32 flat id space")

    @property
    def n_streams(self) -> int:
        return self.indptr.shape[0]

    @property
    def n_cap(self) -> int:
        return self.indptr.shape[1] - 1

    @property
    def e_cap(self) -> int:
        return self.indices.shape[1]

    @property
    def device(self) -> torch.device:
        return self.indices.device

    @property
    def sentinel(self) -> int:
        """The flat sentinel ``S * (n_cap + 1)``: one past every stream's
        block of vertex slots."""
        return self.n_streams * (self.n_cap + 1)

    def stream(self, s: int) -> CSRGraph:
        return CSRGraph(indptr=self.indptr[s], indices=self.indices[s],
                        weights=self.weights[s], src=self.src[s],
                        n_valid=int(self.n_valid[s]),
                        e_valid=int(self.e_valid[s]))

    def take(self, rows) -> "FleetGraph":
        """The sub-fleet of streams ``rows`` (host ints), in that order."""
        rows = np.asarray(rows, np.int64)
        ix = torch.from_numpy(rows).to(self.device)
        return FleetGraph(indptr=self.indptr[ix], indices=self.indices[ix],
                          weights=self.weights[ix], src=self.src[ix],
                          n_valid=self.n_valid[rows],
                          e_valid=self.e_valid[rows])

    def offsets(self) -> torch.Tensor:
        """(S, 1) int32 first flat id of each stream's block."""
        return (torch.arange(self.n_streams, dtype=torch.int32,
                             device=self.device) * (self.n_cap + 1))[:, None]

    def flat_ids(self, x: torch.Tensor) -> torch.Tensor:
        """(S, k) stream-local vertex ids -> (S * k,) int32 flat ids; ids
        outside [0, n_cap) (sentinels, unassigned) become the flat
        sentinel.  int32 throughout: flat ids stay below 2^31."""
        x = x.to(torch.int32)
        own = (x >= 0) & (x < self.n_cap)
        return torch.where(own, x + self.offsets(),
                           self.sentinel).reshape(-1)

    def flat_vertex_ids(self, x: torch.Tensor) -> torch.Tensor:
        """(S, n_cap + 1) per-vertex ids -> (G + 1,) flat, the trailing flat
        sentinel slot pointing at itself (G = ``sentinel``)."""
        tail = torch.full((1,), self.sentinel, dtype=torch.int32,
                          device=self.device)
        return torch.cat([self.flat_ids(x), tail])

    def local_vertex_ids(self, flat: torch.Tensor) -> torch.Tensor:
        """Inverse of ``flat_vertex_ids``: (G + 1,) flat ids -> (S,
        n_cap + 1) stream-local ids, the flat sentinel -> ``n_cap``."""
        sent, n_cap = self.sentinel, self.n_cap
        f = flat[:sent].view(self.n_streams, n_cap + 1).to(torch.int32)
        return torch.where(f >= sent, n_cap, f - self.offsets())

    def flat_vertex_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """(S, n_cap + 1) bool -> (G + 1,) bool, the sentinel slot False."""
        tail = torch.zeros(1, dtype=torch.bool, device=self.device)
        return torch.cat([mask.reshape(-1), tail])

    def local_vertex_mask(self, flat: torch.Tensor) -> torch.Tensor:
        """Inverse of ``flat_vertex_mask``."""
        return flat[:self.sentinel].view(self.n_streams, self.n_cap + 1)

    def thresholds(self, counts) -> torch.Tensor:
        """(G + 1,) int64 per-vertex thresholds of (S,) per-stream counts:
        flat id f of stream s is below count_s iff f < its threshold
        s * (n_cap + 1) + count_s (the sentinel slot's is 0)."""
        c = torch.as_tensor(np.asarray(counts), device=self.device)
        return torch.cat([(self.offsets()[:, 0].to(torch.int64)
                           + c).repeat_interleave(
            self.n_cap + 1), torch.zeros(1, dtype=torch.int64,
                                         device=self.device)])

    def total_weight(self) -> torch.Tensor:
        """(S,) float32 m_s = sum(w_s) / 2, kept on the device, accumulated
        as ``CSRGraph.total_weight()`` accumulates it (float64, one
        rounding): each stream's equals its own graph's."""
        return torch.sum(self.weights, dim=1, dtype=torch.float64).to(
            torch.float32) * 0.5

    def view(self) -> "FleetView":
        """The fleet as one graph of G + 1 vertex slots holding every
        stream's live slots and no padding (see ``FleetView``)."""
        dev = self.device
        ev = torch.from_numpy(self.e_valid).to(dev)
        live = torch.nonzero((torch.arange(self.e_cap, device=dev)[None, :]
                              < ev[:, None]).reshape(-1)).flatten()
        m = self.total_weight().repeat_interleave(self.n_cap + 1)
        return FleetView(
            indices=self.flat_ids(self.indices)[live],
            weights=self.weights.reshape(-1)[live],
            src=self.flat_ids(self.src)[live],
            n_valid=self.thresholds(self.n_valid),
            m=torch.cat([m, torch.zeros(1, dtype=m.dtype, device=dev)]),
            n_streams=self.n_streams, sentinel=self.sentinel)


def lane_positions(keep: torch.Tensor, pos: torch.Tensor,
                   lane: torch.Tensor, n_lanes: int):
    """Per-lane positions of the records of one group resolve (K3/K4 or
    their sort chains) over a slot list keyed lane by lane.

    ``keep`` marks the records to write, ``pos`` is each one's rank among
    all kept records, ``lane`` each record's lane (int32, never decreasing
    along the list: the records follow the sorted slot list, K3/K4's first
    one carrying the phantom key -2, so its lane may be negative, and dead
    keys fall at or past ``n_lanes``).  A lane's records are then
    contiguous, and a record's position in its lane is ``pos`` minus the
    kept records before the lane's first.  Returns ``(lane_k, lpos,
    counts)``: the lane of each kept record (``n_lanes`` elsewhere), its
    position in its lane, and the (n_lanes,) int32 kept counts."""
    dev = keep.device
    first = torch.searchsorted(lane, torch.arange(
        n_lanes + 1, dtype=lane.dtype, device=dev))
    kept = torch.cumsum(keep, 0, dtype=torch.int32)
    offs = torch.where(first > 0, kept[torch.clamp(first - 1, min=0)], 0)
    del kept
    counts = offs[1:] - offs[:-1]
    lane_k = torch.where(keep, lane, n_lanes)
    lpos = pos.to(torch.int32) - torch.index_select(offs, 0, lane_k)
    return lane_k, lpos, counts


def scatter_fleet_records(fleet: FleetGraph, keep: torch.Tensor,
                          pos: torch.Tensor, r_src: torch.Tensor,
                          r_dst: torch.Tensor, r_w: torch.Tensor,
                          e_cap: int):
    """Scatter the records of one fleet-wide group resolve (K3/K4 or their
    sort chains over flat, stream-keyed slots) back into per-stream slot
    buffers of ``e_cap`` slots.

    ``keep`` marks the records to write, ``pos`` is each one's rank among
    all kept records; a stream's records are contiguous
    (``lane_positions``).  Records past ``e_cap`` are dropped (an overflow
    the caller reads from the counts).  Returns ``(src, dst, w, counts,
    indptr)``: (S, e_cap) buffers in stream-local ids, the (S,) uncapped
    kept counts as a device tensor, and the (S, n_cap + 1) CSR offsets.
    """
    S, n_cap = fleet.n_streams, fleet.n_cap
    N, sent = n_cap + 1, fleet.sentinel
    dev = fleet.device
    # int32 throughout (flat ids and positions stay below 2^31).  The flat
    # sentinel G = S * N of the dead keys falls in "stream" S, the phantom
    # key -2 in "stream" -1.
    r_src, r_dst = r_src.to(torch.int32), r_dst.to(torch.int32)
    stream, lpos, counts = lane_positions(
        keep, pos, torch.div(r_src, N, rounding_mode="floor"), S)
    ok = keep & (lpos < e_cap)
    base = stream * N
    loc_src = torch.where(ok, r_src - base, n_cap)
    loc_dst = torch.where(ok & (r_dst < sent), r_dst - base, n_cap)
    del base
    out_src, out_dst, out_w = scatter_slots(
        torch.where(ok, stream * e_cap + lpos, S * e_cap), loc_src, loc_dst,
        torch.where(ok, r_w, 0.0).to(torch.float32), n_cap, S * e_cap)
    out_src = out_src.view(S, e_cap)
    # Each stream's slots lie in (src, dst) order with its padding (n_cap)
    # last, so row v starts at the first slot whose src is >= v.
    ids = torch.arange(N, dtype=torch.int32, device=dev).expand(S, N)
    indptr = torch.searchsorted(out_src, ids.contiguous()).to(torch.int32)
    return (out_src, out_dst.view(S, e_cap), out_w.view(S, e_cap),
            counts, indptr)


@dataclasses.dataclass
class FleetView:
    """A fleet flattened into one graph: stream s's vertex v is flat id
    ``s * (n_cap + 1) + v``, G = ``S * (n_cap + 1)`` is the flat sentinel,
    and the slot list is every stream's live slots in order, without the
    envelope's padding.  Flat ids keep the order within each stream, so
    sort keys, min-id tie-breaks and the singleton-swap guard compare what
    they compare when the stream runs alone, and the sort-reduce scan of
    an order-preserving subset holding every live slot is the full scan's
    (``local_move.best_moves_slots``).  Leaving the padding out spares the
    segment sums S envelopes' worth of atomic adds to one address.

    It is what the sort-reduce move phase reads of a ``CSRGraph``
    (``indices``, ``weights``, ``src``, ``n_valid``, ``n_cap`` — the
    sentinel —, ``e_cap``, ``n_streams``, ``vertex_weights()``,
    ``total_weight()``), with S streams where a graph has one: the engine
    splits the vertex slots below the sentinel into ``n_streams`` equal
    blocks and keeps one dQ and one stop per block.  ``n_valid`` is a
    (G + 1,) tensor of per-vertex thresholds (flat id f is valid iff
    f < n_valid[f]) and ``total_weight()`` each vertex's own stream's m.
    """

    indices: torch.Tensor
    weights: torch.Tensor
    src: torch.Tensor
    n_valid: torch.Tensor
    m: torch.Tensor
    n_streams: int
    sentinel: int

    @property
    def n_cap(self) -> int:
        return self.sentinel

    @property
    def e_cap(self) -> int:
        return self.indices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def vertex_weights(self) -> torch.Tensor:
        """(G + 1,) float32 K of every flat vertex slot (sentinel 0)."""
        return segment_sum(self.weights, self.src, self.sentinel + 1)

    def total_weight(self) -> torch.Tensor:
        """(G + 1,) float32: each vertex slot's stream's m (0 at G)."""
        return self.m


def stack_rows(xs) -> torch.Tensor:
    """``torch.stack`` of equal-shape tensors; one tensor becomes a
    one-row view of itself, not a copy (a graph served as a one-stream
    fleet)."""
    return xs[0][None] if len(xs) == 1 else torch.stack(xs)


def stack_graphs(graphs) -> FleetGraph:
    """Stack equal-capacity graphs along a new leading stream axis."""
    g0 = graphs[0]
    for g in graphs[1:]:
        if g.n_cap != g0.n_cap or g.e_cap != g0.e_cap:
            raise ValueError(
                f"stream capacities differ: ({g.n_cap}, {g.e_cap}) vs "
                f"({g0.n_cap}, {g0.e_cap}) — provision one shared envelope")
        if g.device != g0.device:
            raise ValueError(f"streams on {g.device} and {g0.device}")
    return FleetGraph(
        indptr=stack_rows([g.indptr for g in graphs]),
        indices=stack_rows([g.indices for g in graphs]),
        weights=stack_rows([g.weights for g in graphs]),
        src=stack_rows([g.src for g in graphs]),
        n_valid=[g.n_valid for g in graphs],
        e_valid=[g.e_valid for g in graphs])


# ---------------------------------------------------------------------------
# Degree-bucketed ELL view.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ELLBlock:
    """A fixed-width padded adjacency block for vertices of bounded degree.

    rows : (n_rows,) int32 — vertex id per row (pad rows = n_cap).
    cols : (n_rows, width) int32 — neighbors (pad = n_cap).
    w    : (n_rows, width) float32 — weights (pad = 0).
    """

    rows: torch.Tensor
    cols: torch.Tensor
    w: torch.Tensor

    @property
    def width(self) -> int:
        return self.cols.shape[1]


def _degree_tiers(graph: CSRGraph, widths: Tuple[int, ...],
                  row_align: int) -> Tuple[List[int], List[torch.Tensor],
                                           torch.Tensor]:
    """The degree histogram over ``widths`` and the rows of each tier:
    (host row counts per tier, each tier's padded rows, leftover ids).  One
    host read (the histogram), whatever the number of tiers."""
    if any(b <= a for a, b in zip(widths, widths[1:])):
        raise ValueError(f"ELL widths must ascend; got {tuple(widths)}")
    dev = graph.device
    n, n_cap = graph.n_valid, graph.n_cap
    deg = graph.indptr[1:n + 1] - graph.indptr[:n]
    # Tier k holds degrees in (widths[k-1], widths[k]]; len(widths) is the
    # leftover above the widest.
    tier = torch.bucketize(deg, torch.tensor(widths, dtype=deg.dtype,
                                             device=dev))
    counts = torch.bincount(tier, minlength=len(widths) + 1).tolist()
    # A stable sort keeps each tier's vertex ids ascending.
    grouped = torch.argsort(tier, stable=True).to(torch.int32)
    *parts, leftover = torch.split(grouped, counts)
    buckets = []
    for n_sel, sel in zip(counts, parts):
        n_rows = int(math.ceil(max(n_sel, 1) / row_align) * row_align)
        buckets.append(torch.cat([sel, torch.full(
            (n_rows - n_sel,), n_cap, dtype=torch.int32, device=dev)]))
    return counts[:-1], buckets, leftover


def ell_bucket_rows(graph: CSRGraph,
                    widths: Tuple[int, ...] = (16, 64, 256, 1024), *,
                    row_align: int = 8
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Degree bucketing on the graph's device: vertices with degree <=
    widths[k] (and > widths[k-1]) go to bucket k; the first bucket also
    takes isolated vertices.  Returns (rows per bucket, leftover vertex
    ids): each bucket's (n_rows,) int32 vertex ids in ascending order,
    padded with ``n_cap`` to a multiple of ``row_align``, and the vertices
    above the largest width.  The ELL scan kernels take these rows and read
    the CSR themselves; ``to_ell_blocks`` adds the padded matrices.
    ``widths`` ascend; one host read."""
    _, buckets, leftover = _degree_tiers(graph, widths, row_align)
    return buckets, leftover


def degree_tiers(graph: CSRGraph, widths: Tuple[int, ...], *,
                 row_align: int = 8
                 ) -> Tuple[List[Tuple[int, torch.Tensor]], torch.Tensor]:
    """``ell_bucket_rows`` keeping only the tiers that hold rows, as the
    graph's degree histogram shows them: ((width, rows) per such tier,
    leftover vertex ids above the widest width)."""
    counts, buckets, leftover = _degree_tiers(graph, widths, row_align)
    return ([(w, rows) for w, n_sel, rows in zip(widths, counts, buckets)
             if n_sel], leftover)


def ell_block(indptr: torch.Tensor, indices: torch.Tensor,
              weights: torch.Tensor, rows: torch.Tensor,
              width: int) -> ELLBlock:
    """The padded (R, width) adjacency of CSR rows ``rows`` (vertex ids; the
    sentinel ``n_cap = len(indptr) - 1`` marks a pad row): lane j of row r
    holds slot ``indptr[rows[r]] + j`` while j < the row's degree, else
    ``(n_cap, 0)``.  Raises when a row's degree exceeds ``width``."""
    n_cap = indptr.numel() - 1
    r = rows.to(torch.int64)
    real = r < n_cap
    beg = indptr[r].to(torch.int64)
    deg = torch.where(real, indptr[torch.where(real, r + 1, r)] - beg, 0)
    if rows.numel() and int(deg.max()) > width:
        raise ValueError(f"a row of degree {int(deg.max())} does not fit "
                         f"ELL width {width}")
    lane = torch.arange(width, device=rows.device)
    live = lane[None, :] < deg[:, None]
    cols = torch.full((rows.numel(), width), n_cap, dtype=torch.int32,
                      device=rows.device)
    wmat = torch.zeros((rows.numel(), width), dtype=torch.float32,
                       device=rows.device)
    if bool(live.any()):
        slot = torch.where(live, beg[:, None] + lane[None, :], 0)
        cols = torch.where(live, indices[slot], cols)
        wmat = torch.where(live, weights[slot], wmat)
    return ELLBlock(rows, cols, wmat)


def to_ell_blocks(graph: CSRGraph,
                  widths: Tuple[int, ...] = (16, 64, 256, 1024), *,
                  row_align: int = 8) -> Tuple[List[ELLBlock], torch.Tensor]:
    """``ell_bucket_rows`` plus each bucket's padded matrices
    (``ell_block``): (blocks, leftover_vertex_ids), the reference's ELL
    view element for element.  The reference fills rows in a host loop over
    vertices; this builds the same rows, cols, w and leftover ids with one
    gather per block."""
    buckets, leftover = ell_bucket_rows(graph, widths, row_align=row_align)
    return [ell_block(graph.indptr, graph.indices, graph.weights, rows, width)
            for rows, width in zip(buckets, widths)], leftover
