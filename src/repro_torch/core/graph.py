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

    def total_weight(self) -> torch.Tensor:
        """0-d float32 m = sum(w) / 2, kept on the device."""
        return torch.sum(self.weights) * 0.5


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


def rebucket_capacity(graph: CSRGraph, *, n_cap_new: int,
                      e_cap_new: int) -> CSRGraph:
    """Copy a graph into buffers of another capacity (shrink OR grow).

    Live data must fit the target and sit in a compact edge prefix (true of
    ``build_csr`` and ``aggregate_graph`` outputs).  Vertex-id arrays
    rewrite the sentinel (old ``n_cap`` -> new); valid ids are < ``n_valid``
    and survive either direction unchanged.
    """
    n_cap, e_cap = graph.n_cap, graph.e_cap
    lim = min(n_cap, n_cap_new)

    def remap(x):
        return torch.where(x >= lim, torch.full_like(x, n_cap_new), x)

    def resize_e(x, fill):
        if e_cap_new <= e_cap:
            return x[:e_cap_new]
        return torch.cat([x, torch.full((e_cap_new - e_cap,), fill,
                                        dtype=x.dtype, device=x.device)])

    if n_cap_new <= n_cap:
        indptr = graph.indptr[: n_cap_new + 1]
    else:
        indptr = torch.cat([graph.indptr,
                            graph.indptr[-1:].expand(n_cap_new - n_cap)])
    return CSRGraph(indptr=indptr.contiguous(),
                    indices=remap(resize_e(graph.indices, n_cap)),
                    weights=resize_e(graph.weights, 0.0),
                    src=remap(resize_e(graph.src, n_cap)),
                    n_valid=graph.n_valid, e_valid=graph.e_valid)


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
    the CSR themselves; ``to_ell_blocks`` adds the padded matrices."""
    dev = graph.device
    n, n_cap = graph.n_valid, graph.n_cap
    deg = graph.indptr[1:n + 1] - graph.indptr[:n]
    assigned = torch.zeros(n, dtype=torch.bool, device=dev)
    buckets = []
    lo = 0
    for width in widths:
        sel_mask = (deg <= width if width == widths[0]
                    else (deg > lo) & (deg <= width))
        lo = width
        sel = torch.nonzero(sel_mask).flatten()
        n_sel = sel.numel()
        n_rows = int(math.ceil(max(n_sel, 1) / row_align) * row_align)
        rows = torch.full((n_rows,), n_cap, dtype=torch.int32, device=dev)
        rows[:n_sel] = sel.to(torch.int32)
        assigned |= sel_mask
        buckets.append(rows)
    leftover = torch.nonzero(~assigned).flatten().to(torch.int32)
    return buckets, leftover


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
