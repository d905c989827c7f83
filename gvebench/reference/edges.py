"""The edge-set semantics of a stream of edge batches, written out plainly.

The graph is a set of undirected edges {u, v} with weights, held as
sorted keys ``min * N + max`` (``N`` the vertex count).  A batch is a list
of entries ``{u, v} -> w`` applied in list order: ``w > 0`` sets the
edge's weight (an insert when absent), ``w == 0`` deletes it; of two
entries on one edge the later wins.  An entry changes the graph when the
edge's weight after the batch differs from before; the endpoints of the
changed edges are the batch's touched vertices.
"""

from __future__ import annotations

import dataclasses

import torch

from gvebench.reference.louvain import Graph


@dataclasses.dataclass
class EdgeSet:
    n: int                 # vertex count (ids below it)
    keys: torch.Tensor     # sorted int64 min * n + max
    w: torch.Tensor        # float32, > 0

    @classmethod
    def of_pairs(cls, n: int, us: torch.Tensor, ud: torch.Tensor):
        """Unit-weight edges from ``us < ud`` pairs without repeats."""
        keys, _ = torch.sort(us.to(torch.int64) * n + ud.to(torch.int64))
        return cls(n, keys, torch.ones(keys.shape[0], dtype=torch.float32,
                                       device=keys.device))

    def graph(self) -> Graph:
        """Its directed slots: two per edge, one per self loop."""
        u = (self.keys // self.n).to(torch.int32)
        v = (self.keys % self.n).to(torch.int32)
        off = u != v
        return Graph(self.n, torch.cat([u, v[off]]), torch.cat([v, u[off]]),
                     torch.cat([self.w, self.w[off]]))

    def directed(self):
        """Sorted directed keys ``src * n + dst`` and their weights."""
        g = self.graph()
        key = g.src.to(torch.int64) * self.n + g.dst.to(torch.int64)
        key, order = torch.sort(key)
        return key, g.w[order]

    def apply(self, u, v, w):
        """(the edge set after the batch, (n + 1,) touched mask)."""
        dev = self.keys.device
        u = torch.as_tensor(u, device=dev).to(torch.int64)
        v = torch.as_tensor(v, device=dev).to(torch.int64)
        w = torch.as_tensor(w, device=dev).to(torch.float32)
        key = torch.minimum(u, v) * self.n + torch.maximum(u, v)
        # The last entry of each edge: a stable sort keeps list order.
        key, order = torch.sort(key, stable=True)
        w = w[order]
        last = torch.ones_like(key, dtype=torch.bool)
        last[:-1] = key[:-1] != key[1:]
        key, w_new = key[last], w[last]
        n_e = self.keys.shape[0]
        at = torch.clamp(torch.searchsorted(self.keys, key),
                         max=max(n_e - 1, 0))
        if n_e:
            present = self.keys[at] == key
            w_old = torch.where(present, self.w[at], 0.0)
        else:
            present = torch.zeros_like(key, dtype=torch.bool)
            w_old = torch.zeros_like(w_new)
        changed = w_new != w_old
        touched = torch.zeros(self.n + 1, dtype=torch.bool, device=dev)
        touched[(key[changed] // self.n)] = True
        touched[(key[changed] % self.n)] = True
        keep = torch.ones(self.keys.shape[0], dtype=torch.bool, device=dev)
        keep[at[present]] = False
        add = w_new > 0
        keys = torch.cat([self.keys[keep], key[add]])
        ws = torch.cat([self.w[keep], w_new[add]])
        keys, order = torch.sort(keys)
        return EdgeSet(self.n, keys, ws[order]), touched


def frontier(touched: torch.Tensor, prev: torch.Tensor, n: int,
             mode: str) -> torch.Tensor:
    """The seed frontier of delta screening: ``"vertex"`` the touched
    vertices, ``"community"`` those and every member of their
    communities under ``prev`` ((n,) labels)."""
    valid = torch.arange(n + 1, device=touched.device) < n
    fv = touched & valid
    if mode == "vertex":
        return fv
    if mode != "community":
        raise ValueError(f"unknown screening mode {mode!r}")
    lab = torch.cat([torch.clamp(prev.to(torch.int64), max=n),
                     torch.full((1,), n, dtype=torch.int64,
                                device=prev.device)])
    mark = torch.zeros(n + 1, dtype=torch.bool, device=touched.device)
    mark[lab[fv]] = True
    mark[n] = False
    return (touched | mark[lab]) & valid
