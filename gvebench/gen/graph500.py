"""The Graph500 Kronecker (R-MAT) generator: 2^scale vertex ids and
edge_factor * 2^scale edges, each edge's bits drawn with the initiator
probabilities a, b, c (d = 1 - a - b - c), vertex labels permuted by a
random permutation as the Graph500 reference generator does.  Self loops
and repeats are dropped; every edge has unit weight.  The ids that no edge
touches are dropped too and the rest renumbered densely in their permuted
order, as LDBC Graphalytics' graph500 datasets keep only the vertices with
edges (2,396,657 of the 2^22 ids at scale 22).

A configuration that stands for one dataset names its ``edge_seed``: the
edges and the label permutation are drawn from it, so every run has the
same graph whatever its seed.  Without it they are drawn from the run's
seed."""

import torch

from gvebench.gen import generator, unique_pairs


def generate(sizes: dict, seed: int, device):
    scale = int(sizes["scale"])
    a, b, c = float(sizes["a"]), float(sizes["b"]), float(sizes["c"])
    n = 1 << scale
    m = n * int(sizes["edge_factor"])
    gen = generator(sizes.get("edge_seed", seed), device)
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        r = torch.rand(m, generator=gen, device=device)
        right = (r > a + b) & (r <= a + b + c)
        down = r > a + b + c
        pick_b = (r > a) & (r <= a + b)
        src += (right | down).to(torch.int64) << bit
        dst += (pick_b | down).to(torch.int64) << bit
        del r, right, down, pick_b
    perm = torch.randperm(n, generator=gen, device=device)
    us, ud = unique_pairs(perm[src], perm[dst], n)
    del src, dst, perm
    return relabel_dense(n, us, ud)


def relabel_dense(n: int, us: torch.Tensor, ud: torch.Tensor):
    """(vertex count, us, ud) with the ids that no edge touches dropped and
    the others renumbered 0, 1, ... in ascending order; the pairs keep
    ``us < ud`` and their ascending order, since the map is increasing."""
    touched = torch.zeros(n, dtype=torch.bool, device=us.device)
    touched[us.long()] = True
    touched[ud.long()] = True
    new_id = torch.cumsum(touched, 0, dtype=torch.int64) - 1
    n_kept = int(new_id[-1]) + 1 if n else 0
    return (n_kept, new_id[us.long()].to(torch.int32),
            new_id[ud.long()].to(torch.int32))
