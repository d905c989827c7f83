"""Graph generators, one module per generator named in a configuration's
``generator`` key.  Each exposes ``generate(sizes, seed, device)`` and
returns ``(n, us, ud)``: the vertex count and the undirected edges as two
int32 tensors on ``device`` with ``us < ud``, without self loops or
repeats, in ascending ``(us, ud)`` order.  The same seed gives the same
edges; the edges are drawn with a ``torch.Generator`` on ``device``."""

import torch


def unique_pairs(u: torch.Tensor, v: torch.Tensor, n: int):
    """(us, ud) int32: the pairs {u, v} with u != v, each once, as
    us < ud in ascending order."""
    lo, hi = torch.minimum(u, v).to(torch.int64), torch.maximum(u, v).to(
        torch.int64)
    keep = lo != hi
    key = torch.unique(lo[keep] * n + hi[keep])
    return (key // n).to(torch.int32), (key % n).to(torch.int32)


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    return gen
