"""Real spherical-harmonic rotation (Wigner-D) matrices, batched over edges
(``repro.models.gnn.wigner``).

The Ivanic–Ruedenberg recurrence (J. Phys. Chem. 1996, 100, 6342 +
errata) builds R^l from R^1 and R^{l-1}: every entry of R^l is a sum of at
most ten products ``c · R^1[i, j] · R^{l-1}[a, b]`` with constant ``c``.
The reference writes each entry as Python loops of elementwise ops; here
those terms are a table per l (``_recurrence_table``: for each entry of
R^l its terms' positions in R^1 and R^{l-1} and their coefficients, padded
to the longest entry with coefficient 0), built once per l on the host,
and each l is a few batched gathers, products and one sum.  The sums
associate differently from the reference's, so the blocks are
float32-close to it, not bit-equal.

Convention: real SH basis ordered m = -l..l with the l=1 basis (y, z, x) —
R^1 is the cartesian rotation conjugated by that permutation.
``rotation_to_z`` builds R with R @ n = z so that rotated edges point at
+z, where real SH are nonzero only at m = 0 — the eSCN trick's
precondition.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch


def rotation_to_z(n: torch.Tensor) -> torch.Tensor:
    """(E, 3) unit vectors -> (E, 3, 3) rotations with R @ n = +z.  A zero
    vector (self loops, padding) gives the all-zero matrix, as in the
    reference."""
    # Stable tangent: pick the reference axis least aligned with n.
    z = n.new_tensor([[0.0, 0.0, 1.0]])
    x = n.new_tensor([[1.0, 0.0, 0.0]])
    ref = torch.where(n[:, 2:3].abs() < 0.9, z, x)
    u = torch.linalg.cross(ref.expand_as(n), n)
    u = u / torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True),
                        min=1e-12)
    v = torch.linalg.cross(n, u)
    return torch.stack([u, v, n], dim=1)      # rows: u, v, n  =>  R n = e_z


def _r1_from_cart(r: torch.Tensor) -> torch.Tensor:
    """Cartesian (E, 3, 3) -> l=1 real-SH block with (y, z, x) ordering."""
    perm = torch.tensor([1, 2, 0], device=r.device)   # (x,y,z) -> (y,z,x)
    return r[:, perm][:, :, perm]


@functools.lru_cache(maxsize=None)
def _recurrence_table(l: int):
    """The terms of R^l (l >= 2): int64 (entries, K) flat positions in R^1
    (3 x 3) and in R^{l-1} ((2l-1) x (2l-1)), and float64 (entries, K)
    coefficients, for the (2l+1)^2 entries in row-major order; K is the
    longest entry's term count, shorter entries padded with coefficient 0
    at position 0."""
    w1 = 2 * l - 1

    def p(i, a, b):
        """The reference's P(i, a, b) as [(coef, r1 position, rp position)]:
        a is a row of R^{l-1} (|a| <= l-1), b a column of R^l (|b| <= l)."""
        def t(c, j, bb):
            return (c, (i + 1) * 3 + (j + 1), (a + l - 1) * w1 + (bb + l - 1))
        if b == -l:
            return [t(1.0, 1, -l + 1), t(1.0, -1, l - 1)]
        if b == l:
            return [t(1.0, 1, l - 1), t(-1.0, -1, -l + 1)]
        return [t(1.0, 0, b)]

    def scaled(c, terms):
        return [(c * k, i1, i2) for k, i1, i2 in terms if c * k != 0.0]

    entries = []
    for m in range(-l, l + 1):                   # row index
        am = abs(m)
        for n in range(-l, l + 1):               # column index
            denom = ((2 * l) * (2 * l - 1) if abs(n) == l
                     else (l + n) * (l - n))
            # u, v, w coefficients (Ivanic–Ruedenberg + errata): the
            # denominator depends on the COLUMN n, the numerators and the
            # case analysis on the ROW m.
            u_c = np.sqrt(max((l + m) * (l - m), 0) / denom)
            v_c = 0.5 * np.sqrt((1 + (m == 0)) * max((l + am - 1)
                                * (l + am), 0) / denom) * (1 - 2 * (m == 0))
            w_c = -0.5 * np.sqrt(max((l - am - 1) * (l - am), 0) / denom) \
                * (1 - (m == 0))
            terms = []
            if u_c:
                terms += scaled(u_c, p(0, m, n))
            if v_c:
                if m == 0:
                    vv = scaled(1.0, p(1, 1, n)) + scaled(1.0, p(-1, -1, n))
                elif m > 0:
                    vv = (scaled(np.sqrt(1 + (m == 1)), p(1, m - 1, n))
                          + scaled(-(1 - (m == 1)), p(-1, -m + 1, n)))
                else:
                    vv = (scaled(1 - (m == -1), p(1, m + 1, n))
                          + scaled(np.sqrt(1 + (m == -1)), p(-1, -m - 1, n)))
                terms += scaled(v_c, vv)
            if w_c:
                if m > 0:
                    ww = scaled(1.0, p(1, m + 1, n)) + scaled(1.0, p(-1, -m - 1, n))
                else:
                    ww = scaled(1.0, p(1, m - 1, n)) + scaled(-1.0, p(-1, -m + 1, n))
                terms += scaled(w_c, ww)
            entries.append(terms)
    k = max(len(t) for t in entries)
    coef = np.zeros((len(entries), k))
    i1 = np.zeros((len(entries), k), np.int64)
    i2 = np.zeros((len(entries), k), np.int64)
    for e, terms in enumerate(entries):
        for j, (c, a, b) in enumerate(terms):
            coef[e, j], i1[e, j], i2[e, j] = c, a, b
    return i1, i2, coef


@torch.no_grad()
def wigner_d_stack(r_cart: torch.Tensor, l_max: int) -> List[torch.Tensor]:
    """Returns [D_0, D_1, ..., D_lmax], D_l: (E, 2l+1, 2l+1), in
    ``r_cart``'s type and without autograd (rotations come from positions,
    which need no gradient)."""
    e = r_cart.shape[0]
    ds = [r_cart.new_ones((e, 1, 1))]
    if l_max == 0:
        return ds
    r1 = _r1_from_cart(r_cart)
    ds.append(r1)
    r1f = r1.reshape(e, 9)
    for l in range(2, l_max + 1):
        i1, i2, coef = (torch.as_tensor(t, device=r_cart.device)
                        for t in _recurrence_table(l))
        prev = ds[l - 1].reshape(e, -1)
        terms = coef.to(r_cart.dtype) * r1f[:, i1] * prev[:, i2]
        ds.append(terms.sum(-1).view(e, 2 * l + 1, 2 * l + 1))
    return ds


def block_diag_apply(ds: List[torch.Tensor], x: torch.Tensor,
                     transpose: bool = False) -> torch.Tensor:
    """Apply the stacked Wigner blocks to irrep features.

    x: (E, rows, C); each l block ``d`` (E, r_l, 2l+1) maps its 2l+1 input
    rows to r_l rows, or with ``transpose`` its r_l rows back to 2l+1
    (``d``ᵀ).  With whole blocks (r_l = 2l+1) this is the reference's
    ``block_diag_apply``; with row-sliced blocks it is the halo step's
    ``rotate_rows`` / ``unrotate_rows``.
    """
    outs, off = [], 0
    for d in ds:
        mat = d.transpose(1, 2) if transpose else d
        k = mat.shape[2]
        outs.append(torch.matmul(mat, x[:, off:off + k]))
        off += k
    return torch.cat(outs, dim=1)
