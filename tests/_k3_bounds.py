"""Float tolerances for K3's open-group weight sums (``g_w``), shared by the
port's CPU and card tests.  Imports numpy only, so the card tests can use it
on a machine without JAX."""

from __future__ import annotations

import numpy as np


def k3_tolerances(ci, cj, w):
    """Per record i (total + 1 of them), over the m slots of slot i - 1's
    open group through slot i - 1 (none for i = 0): ``stated`` =
    m * 2^-23 * sum |w|, the contract for a float32 sum taken in any
    association, and ``tight`` = sqrt(m) * 2^-23 * sum |w|, the growth that
    rounding errors of random sign reach, which a sum that drops or repeats
    a slot or a tile exceeds."""
    total = len(ci)
    if total == 0:
        return np.zeros(1), np.zeros(1)
    first = np.ones(total, bool)
    first[1:] = (ci[1:] != ci[:-1]) | (cj[1:] != cj[:-1])
    idx = np.arange(total)
    start = np.maximum.accumulate(np.where(first, idx, 0))
    cabs = np.concatenate([[0.0], np.cumsum(np.abs(w.astype(np.float64)))])
    m = idx - start + 1
    scale = 2.0 ** -23 * (cabs[idx + 1] - cabs[start])
    return (np.concatenate([[0.0], m * scale]),
            np.concatenate([[0.0], np.sqrt(m) * scale]))
