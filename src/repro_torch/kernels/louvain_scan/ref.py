"""Plain PyTorch oracle of the ELL best-community scan (K2's plain version,
at (R,) outputs) — the counterpart of ``repro.kernels.louvain_scan.ref``.
Semantics are documented in ``louvain_scan.py``."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.louvain_scan.louvain_scan import dense_scan_tile


def louvain_scan_ref(c_nbr, w_nbr, sigma_nbr, k_i, c_own, sigma_own,
                     m) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_c int32 — -1 if no valid slot, best_dq float32) per row, on
    any device."""
    best_c, best_dq = dense_scan_tile(c_nbr, w_nbr, sigma_nbr, k_i, c_own,
                                      sigma_own, m)
    return best_c[:, 0], best_dq[:, 0]
