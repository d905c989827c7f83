"""K1: the fused ELL scan + gated move decision — its plain PyTorch version
(``louvain_fused_ref``) and the wrapper of its CUDA kernel
(``csrc/louvain_scan.cu``, entry ``louvain_fused_launch``).

Replaces the TPU kernel ``louvain_fused_pallas`` of
``src/repro/kernels/louvain_scan/fused.py`` (body ``_make_fused_kernel`` =
``dense_scan_tile`` + ``fused_decision_tile``).  Each row leaves the kernel
with its whole decision made: the improvement test, the singleton-swap guard
(|best community| as a masked row-min over the pre-gathered slot sizes), the
in-kernel Weyl round gate and the frontier mask.  Bound on the card: bytes —
c at every slot, w at every occupied slot, Sigma and |c| at every candidate
slot, 24 B per row read once and 12 B per row written, at 3.35 TB/s; the
kernel reads c and w of every slot once, padding included, and decides in
registers (see the source's header for its design and exactness hazards).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.engine import round_gate
from repro_torch.kernels import _build
from repro_torch.kernels.louvain_scan.louvain_scan import (
    _check_tile, _scalar_m, block_rows_for_width, dense_scan_tile)

_INT_MAX = 2 ** 31 - 1


def fused_decision_tile(c, size_nbr, size_own, best_c, best_dq, c_own, rows,
                        front, round_ix, *, gate_fraction: int,
                        sentinel: int):
    """The gated move decision on one tile, mirroring
    ``engine.gated_move_mask`` with the size lookups pre-gathered per slot.
    Returns (best_c mapped to ``sentinel`` when none, best_dq masked to -inf
    off the frontier, do_move) as (R, 1) tensors."""
    found = best_c >= 0
    bc = torch.where(found, best_c, sentinel).to(torch.int32)
    valid = (c >= 0) & (c != c_own)
    size_best = torch.amin(
        torch.where((c == bc) & valid, size_nbr, _INT_MAX), dim=1,
        keepdim=True)
    own_single = size_own == 1
    tgt_single = size_best == 1
    swap_blocked = own_single & tgt_single & (bc > c_own)
    do_move = ((best_dq > 0.0) & (bc != c_own) & (bc < sentinel)
               & front & ~swap_blocked)
    if gate_fraction > 1:
        do_move = do_move & round_gate(rows, round_ix, gate_fraction)
    best_dq = torch.where(front, best_dq, float("-inf"))
    return bc, best_dq, do_move


def louvain_fused_ref(c_nbr, w_nbr, sigma_nbr, size_nbr, k_i, c_own,
                      sigma_own, size_own, rows, front, m, round_ix, *,
                      gate_fraction: int, sentinel: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K1 on any device: (best_c, best_dq, do_move int32)
    as (R,) tensors."""
    best_c, best_dq = dense_scan_tile(c_nbr, w_nbr, sigma_nbr, k_i, c_own,
                                      sigma_own, m)
    bc, bdq, do_move = fused_decision_tile(
        c_nbr, size_nbr, size_own, best_c, best_dq, c_own, rows, front > 0,
        round_ix, gate_fraction=gate_fraction, sentinel=sentinel)
    return bc[:, 0], bdq[:, 0], do_move[:, 0].to(torch.int32)


_FUSED_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])


def louvain_fused(c_nbr, w_nbr, sigma_nbr, size_nbr, k_i, c_own, sigma_own,
                  size_own, rows, front, m, round_ix: int, *,
                  gate_fraction: int, sentinel: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: fused (best_c, best_dq, do_move) per ELL row, as (R,) tensors.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel (and counts the launch in ``louvain_fused.launches``).
    """
    if c_nbr.device.type == "cpu":
        return louvain_fused_ref(c_nbr, w_nbr, sigma_nbr, size_nbr, k_i,
                                 c_own, sigma_own, size_own, rows, front, m,
                                 round_ix, gate_fraction=gate_fraction,
                                 sentinel=sentinel)
    dev = c_nbr.device
    r, d = c_nbr.shape
    _check_tile((c_nbr, w_nbr, sigma_nbr, size_nbr, k_i, c_own, sigma_own,
                 size_own, rows, front),
                (torch.int32, torch.float32, torch.float32, torch.int32,
                 torch.float32, torch.int32, torch.float32, torch.int32,
                 torch.int32, torch.int32), r, d, dev)
    m = _scalar_m(m, dev)
    out_c = torch.empty(r, dtype=torch.int32, device=dev)
    out_dq = torch.empty(r, dtype=torch.float32, device=dev)
    out_mv = torch.empty(r, dtype=torch.int32, device=dev)
    fn = _build.entry("louvain_scan", "louvain_fused_launch",
                      _FUSED_ARGTYPES)
    err = fn(c_nbr.data_ptr(), w_nbr.data_ptr(), sigma_nbr.data_ptr(),
             size_nbr.data_ptr(), k_i.data_ptr(), c_own.data_ptr(),
             sigma_own.data_ptr(), size_own.data_ptr(), rows.data_ptr(),
             front.data_ptr(), m.data_ptr(), int(round_ix), r, d,
             int(gate_fraction), int(sentinel), out_c.data_ptr(),
             out_dq.data_ptr(), out_mv.data_ptr(), block_rows_for_width(d),
             _build.current_stream_handle(dev))
    _build.check(err, "louvain_fused")
    louvain_fused.launches += 1
    return out_c, out_dq, out_mv


louvain_fused.launches = 0
