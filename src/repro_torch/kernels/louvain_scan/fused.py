"""K1: the fused ELL scan + gated move decision over one degree bucket's CSR
rows — its plain PyTorch version (``louvain_fused_rows_ref``, over the tile
function ``louvain_fused_ref``) and the wrapper of its CUDA kernel
(``csrc/louvain_scan.cu``, entry ``louvain_fused_launch``).

Replaces the TPU kernel ``louvain_fused_pallas`` of
``src/repro/kernels/louvain_scan/fused.py`` (body ``_make_fused_kernel`` =
``dense_scan_tile`` + ``fused_decision_tile``) together with the gathers of
``prepare_fused_inputs``.  Each row leaves the kernel with its whole
decision made: the improvement test, the singleton-swap guard
(|best community| = ``sizes[best_c]``), the in-kernel Weyl round gate and
the frontier mask.  It shares K2's scan (see the source's header for the
design, bound and exactness rules) and decides in registers.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.engine import round_gate
from repro_torch.core.graph import ELLBlock, ell_block
from repro_torch.kernels import _build
from repro_torch.kernels.louvain_scan.louvain_scan import (
    SMEM_MAX_WIDTH, WARP_MAX_WIDTH, block_rows_for_width, check_inputs,
    dense_scan_tile, graph_inputs, launch_scratch, prepare_ell_inputs,
    raise_on_error, scalar_m)

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
    """Plain version of the TPU kernel's tile function on any device:
    (best_c, best_dq, do_move int32) as (R,) tensors."""
    best_c, best_dq = dense_scan_tile(c_nbr, w_nbr, sigma_nbr, k_i, c_own,
                                      sigma_own, m)
    bc, bdq, do_move = fused_decision_tile(
        c_nbr, size_nbr, size_own, best_c, best_dq, c_own, rows, front > 0,
        round_ix, gate_fraction=gate_fraction, sentinel=sentinel)
    return bc[:, 0], bdq[:, 0], do_move[:, 0].to(torch.int32)


def prepare_fused_inputs(block: ELLBlock, comm: torch.Tensor,
                         sigma: torch.Tensor, sizes: torch.Tensor,
                         k: torch.Tensor, front: torch.Tensor,
                         n_cap: int) -> Tuple[torch.Tensor, ...]:
    """``prepare_ell_inputs`` plus the decision inputs of K1: per-slot and
    per-row community sizes, the row's vertex id and its frontier bit
    (frontier & move-valid, as int32)."""
    c_nbr, w_nbr, sigma_nbr, k_i, c_own, sigma_own = prepare_ell_inputs(
        block, comm, sigma, k, n_cap)
    size_nbr = torch.where(c_nbr < 0, 0, sizes[c_nbr.clamp(min=0)])
    size_own = sizes[c_own[:, 0]][:, None]
    rows = block.rows[:, None]
    front_rows = front[block.rows][:, None].to(torch.int32)
    return (c_nbr, w_nbr, sigma_nbr, size_nbr, k_i, c_own, sigma_own,
            size_own, rows, front_rows)


def louvain_fused_rows_ref(rows, indptr, indices, weights, comm, sigma,
                           sizes, k, front, m, round_ix, *, width: int,
                           gate_fraction: int, sentinel: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Plain version of K1 on any device: the bucket's padded tile built
    from the CSR (``ell_block``), gathered (``prepare_fused_inputs``) and
    decided (``louvain_fused_ref``)."""
    block = ell_block(indptr, indices, weights, rows, width)
    ins = prepare_fused_inputs(block, comm, sigma, sizes, k, front,
                               indptr.numel() - 1)
    return louvain_fused_ref(*ins, m, round_ix, gate_fraction=gate_fraction,
                             sentinel=sentinel)


_FUSED_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def launch_louvain_fused(rows, indptr, indices, weights, comm, sigma, sizes,
                         k, front, m, round_ix: int, *, width: int,
                         gate_fraction: int, sentinel: int):
    """Check the inputs, launch K1 on their CUDA device and count the
    launch; returns (best_c, best_dq, do_move, err) without reading ``err``
    (the kernel's flag of rows it rejected)."""
    dev = rows.device
    named, n_cap = graph_inputs(rows, indptr, indices, weights, comm, sigma,
                                k)
    check_inputs(named + [("sizes", sizes, torch.int32, n_cap + 1),
                          ("front", front, torch.bool, n_cap + 1)], dev)
    rows_per_block = block_rows_for_width(width)
    m = scalar_m(m, dev)
    r = rows.numel()
    out_c = torch.empty(r, dtype=torch.int32, device=dev)
    out_dq = torch.empty(r, dtype=torch.float32, device=dev)
    out_mv = torch.empty(r, dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    cap, scratch, blocks = launch_scratch(width, rows, indices)
    fn = _build.entry("louvain_scan", "louvain_fused_launch",
                      _FUSED_ARGTYPES)
    code = fn(rows.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
              weights.data_ptr(), comm.data_ptr(), sigma.data_ptr(),
              k.data_ptr(), sizes.data_ptr(), front.data_ptr(), m.data_ptr(),
              r, n_cap, int(width), int(round_ix), int(gate_fraction),
              int(sentinel), out_c.data_ptr(), out_dq.data_ptr(),
              out_mv.data_ptr(), err.data_ptr(), rows_per_block, cap,
              None if scratch is None else scratch.data_ptr(), blocks,
              _build.current_stream_handle(dev))
    _build.check(code, "louvain_fused")
    louvain_fused.launches += 1
    if width > SMEM_MAX_WIDTH:
        louvain_fused.wide_launches += 1
    elif width > WARP_MAX_WIDTH:
        louvain_fused.cta_launches += 1
    return out_c, out_dq, out_mv, err


def louvain_fused(rows, indptr, indices, weights, comm, sigma, sizes, k,
                  front, m, round_ix: int, *, width: int, gate_fraction: int,
                  sentinel: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: fused (best_c, best_dq, do_move) per row of one degree bucket,
    as (R,) tensors.  Inputs as ``louvain_scan``'s, plus ``sizes`` (int32
    |community| per id) and ``front`` (bool frontier & move-valid), both
    (n_cap + 1,).

    On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel (``launch_louvain_fused``, counted in
    ``louvain_fused.launches``), then reads the kernel's error flag and
    raises on a row above ``width``.
    """
    if rows.device.type == "cpu":
        return louvain_fused_rows_ref(
            rows, indptr, indices, weights, comm, sigma, sizes, k, front, m,
            round_ix, width=width, gate_fraction=gate_fraction,
            sentinel=sentinel)
    *out, err = launch_louvain_fused(
        rows, indptr, indices, weights, comm, sigma, sizes, k, front, m,
        round_ix, width=width, gate_fraction=gate_fraction,
        sentinel=sentinel)
    raise_on_error(err, "louvain_fused", width)
    return tuple(out)


louvain_fused.launches = 0
#: Launches of the one-row-per-block layout in shared memory (widths 1025
#: to ``SMEM_MAX_WIDTH``), also counted in ``launches``.
louvain_fused.cta_launches = 0
#: Launches of the one-row-per-block layout in global scratch (widths above
#: ``SMEM_MAX_WIDTH``), also counted in ``launches``.
louvain_fused.wide_launches = 0
