"""K2: the Louvain best-community scan over ELL rows — its plain PyTorch
version (``dense_scan_tile``) and the wrapper of its CUDA kernel
(``csrc/louvain_scan.cu``, entry ``louvain_scan_launch``).

Replaces the TPU kernel ``louvain_scan_pallas`` of
``src/repro/kernels/louvain_scan/louvain_scan.py`` (body ``_scan_kernel`` over
``dense_scan_tile``).  Bound on the card: bytes — c at every slot, w at every
occupied slot, Sigma at every candidate slot, 12 B per row read once and
8 B per row written, at 3.35 TB/s.  The kernel reads c and w of every slot
from device memory once, padding included, and keeps the pairwise compare
in shared memory (one warp per row); see the source's header.

Per row r (one vertex i), inputs pre-masked (dead slots: c = -1, w = 0):
  K_{i->c_d} = sum_e w[r,e] * [c[r,e] == c[r,d]]
  K_{i->own} = sum_e w[r,e] * [c[r,e] == c_own[r]]
  dQ_d       = (K_d - K_own)/m - k_i*(k_i + Sigma_{c_d} - Sigma_own)/(2 m^2)
  best       = argmax dQ over valid slots (c_d >= 0, c_d != c_own), ties to
               the smallest community id; (-1, -inf) when there is none.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

_INT_MAX = 2 ** 31 - 1
#: Shared memory per CUDA block that the launch stays within (no opt-in).
_SMEM_BYTES = 48 * 1024


def block_rows_for_width(width: int) -> int:
    """ELL rows per CUDA block (one warp each): at most 8, and few enough
    that the rows' staged ids and weights (8 B per slot) fit 48 KB."""
    rows = min(8, _SMEM_BYTES // (8 * int(width)))
    if rows < 1:
        raise ValueError(f"ELL width {width} exceeds the kernel's shared "
                         f"memory ({_SMEM_BYTES // 8} slots per row at most)")
    return rows


def dense_scan_tile(c, w, sig, k_i, c_own, sig_own, m):
    """Plain PyTorch scan of a (R, D) tile; returns ((R, 1) int32 best
    community with -1 = none, (R, 1) float32 best dQ with -inf = none).

    Row sums run over the slots in ascending order, one float32 add per
    slot, and dQ is evaluated in the reference's operation order: exactly
    the CUDA kernel's arithmetic, so the two agree bit for bit.  ``m`` is a
    0-d float32 tensor on the tile's device.
    """
    w = w.to(torch.float32)
    sig = sig.to(torch.float32)
    k_i = k_i.to(torch.float32)
    sig_own = sig_own.to(torch.float32)
    k_to = torch.zeros_like(w)
    k_own = torch.zeros_like(k_i)
    for e in range(c.shape[1]):
        ce, we = c[:, e:e + 1], w[:, e:e + 1]
        k_to = k_to + torch.where((c == ce) & (ce >= 0), we, 0.0)
        k_own = k_own + torch.where(ce == c_own, we, 0.0)

    dq = (k_to - k_own) / m - k_i * (k_i + sig - sig_own) / (2.0 * m * m)
    valid = (c >= 0) & (c != c_own)
    dq = torch.where(valid, dq, float("-inf"))
    best_dq = torch.amax(dq, dim=1, keepdim=True)
    is_best = (dq == best_dq) & valid
    best_c = torch.amin(torch.where(is_best, c, _INT_MAX), dim=1,
                        keepdim=True)
    found = torch.isfinite(best_dq)
    return (torch.where(found, best_c, -1).to(torch.int32),
            torch.where(found, best_dq, float("-inf")))


def _check_tile(tensors, dtypes, n_rows: int, width: int, device) -> None:
    for t, dt in zip(tensors, dtypes):
        if t.device != device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"kernel input must be a contiguous {dt} tensor "
                             f"on {device}; got {t.dtype} on {t.device}")
        if t.numel() not in (n_rows * width, n_rows):
            raise ValueError(f"kernel input of shape {tuple(t.shape)} does "
                             f"not fit {n_rows} rows of width {width}")


def _scalar_m(m: torch.Tensor, device) -> torch.Tensor:
    if (not isinstance(m, torch.Tensor) or m.numel() != 1
            or m.dtype != torch.float32 or m.device != device):
        raise ValueError("m must be a one-element float32 tensor on the "
                         "tiles' device")
    return m.contiguous()


_SCAN_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                  + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])


def louvain_scan(c_nbr, w_nbr, sigma_nbr, k_i, c_own, sigma_own,
                 m) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: best (community, dQ) per ELL row, as (R,) tensors.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel (and counts the launch in ``louvain_scan.launches``).
    """
    if c_nbr.device.type == "cpu":
        bc, bdq = dense_scan_tile(c_nbr, w_nbr, sigma_nbr, k_i, c_own,
                                  sigma_own, m)
        return bc[:, 0], bdq[:, 0]
    dev = c_nbr.device
    r, d = c_nbr.shape
    _check_tile((c_nbr, w_nbr, sigma_nbr, k_i, c_own, sigma_own),
                (torch.int32, torch.float32, torch.float32, torch.float32,
                 torch.int32, torch.float32), r, d, dev)
    m = _scalar_m(m, dev)
    out_c = torch.empty(r, dtype=torch.int32, device=dev)
    out_dq = torch.empty(r, dtype=torch.float32, device=dev)
    fn = _build.entry("louvain_scan", "louvain_scan_launch", _SCAN_ARGTYPES)
    err = fn(c_nbr.data_ptr(), w_nbr.data_ptr(), sigma_nbr.data_ptr(),
             k_i.data_ptr(), c_own.data_ptr(), sigma_own.data_ptr(),
             m.data_ptr(), r, d, out_c.data_ptr(), out_dq.data_ptr(),
             block_rows_for_width(d), _build.current_stream_handle(dev))
    _build.check(err, "louvain_scan")
    louvain_scan.launches += 1
    return out_c, out_dq


louvain_scan.launches = 0
