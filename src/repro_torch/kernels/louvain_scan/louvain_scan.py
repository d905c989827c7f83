"""K2: the Louvain best-community scan over one degree bucket's CSR rows —
its plain PyTorch version (``louvain_scan_rows_ref``) and the wrapper of
its CUDA kernel (``csrc/louvain_scan.cu``, entry ``louvain_scan_launch``).

Replaces the TPU kernel ``louvain_scan_pallas`` of
``src/repro/kernels/louvain_scan/louvain_scan.py`` (body ``_scan_kernel`` over
``dense_scan_tile``) together with the per-slot gathers the JAX package
leaves to XLA (``prepare_ell_inputs``).  The kernel reads only the rows'
live CSR slots, gathers the community state itself and groups slots by
community label; see the source's header for its design, bound and
exactness rules.

Per row r (one vertex i) of a padded tile (dead slots: c = -1, w = 0):
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

from repro_torch.core.graph import ELLBlock, ell_block
from repro_torch.kernels import _build

_INT_MAX = 2 ** 31 - 1
#: Shared memory per CUDA block that the warp layout stays within (no
#: opt-in).
_SMEM_BYTES = 48 * 1024
#: Shared memory per sorted slot: a 64-bit (community, slot) key + a weight.
_SLOT_BYTES = 12
#: Widths up to this take one row per thread, no shared memory
#: (``kLaneSlots`` of the source, which picks the layout by width).
LANE_SLOTS = 16
#: The widest row the warp sort takes (32 keys per lane in registers); wider
#: rows take one CUDA block each.
WARP_MAX_WIDTH = 1024
#: The widest row the kernels take: a one-row block stages 12 B per sorted
#: slot in dynamic shared memory, 196,608 B at this width, of the 227 KB a
#: Hopper block may opt in to.
MAX_WIDTH = 16384
#: Threads of a one-row block (``kCtaThreads`` of the source).
CTA_THREADS = 512


class ELLWidthError(ValueError):
    """An ELL bucket width outside 1 .. ``MAX_WIDTH``: no layout of the
    kernels K1/K2 takes it."""


def check_ell_width(width: int) -> None:
    """Raise ``ELLWidthError`` unless 0 < ``width`` <= ``MAX_WIDTH``."""
    if not 0 < width <= MAX_WIDTH:
        raise ELLWidthError(f"ELL width {width} is outside the kernels' "
                            f"range 1 .. {MAX_WIDTH}")


def sort_capacity(width: int) -> int:
    """Keys per warp (per block above ``WARP_MAX_WIDTH``) in shared memory:
    the next power of two >= ``width``, at least 32 (a row of up to 32
    slots is grouped in registers)."""
    cap = 32
    while cap < width:
        cap *= 2
    return cap


def warps_for_width(width: int) -> int:
    """Warps per CUDA block: up to ``WARP_MAX_WIDTH`` at most 8, and few
    enough that their sort buffers fit 48 KB; above it the
    ``CTA_THREADS`` of one row's block."""
    check_ell_width(width)
    if width > WARP_MAX_WIDTH:
        return CTA_THREADS // 32
    return min(8, _SMEM_BYTES // (_SLOT_BYTES * sort_capacity(width)))


def block_rows_for_width(width: int) -> int:
    """Rows per CUDA block: one per thread at widths <= ``LANE_SLOTS``, one
    per warp up to ``WARP_MAX_WIDTH``, one per block above."""
    warps = warps_for_width(width)
    if width > WARP_MAX_WIDTH:
        return 1
    return warps * (32 if width <= LANE_SLOTS else 1)


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


def prepare_ell_inputs(block: ELLBlock, comm: torch.Tensor,
                       sigma: torch.Tensor, k: torch.Tensor,
                       n_cap: int) -> Tuple[torch.Tensor, ...]:
    """Gather per-slot community state for one ELL block: (c_nbr, w_nbr,
    sigma_nbr) as (R, D) and (k_i, c_own, sigma_own) as (R, 1).  Padding and
    self-loop slots are dead: c = -1, w = 0, Sigma = 0."""
    rows, cols, w = block.rows, block.cols, block.w
    dead = (cols == n_cap) | (cols == rows[:, None])
    c_nbr = torch.where(dead, -1, comm[cols])
    w_nbr = torch.where(dead, 0.0, w)
    sigma_nbr = torch.where(dead, 0.0, sigma[c_nbr.clamp(min=0)])
    k_i = k[rows][:, None]
    c_own = comm[rows][:, None]
    sigma_own = sigma[c_own[:, 0]][:, None]
    return c_nbr, w_nbr, sigma_nbr, k_i, c_own, sigma_own


def louvain_scan_rows_ref(rows, indptr, indices, weights, comm, sigma, k, m,
                          *, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 on any device: the bucket's padded tile built
    from the CSR (``ell_block``), gathered (``prepare_ell_inputs``) and
    scanned (``dense_scan_tile``); (best_c, best_dq) as (R,) tensors."""
    block = ell_block(indptr, indices, weights, rows, width)
    bc, bdq = dense_scan_tile(*prepare_ell_inputs(
        block, comm, sigma, k, indptr.numel() - 1), m)
    return bc[:, 0], bdq[:, 0]


def check_inputs(named, device) -> None:
    """Each (name, tensor, dtype, length) must be a contiguous 1-d tensor of
    that dtype on ``device``, of that length unless it is None."""
    for name, t, dt, n in named:
        if (not isinstance(t, torch.Tensor) or t.device != device
                or t.dtype != dt or not t.is_contiguous() or t.dim() != 1):
            got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
                   if isinstance(t, torch.Tensor) else type(t).__name__)
            raise ValueError(f"kernel input {name} must be a contiguous 1-d "
                             f"{dt} tensor on {device}; got {got}")
        if n is not None and t.numel() != n:
            raise ValueError(f"kernel input {name} has {t.numel()} entries, "
                             f"not {n}")


def graph_inputs(rows, indptr, indices, weights, comm, sigma, k):
    """What both kernels check: the (name, tensor, dtype, length) list of
    their common inputs, with n_cap = len(indptr) - 1."""
    n_cap = indptr.numel() - 1
    return [("rows", rows, torch.int32, None),
            ("indptr", indptr, torch.int32, None),
            ("indices", indices, torch.int32, None),
            ("weights", weights, torch.float32, indices.numel()),
            ("comm", comm, torch.int32, n_cap + 1),
            ("sigma", sigma, torch.float32, n_cap + 1),
            ("k", k, torch.float32, n_cap + 1)], n_cap


def scalar_m(m: torch.Tensor, device) -> torch.Tensor:
    if (not isinstance(m, torch.Tensor) or m.numel() != 1
            or m.dtype != torch.float32 or m.device != device):
        raise ValueError("m must be a one-element float32 tensor on the "
                         "rows' device")
    return m.contiguous()


def raise_on_error(err: torch.Tensor, what: str, width: int) -> None:
    """Raise when the kernel flagged a row (one device-to-host read)."""
    code = int(err.item())
    if code & 1:
        raise ValueError(f"{what}: a row's degree exceeds ELL width {width}")
    if code:
        raise ValueError(f"{what}: a row id lies outside [0, n_cap]")


_SCAN_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                  + [ctypes.c_void_p])


def launch_louvain_scan(rows, indptr, indices, weights, comm, sigma, k, m,
                        *, width: int):
    """Check the inputs, launch K2 on their CUDA device and count the
    launch; returns (best_c, best_dq, err) without reading ``err`` (the
    kernel's flag of rows it rejected), so nothing waits for the kernel."""
    dev = rows.device
    named, n_cap = graph_inputs(rows, indptr, indices, weights, comm, sigma,
                                k)
    check_inputs(named, dev)
    rows_per_block = block_rows_for_width(width)
    m = scalar_m(m, dev)
    r = rows.numel()
    out_c = torch.empty(r, dtype=torch.int32, device=dev)
    out_dq = torch.empty(r, dtype=torch.float32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = _build.entry("louvain_scan", "louvain_scan_launch", _SCAN_ARGTYPES)
    code = fn(rows.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
              weights.data_ptr(), comm.data_ptr(), sigma.data_ptr(),
              k.data_ptr(), m.data_ptr(), r, n_cap, int(width),
              out_c.data_ptr(), out_dq.data_ptr(), err.data_ptr(),
              rows_per_block, sort_capacity(width),
              _build.current_stream_handle(dev))
    _build.check(code, "louvain_scan")
    louvain_scan.launches += 1
    if width > WARP_MAX_WIDTH:
        louvain_scan.cta_launches += 1
    return out_c, out_dq, err


def louvain_scan(rows, indptr, indices, weights, comm, sigma, k, m, *,
                 width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: best (community, dQ) per row of one degree bucket, as (R,)
    tensors.  ``rows`` are vertex ids (``n_cap`` = a pad row) of degree at
    most ``width``; ``indptr``/``indices``/``weights`` the CSR;
    ``comm``/``sigma``/``k`` the (n_cap + 1,) per-vertex state; ``m`` a
    one-element float32 tensor.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel (``launch_louvain_scan``, counted in
    ``louvain_scan.launches``), then reads the kernel's error flag and
    raises on a row above ``width``.
    """
    if rows.device.type == "cpu":
        return louvain_scan_rows_ref(rows, indptr, indices, weights, comm,
                                     sigma, k, m, width=width)
    out_c, out_dq, err = launch_louvain_scan(
        rows, indptr, indices, weights, comm, sigma, k, m, width=width)
    raise_on_error(err, "louvain_scan", width)
    return out_c, out_dq


louvain_scan.launches = 0
#: Launches of the one-row-per-block layout (widths above 1024), also
#: counted in ``launches``.
louvain_scan.cta_launches = 0
