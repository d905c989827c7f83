"""K3: the aggregation group-resolve sweep — its plain PyTorch version
(``coarsen_groups_ref``) and the wrapper of its CUDA kernel
(``csrc/coarsen.cu``, entry ``coarsen_groups_launch``).

Replaces the TPU kernel ``coarsen_groups_pallas`` of
``src/repro/kernels/aggregate/coarsen.py`` (body ``_coarsen_kernel``).  Over
the (ci, cj)-sorted relabelled slots, padded by one trailing sentinel slot
(length total + 1), slot i gets the record of the group that ends just
before it:

  g_src[i], g_dst[i] = key of slot i - 1          ((-2, -2) for i = 0)
  g_w[i]             = weight sum of slot i - 1's group through slot i - 1
  emit[i]            = slot i opens a group and g_src[i] is a live id
  pos[i]             = number of emits before slot i (the dense group index)

Bound on the card: bytes — 12 B per slot read and 17 B per slot written
once, at 3.35 TB/s.  The kernel is one launch: a single-pass segmented scan
with decoupled look-back over 4096-slot tiles in place of the TPU's
sequential SMEM carry chain; see the source's header.  Group keys and
positions are exact; weight sums agree with the reference bit for bit when
they are exact in float32 (integer-valued weights below 2^24) and otherwise
within m * 2^-23 * sum |w| over the m slots summed.  The kernel's output is
bit-identical from call to call, float weights included.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build


def coarsen_groups_ref(s_ci: torch.Tensor, s_cj: torch.Tensor,
                       s_w: torch.Tensor, *, sent: int
                       ) -> Tuple[torch.Tensor, ...]:
    """Plain version of K3 on any device: (emit bool, pos, g_src, g_dst
    int32, g_w float32), each of length total + 1.  Open-group sums are
    float64 prefix differences rounded once to float32."""
    dev = s_ci.device
    pad_i = torch.full((1,), sent, dtype=torch.int32, device=dev)
    phantom = torch.full((1,), -2, dtype=torch.int32, device=dev)
    ci = torch.cat([s_ci.to(torch.int32), pad_i])
    cj = torch.cat([s_cj.to(torch.int32), pad_i])
    w = torch.cat([s_w.to(torch.float64),
                   torch.zeros(1, dtype=torch.float64, device=dev)])
    prev_ci = torch.cat([phantom, ci[:-1]])
    prev_cj = torch.cat([phantom, cj[:-1]])
    is_first = (ci != prev_ci) | (cj != prev_cj)
    emit = is_first & (prev_ci != sent) & (prev_ci >= 0)
    em = emit.to(torch.int32)
    pos = (torch.cumsum(em, 0, dtype=torch.int32) - em)

    incl = torch.cumsum(w, 0)
    gid = torch.cumsum(is_first.to(torch.int64), 0) - 1
    group_base = (incl - w)[is_first]          # prefix before each group
    open_sum = (incl - group_base[gid]).to(torch.float32)
    g_w = torch.cat([torch.zeros(1, dtype=torch.float32, device=dev),
                     open_sum[:-1]])
    return emit, pos, prev_ci, prev_cj, g_w


#: Slots per tile of the kernel (``kTile`` in ``csrc/segscan.cuh``, which
#: the kernel checks: it refuses any other value).
CHUNK_SLOTS = 4096


_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_void_p] * 7)


def coarsen_groups(s_ci: torch.Tensor, s_cj: torch.Tensor, s_w: torch.Tensor,
                   *, sent: int) -> Tuple[torch.Tensor, ...]:
    """K3: per-slot group records over a sorted relabelled slot list.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel (and counts the launch in ``coarsen_groups.launches``).
    """
    if s_ci.device.type == "cpu":
        return coarsen_groups_ref(s_ci, s_cj, s_w, sent=sent)
    dev = s_ci.device
    total = s_ci.shape[0]
    for t, dt in ((s_ci, torch.int32), (s_cj, torch.int32),
                  (s_w, torch.float32)):
        if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                or t.shape != (total,)):
            raise ValueError(f"coarsen_groups input must be a contiguous "
                             f"({total},) {dt} tensor on {dev}")
    if total + 1 >= 2 ** 31:
        raise ValueError(f"coarsen_groups takes fewer than 2^31 slots, "
                         f"got {total}")
    fn = _build.entry("coarsen", "coarsen_groups_launch", _ARGTYPES)
    n_tiles = (total + CHUNK_SLOTS) // CHUNK_SLOTS   # ceil((total+1)/tile)
    # The tiles' status words and the tile counter, zeroed on every call.
    scratch = torch.zeros(2 * n_tiles + 1, dtype=torch.int64, device=dev)
    n = total + 1
    emit = torch.empty(n, dtype=torch.bool, device=dev)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    g_src = torch.empty(n, dtype=torch.int32, device=dev)
    g_dst = torch.empty(n, dtype=torch.int32, device=dev)
    g_w = torch.empty(n, dtype=torch.float32, device=dev)
    err = fn(s_ci.data_ptr(), s_cj.data_ptr(), s_w.data_ptr(), total,
             int(sent), CHUNK_SLOTS, scratch.data_ptr(), emit.data_ptr(),
             pos.data_ptr(), g_src.data_ptr(), g_dst.data_ptr(),
             g_w.data_ptr(),
             _build.current_stream_handle(dev))
    _build.check(err, "coarsen_groups")
    coarsen_groups.launches += 1
    return emit, pos, g_src, g_dst, g_w


coarsen_groups.launches = 0
