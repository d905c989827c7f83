"""K4: the batch-apply group-resolve sweep — its plain PyTorch version
(``resolve_groups_ref``) and the wrapper of its CUDA kernel
(``csrc/batch_apply.cu``, entry ``resolve_groups_launch``).

Replaces the TPU kernel ``resolve_groups_pallas`` of
``src/repro/kernels/batch_apply/resolve.py`` (body ``_resolve_kernel``).
Over the (src, dst)-sorted unified slot list of one edge batch (existing
slots and batch slots, dead slots keyed ``(sent, sent)``), padded by one
trailing sentinel slot (length total + 1), slot i gets the record of the
group that ends just before it:

  src[i], dst[i] = key of slot i - 1               ((-2, -2) for i = 0)
  w[i]           = weight of slot i - 1            (last write wins)
  old_w          = weight of the group's first slot, or 0 when that slot
                   is a batch slot (an insert)
  keep[i]        = slot i opens a group, src[i] != sent and w[i] > 0
  changed[i]     = slot i opens a group, src[i] != sent, slot i - 1 is a
                   batch slot and old_w != w[i]
  pos[i]         = number of keeps before slot i (the compacted position)

Weights are selected, never summed, so the kernel equals the plain version
bit for bit (the float ``!=`` compare included).  Bound on the card: bytes —
13 B per slot read (src, dst, w, batch flag) and 18 B per slot written
(keep, pos, src, dst, w, changed), once each, at 3.35 TB/s.  The kernel is
two exact scans over the sorted list (an exclusive sum of ``keep`` and a max
of each group's start index) in one launch, a single-pass scan with
decoupled look-back over 4096-slot tiles; see the source's header.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build


def resolve_groups_ref(s_src: torch.Tensor, s_dst: torch.Tensor,
                       s_w: torch.Tensor, s_batch: torch.Tensor, *,
                       sent: int) -> Tuple[torch.Tensor, ...]:
    """Plain version of K4 on any device: (keep bool, pos int32, src int32,
    dst int32, w float32, changed bool), each of length total + 1."""
    dev = s_src.device

    def shift(x, first):
        # (x with one trailing pad slot) shifted right by one slot.
        return torch.cat([torch.full((1,), first, dtype=x.dtype, device=dev),
                          x])

    src = torch.cat([s_src.to(torch.int32),
                     torch.full((1,), sent, dtype=torch.int32, device=dev)])
    dst = torch.cat([s_dst.to(torch.int32),
                     torch.full((1,), sent, dtype=torch.int32, device=dev)])
    prev_src = shift(s_src.to(torch.int32), -2)
    prev_dst = shift(s_dst.to(torch.int32), -2)
    prev_w = shift(s_w.to(torch.float32), 0.0)
    prev_b = shift(s_batch.to(torch.bool), False)
    is_first = (src != prev_src) | (dst != prev_dst)

    # Start index of the group holding each slot (slot 0 always opens one),
    # then the first slot's (w, batch) of the group that slot i - 1 is in.
    idx = torch.arange(src.shape[0], dtype=torch.int64, device=dev)
    start = torch.cummax(torch.where(is_first, idx, -1), 0).values
    prev_start = start[:-1]
    first_w = s_w.to(torch.float32)[prev_start]
    first_b = s_batch.to(torch.bool)[prev_start]
    old_w = shift(torch.where(first_b, 0.0, first_w), 0.0)

    live = prev_src != sent
    keep = is_first & live & (prev_w > 0.0)
    changed = is_first & live & prev_b & (old_w != prev_w)
    kp = keep.to(torch.int32)
    pos = torch.cumsum(kp, 0, dtype=torch.int32) - kp
    return keep, pos, prev_src, prev_dst, prev_w, changed


#: Slots per tile of the kernel (``kTile`` in ``csrc/segscan.cuh``, which
#: the kernel checks: it refuses any other value).
CHUNK_SLOTS = 4096

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_void_p] * 8)


def resolve_groups(s_src: torch.Tensor, s_dst: torch.Tensor,
                   s_w: torch.Tensor, s_batch: torch.Tensor, *,
                   sent: int) -> Tuple[torch.Tensor, ...]:
    """K4: per-slot group records over a sorted batch-apply slot list.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel (and counts the launch in ``resolve_groups.launches``).
    """
    if s_src.device.type == "cpu":
        return resolve_groups_ref(s_src, s_dst, s_w, s_batch, sent=sent)
    dev = s_src.device
    total = s_src.shape[0]
    for t, dt in ((s_src, torch.int32), (s_dst, torch.int32),
                  (s_w, torch.float32), (s_batch, torch.bool)):
        if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                or t.shape != (total,)):
            raise ValueError(f"resolve_groups input must be a contiguous "
                             f"({total},) {dt} tensor on {dev}")
    if total + 1 >= 2 ** 31:
        raise ValueError(f"resolve_groups takes fewer than 2^31 slots, "
                         f"got {total}")
    fn = _build.entry("batch_apply", "resolve_groups_launch", _ARGTYPES)
    n_tiles = (total + CHUNK_SLOTS) // CHUNK_SLOTS   # ceil((total+1)/tile)
    # The tiles' status words and the tile counter, zeroed on every call.
    scratch = torch.zeros(2 * n_tiles + 1, dtype=torch.int64, device=dev)
    n = total + 1
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    f_src = torch.empty(n, dtype=torch.int32, device=dev)
    f_dst = torch.empty(n, dtype=torch.int32, device=dev)
    f_w = torch.empty(n, dtype=torch.float32, device=dev)
    changed = torch.empty(n, dtype=torch.bool, device=dev)
    err = fn(s_src.data_ptr(), s_dst.data_ptr(), s_w.data_ptr(),
             s_batch.data_ptr(), total, int(sent), CHUNK_SLOTS,
             scratch.data_ptr(), keep.data_ptr(), pos.data_ptr(),
             f_src.data_ptr(), f_dst.data_ptr(), f_w.data_ptr(),
             changed.data_ptr(), _build.current_stream_handle(dev))
    _build.check(err, "resolve_groups")
    resolve_groups.launches += 1
    return keep, pos, f_src, f_dst, f_w, changed


resolve_groups.launches = 0
