"""Communication-lean exchange primitives of the sharded paths
(``repro.core.comm``), in torch.

The delta exchange (``repro_torch.core.distributed.DeltaShardedScanner``)
ships only what changed, built from these pure, group-free primitives:

  * ``pack_bits`` / ``unpack_bits`` — integer labels bit-packed into 32-bit
    lanes at the minimum width for the layout.  torch's ``uint32`` lacks
    the shifts and adds this needs, so the arithmetic runs in int64 and the
    lanes are stored as int32 bit patterns (``view(numpy.uint32)`` reads
    them as the reference's uint32 lanes);
  * ``compact_movers`` — the (local index, value) pairs of flagged slots
    rank-compacted into a static-capacity buffer;
  * ``topk_touched_deltas`` — touched communities and their deltas,
    rank-compacted in ascending id order (a cumsum, no sort and no
    ``topk``);
  * ``boundary_mask`` — the owned vertices with a live remote neighbour
    (the halo set of the hybrid state layout);
  * ``comm_plan`` / ``phase_bytes`` / ``reshard_bytes`` — bytes-on-wire
    pricing from static shapes and measured round counts.

Everything here works on one shard's tensors; nothing calls a collective.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_LANE_MASK = 0xFFFFFFFF


def label_bits(n_values: int) -> int:
    """Minimum lane width (bits) encoding values in ``[0, n_values)``."""
    if n_values <= 1:
        return 1
    return int(n_values - 1).bit_length()


def packed_lanes(count: int, width: int) -> int:
    """32-bit lanes holding ``count`` values of ``width`` bits each."""
    return -(-(count * width) // 32)


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor of the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _check_width(width: int) -> None:
    if not 1 <= width <= 32:
        raise ValueError(f"width must be in [1, 32]; got {width}")


def pack_bits(values: torch.Tensor, width: int) -> torch.Tensor:
    """Bit-pack ``(..., k)`` integers in ``[0, 2**width)`` into 32-bit
    lanes, returned as an int32 tensor ``(..., lanes)`` of the lanes' bit
    patterns; each row along the leading axes (a fleet's tenant lanes)
    packs on its own, as a 1-D tensor would.

    Little-endian bit order: value i occupies global bits ``[i * width,
    (i + 1) * width)``; a value may straddle two lanes.  Values are masked
    to ``width`` bits.  Inverse: ``unpack_bits(lanes, width, k)``.
    """
    _check_width(width)
    dev = values.device
    lead, k = values.shape[:-1], values.shape[-1]
    rows = values.reshape(int(np.prod(lead, dtype=np.int64)), k)
    lanes = packed_lanes(k, width)
    vals = rows.to(torch.int64) & ((1 << width) - 1)
    start = torch.arange(k, dtype=torch.int64, device=dev) * width
    # Row b's lanes live at [b * (lanes + 1), (b + 1) * (lanes + 1)): the
    # last of each row takes the bits above its final lane.
    base = (torch.arange(rows.shape[0], dtype=torch.int64, device=dev)
            * (lanes + 1))[:, None]
    lane0 = base + start // 32
    off = start % 32
    lo = (vals << off) & _LANE_MASK
    # A shift by 32 is guarded as in the reference: off == 0 means the
    # value lies wholly inside lane0 and contributes nothing upward.
    hi = torch.where(off > 0, vals >> torch.where(off > 0, 32 - off, 0), 0)
    # Disjoint bit ranges per lane, so the adds assemble without carries.
    buf = torch.zeros(rows.shape[0] * (lanes + 1), dtype=torch.int64,
                      device=dev)
    buf.index_add_(0, lane0.reshape(-1), lo.reshape(-1))
    buf.index_add_(0, (lane0 + 1).reshape(-1), hi.reshape(-1))
    out = buf.view(rows.shape[0], lanes + 1)[:, :lanes]
    return _to_int32_bits(out).reshape(*lead, lanes)


def unpack_bits(lanes: torch.Tensor, width: int, count: int) -> torch.Tensor:
    """Inverse of ``pack_bits``: ``(..., L)`` lanes (int32 bit patterns) ->
    ``(..., count)`` int32 (a 32-bit value wraps, as the reference's uint32
    -> int32 cast does)."""
    _check_width(width)
    dev = lanes.device
    start = torch.arange(count, dtype=torch.int64, device=dev) * width
    lane0 = start // 32
    off = start % 32
    ext = torch.cat([lanes.to(torch.int64) & _LANE_MASK,
                     torch.zeros(*lanes.shape[:-1], 1, dtype=torch.int64,
                                 device=dev)], -1)
    lo = ext[..., lane0] >> off
    hi = torch.where(
        off > 0,
        (ext[..., lane0 + 1] << torch.where(off > 0, 32 - off, 0))
        & _LANE_MASK,
        0)
    return _to_int32_bits((lo | hi) & ((1 << width) - 1))


def compact_movers(flag: torch.Tensor, values: torch.Tensor, cap: int, fill):
    """Rank-compact flagged slots' (local index, value) into static buffers,
    along the last axis (each row of a ``(..., L)`` input on its own).

    Returns ``(idx_buf (..., cap), val_buf (..., cap), n_flagged (...))``:
    ``idx_buf`` holds the local indices of the first ``cap`` flagged
    entries (empty slots carry ``L = flag.shape[-1]``), ``val_buf`` their
    values (empty slots ``fill``).  Entries beyond ``cap`` go to a scratch
    slot that is cut off; ``n_flagged`` (int32) is the true uncapped count,
    so callers detect ``n_flagged > cap`` and take a dense fallback.
    """
    L = flag.shape[-1]
    dev = flag.device
    rank = torch.cumsum(flag.to(torch.int32), -1) - 1
    keep = flag & (rank < cap)
    slot = torch.where(keep, rank, cap).to(torch.int64)
    idx = torch.arange(L, dtype=torch.int32, device=dev).expand(flag.shape)
    shape = (*flag.shape[:-1], cap + 1)
    idx_buf = torch.full(shape, L, dtype=torch.int32, device=dev)
    idx_buf.scatter_(-1, slot, torch.where(keep, idx, L))
    val_buf = torch.full(shape, fill, dtype=values.dtype, device=dev)
    val_buf.scatter_(-1, slot, torch.where(keep, values,
                                           torch.tensor(fill,
                                                        dtype=values.dtype,
                                                        device=dev)))
    return (idx_buf[..., :cap], val_buf[..., :cap],
            flag.sum(-1, dtype=torch.int32))


def topk_touched_deltas(delta: torch.Tensor, touched: torch.Tensor, cap: int,
                        sent: int):
    """Touched communities and their delta values, rank-compacted along
    the last axis.

    ``touched`` is a dense ``(..., N)`` bool mask of communities whose
    value changed (ids at or above ``sent`` are ignored), ``delta`` the
    dense per-community value.  Returns ``(c_buf (..., cap), d_buf (...,
    cap), n_touched (...))``: the first ``cap`` touched ids in ascending
    order (empty slots ``sent`` / 0) and the true count, so ``n_touched >
    cap`` flags an overflow.  A cumsum over the mask, as in the reference:
    no sort, no ``torch.topk`` (whose ties CUDA does not order).
    """
    dev = touched.device
    ids = torch.arange(touched.shape[-1], dtype=torch.int32,
                       device=dev).expand(touched.shape)
    live = touched & (ids < sent)
    rank = torch.cumsum(live.to(torch.int32), -1) - 1
    keep = live & (rank < cap)
    slot = torch.where(keep, rank, cap).to(torch.int64)
    shape = (*touched.shape[:-1], cap + 1)
    c_buf = torch.full(shape, sent, dtype=torch.int32, device=dev)
    c_buf.scatter_(-1, slot, torch.where(keep, ids, sent))
    d_buf = torch.zeros(shape, dtype=delta.dtype, device=dev)
    d_buf.scatter_(-1, slot, torch.where(keep, delta,
                                         torch.zeros((), dtype=delta.dtype,
                                                     device=dev)))
    return (c_buf[..., :cap], d_buf[..., :cap],
            live.sum(-1, dtype=torch.int32))


def boundary_mask(src_l: torch.Tensor, dst_l: torch.Tensor, v0: int,
                  v_per: int, sent: int) -> torch.Tensor:
    """``(v_per,)`` bool: ``mask[i]`` iff owned vertex ``v0 + i`` has a live
    slot whose dst lies outside ``[v0, v0 + v_per)`` — the halo publishers
    of the hybrid state layout.  ``src_l`` / ``dst_l`` are one shard's
    directed slots (``sent`` marks dead ones)."""
    dev = src_l.device
    live = (src_l < sent) & (dst_l < sent)
    remote = live & ((dst_l < v0) | (dst_l >= v0 + v_per))
    loc = torch.clamp(torch.where(remote, src_l.to(torch.int64) - v0, v_per),
                      0, v_per)
    out = torch.zeros(v_per + 1, dtype=torch.bool, device=dev)
    out[loc] = True
    return out[:v_per] & (torch.arange(v_per, device=dev) + v0 < sent)


def size_delta_width(v_per: int) -> int:
    """Lane width of a per-community size delta under the hybrid layout:
    one round's delta lies in ``[-v_per, v_per]`` and ships as ``delta +
    v_per``."""
    return label_bits(2 * int(v_per) + 1)


class CommPlan(NamedTuple):
    """Static bytes-on-wire accounting for ONE engine round (the
    reference's ``CommPlan``): ``round_bytes`` prices a regular round,
    ``fallback_bytes`` a delta round that overflowed its caps (equal to
    ``round_bytes`` under the gather backend)."""

    backend: str
    n_shards: int
    move_cap: int
    idx_width: int
    lab_width: int
    round_bytes: int
    fallback_bytes: int
    #: State layout the plan prices ("replicated" | "hybrid").
    state_layout: str = "replicated"
    #: Touched-community lane capacity of a hybrid round (0 otherwise).
    touched_cap: int = 0
    #: Per-round share spent on the boundary-mover label lanes.
    halo_round_bytes: int = 0
    #: One-per-phase fixed cost (the hybrid membership resync).
    phase_fixed_bytes: int = 0


def comm_plan(backend: str, n_shards: int, v_per: int, n_pad: int,
              move_cap: int = 0, *, state_layout: str = "replicated",
              touched_cap: int = 0) -> CommPlan:
    """Price one engine round for a layout under ``backend``, by the
    reference's formulas.

    Replicated layout: a gather round ships each shard's owned membership
    slice (int32) and moved mask (bool), a dense Sigma (float32) and a
    dense community-size (int32) array of ``n_pad + 1`` entries, and the
    dq scalar; a delta round ships one fused word: the mover count, the
    local dq and the bit-packed mover lanes, plus, on overflow, the dense
    membership and Sigma exchange on top.  Hybrid layout: boundary-mover
    pairs and touched-community (Sigma, size) lanes with a 12-byte header
    per round, and one membership resync per phase.
    """
    rep = n_pad + 1
    if state_layout not in ("replicated", "hybrid"):
        raise ValueError(f"comm_plan state_layout must be 'replicated' or "
                         f"'hybrid'; got {state_layout!r}")
    if backend not in ("gather", "delta"):
        raise ValueError(f"comm_plan backend must be 'gather' or 'delta'; "
                         f"got {backend!r}")
    if state_layout == "hybrid":
        iw = label_bits(v_per + 1)
        lw = label_bits(n_pad + 1)
        if backend == "gather":      # worst-case caps: overflow-free
            move_cap, touched_cap = v_per, 2 * v_per
        if iw + lw <= 31:
            mover_lanes = packed_lanes(move_cap, iw + lw)
        else:
            mover_lanes = (packed_lanes(move_cap, iw)
                           + packed_lanes(move_cap, lw))
        tid_lanes = packed_lanes(touched_cap, lw)
        siz_lanes = packed_lanes(touched_cap, size_delta_width(v_per))
        round_b = 12 + 4 * (mover_lanes + tid_lanes + touched_cap
                            + siz_lanes)
        if backend == "gather":
            fallback = round_b
        else:
            fallback = round_b + v_per * 4 + v_per + 2 * rep * 4
        return CommPlan(backend, n_shards, move_cap, iw, lw,
                        n_shards * round_b, n_shards * fallback,
                        state_layout="hybrid", touched_cap=touched_cap,
                        halo_round_bytes=n_shards * 4 * mover_lanes,
                        phase_fixed_bytes=n_shards * v_per * 4)
    if backend == "gather":
        per_shard = (v_per * 4 + v_per * 1 + rep * 4 + 4   # comm+moved+
                     + rep * 4)                            # Sigma+dq+sizes
        return CommPlan("gather", n_shards, 0, 0, 0,
                        n_shards * per_shard, n_shards * per_shard)
    iw = label_bits(v_per + 1)
    lw = label_bits(n_pad + 1)
    if iw + lw <= 31:
        mover_lanes = packed_lanes(move_cap, iw + lw)
    else:
        mover_lanes = packed_lanes(move_cap, iw) + packed_lanes(move_cap, lw)
    delta = mover_lanes * 4 + 8                   # lanes + count + dq
    fallback = delta + v_per * 4 + rep * 4        # wire, then comm + Sigma
    return CommPlan("delta", n_shards, move_cap, iw, lw,
                    n_shards * delta, n_shards * fallback)


def reshard_bytes(e_slots_old: int, e_slots_new: int) -> int:
    """One-time cost of a pass-boundary coarse re-shard: 12 B (src, dst,
    weight) per edge slot of the old and of the new layout."""
    return 12 * (int(e_slots_old) + int(e_slots_new))


def phase_bytes(plan: CommPlan, rounds: int, fallback_rounds: int = 0,
                reshard_cost: int = 0) -> int:
    """Bytes on the wire of a move phase of ``rounds`` rounds, of which
    ``fallback_rounds`` overflowed the delta caps, plus a re-shard's
    one-time cost and, when the phase ran a round, the plan's per-phase
    fixed bytes."""
    fb = min(int(fallback_rounds), int(rounds))
    fixed = plan.phase_fixed_bytes if int(rounds) > 0 else 0
    return ((int(rounds) - fb) * plan.round_bytes + fb * plan.fallback_bytes
            + int(reshard_cost) + fixed)
