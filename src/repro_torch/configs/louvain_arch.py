"""Backend and capacity policy of the PyTorch port — the policy half of
``repro.configs.louvain_arch``, kept here so that the port never imports
the JAX package."""

from __future__ import annotations

from typing import Tuple

import torch

#: Accepted values of ``LouvainConfig.scan_backend``.
SCAN_BACKENDS = ("auto", "full", "compact", "ell", "ell_fused")

#: ``"auto"`` picks the frontier-compacted scanner when the seed frontier
#: covers at most this fraction of the vertices.
AUTO_COMPACT_MAX_FRONTIER_FRAC = 0.10

#: Compact work-buffer capacity as a fraction of ``e_cap``.  Frontier edge
#: slots beyond the cap make the round fall back to the full scan, so this
#: bounds compact-scan memory, not correctness.
COMPACT_WORK_FRAC = 0.25

#: Work-buffer floor — tiny graphs keep a sortable minimum.
COMPACT_WORK_MIN = 64


def compact_work_cap(e_cap: int, frac: float = COMPACT_WORK_FRAC) -> int:
    """Work-buffer capacity of the compacted scanner on ``e_cap``."""
    return max(1, min(int(e_cap), max(COMPACT_WORK_MIN, int(e_cap * frac))))


#: Accepted values of ``LouvainConfig.agg_backend`` and of the batch-apply
#: ``backend``.  ``"kernel"`` is the hand-written kernel (K3 and K4; the
#: reference calls it ``"pallas"``), ``"sort"`` the torch chain (the
#: reference's ``"sort"`` and ``"xla"``).
AGG_BACKENDS = ("auto", "sort", "kernel")


def _resolve_kernel_backend(backend: str, device, knob: str) -> str:
    if backend not in AGG_BACKENDS:
        raise ValueError(f"{knob} must be one of {AGG_BACKENDS}; "
                         f"got {backend!r}")
    if backend == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "sort"
    return backend


def resolve_agg_backend(backend: str, device: torch.device) -> str:
    """Map the ``agg_backend`` knob to a concrete aggregation backend.

    ``"sort"`` is the torch sort -> segment-sum -> scatter chain;
    ``"kernel"`` resolves the sorted groups in the CUDA kernel K3 (its plain
    version on a CPU tensor).  ``"auto"`` picks the kernel on a CUDA device
    and the sort chain on the CPU.
    """
    return _resolve_kernel_backend(backend, device, "agg_backend")


def resolve_apply_backend(backend: str, device: torch.device) -> str:
    """Map the batch-apply ``backend`` knob the same way: ``"kernel"`` is the
    CUDA kernel K4 (its plain version on a CPU tensor), ``"sort"`` the
    torch segment-reduction chain, ``"auto"`` the kernel on a CUDA device
    and the sort chain on the CPU — by the tensors' device, never by
    whether the kernel builds."""
    return _resolve_kernel_backend(backend, device, "apply backend")


def resolve_scan_backend(backend: str, *, use_ell_kernel: bool = False,
                         frontier_frac: float | None = None) -> str:
    """Map the ``scan_backend`` knob to a concrete scanner for ONE pass:
    one of ``"full" | "compact" | "ell" | "ell_fused"``, by the reference's
    rules (``"auto"`` + ELL family -> the fused kernel; ``"auto"`` + a small
    active frontier -> ``"compact"``; otherwise the full sort-reduce)."""
    if backend not in SCAN_BACKENDS:
        raise ValueError(f"scan_backend must be one of {SCAN_BACKENDS}; "
                         f"got {backend!r}")
    if use_ell_kernel or backend in ("ell", "ell_fused"):
        if backend == "compact":
            raise ValueError(
                "scan_backend='compact' contradicts use_ell_kernel=True — "
                "the compacted scanner is a sort-reduce backend")
        if backend in ("auto", "ell_fused"):
            return "ell_fused"
        return "ell"
    if backend == "compact":
        return "compact" if frontier_frac is not None else "full"
    if backend == "auto":
        if (frontier_frac is not None
                and frontier_frac <= AUTO_COMPACT_MAX_FRONTIER_FRAC):
            return "compact"
        return "full"
    return "full"


# ---------------------------------------------------------------------------
# Coarse-pass capacity ladder (the ``LouvainConfig.use_ladder`` knob).
# ---------------------------------------------------------------------------

#: Vertex-capacity floor of the ladder.
LADDER_MIN_N_CAP = 64

#: Edge-capacity floor of the ladder.
LADDER_MIN_E_CAP = 256

#: Headroom multiplier applied to the live counts before tier rounding.
LADDER_SLACK = 1.25

#: A pass re-buckets only when the candidate tier is at least this factor
#: below the current capacity.
LADDER_HYSTERESIS = 2


def _pow2_at_least(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


def resolve_coarse_capacity(n_comms: int, e_valid: int,
                            n_cap: int, e_cap: int) -> Tuple[int, int]:
    """Ladder tier ``(n_cap_new, e_cap_new)`` for the next pass of a coarse
    graph; ``(n_cap, e_cap)`` back means "don't re-bucket"."""
    n_tier = max(_pow2_at_least(int(n_comms * LADDER_SLACK)), LADDER_MIN_N_CAP)
    e_tier = max(_pow2_at_least(int(e_valid * LADDER_SLACK)), LADDER_MIN_E_CAP)
    n_new = n_tier if n_tier * LADDER_HYSTERESIS <= n_cap else n_cap
    e_new = e_tier if e_tier * LADDER_HYSTERESIS <= e_cap else e_cap
    return n_new, e_new
