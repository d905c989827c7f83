"""Inputs of the ELL scan kernels (K1, K2): per-slot community state gathered
from the graph state with torch ops, as ``repro.kernels.louvain_scan.ops``
leaves the gathers to XLA.  The kernels themselves live in
``louvain_scan.py`` (K2) and ``fused.py`` (K1)."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.graph import ELLBlock
from repro_torch.kernels.louvain_scan.fused import louvain_fused
from repro_torch.kernels.louvain_scan.louvain_scan import (
    block_rows_for_width, louvain_scan)

__all__ = ["block_rows_for_width", "louvain_fused", "louvain_scan",
           "prepare_ell_inputs", "prepare_fused_inputs"]


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
