"""Modularity (Eq. 1) and delta-modularity (Eq. 2), ``repro.core.modularity``
in PyTorch.  Community arrays have shape (n_cap + 1,) with the trailing
sentinel slot pointing at itself."""

from __future__ import annotations

import torch

from repro_torch.core.graph import CSRGraph, segment_sum


def community_weights(graph: CSRGraph, comm: torch.Tensor) -> torch.Tensor:
    """Sigma_c: (n_cap + 1,) total weighted degree of each community."""
    k = graph.vertex_weights()
    n_cap = graph.n_cap
    return segment_sum(k[:n_cap], comm[:n_cap], n_cap + 1)


def modularity(graph: CSRGraph, comm: torch.Tensor) -> torch.Tensor:
    """0-d float32 Q (Eq. 1) = sum_c [ sigma_c / 2m - (Sigma_c / 2m)^2 ].

    A zero-edge graph has m == 0 and Q == 0 by convention, not NaN.
    """
    m = graph.total_weight()
    same = comm[graph.src] == comm[graph.indices]
    internal = torch.sum(torch.where(same, graph.weights, 0.0))
    sig = community_weights(graph, comm)
    m_safe = torch.where(m > 0, m, 1.0)
    q = internal / (2.0 * m_safe) - torch.sum((sig / (2.0 * m_safe)) ** 2)
    return torch.where(m > 0, q, 0.0)


def delta_modularity(k_i_to_c: torch.Tensor, k_i_to_d: torch.Tensor,
                     k_i: torch.Tensor, sigma_c: torch.Tensor,
                     sigma_d: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Eq. 2: dQ of moving vertex i from its community d to community c.

    ``m`` is a 0-d float32 tensor on the operands' device, so every step
    rounds in float32 in the reference's order (a Python-float ``m`` would
    change the rounding).  With m == 0 dQ is 0 by convention, not NaN.
    """
    m_safe = torch.where(m > 0, m, 1.0)
    dq = ((k_i_to_c - k_i_to_d) / m_safe
          - k_i * (k_i + sigma_c - sigma_d) / (2.0 * m_safe * m_safe))
    return torch.where(m > 0, dq, 0.0)
