"""The system under test as the loops drive it: the port's ``louvain()``
and ``louvain_dynamic()`` (``repro_torch``) behind the few calls a loop
makes.  A control or a planted fault stands in for it through the same
calls (``gvebench/control.py``)."""

from __future__ import annotations

import numpy as np
import torch


class Program:
    """``repro_torch`` on ``device`` with the configuration's Louvain
    parameters; the scan, aggregation and apply backends stay at the
    program's own choice ("auto")."""

    def __init__(self, louvain_params: dict, device):
        from repro_torch import (LouvainConfig, build_csr, louvain,
                                 louvain_dynamic, make_edge_batch)
        self._build_csr, self._louvain = build_csr, louvain
        self._louvain_dynamic, self._make_edge_batch = (louvain_dynamic,
                                                        make_edge_batch)
        self.config = LouvainConfig(**louvain_params)
        self.device = torch.device(device)

    def build(self, n: int, us: torch.Tensor, ud: torch.Tensor,
              e_headroom: int = 0):
        """The resident graph: both directions of each pair, unit weights,
        with ``e_headroom`` spare edge slots."""
        return self._build_csr(
            us, ud, torch.ones(us.shape[0], dtype=torch.float32,
                               device=us.device),
            n, e_cap=2 * us.shape[0] + e_headroom, symmetrize=True,
            dedup=False, device=self.device)

    def make_batch(self, u, v, w, n: int, b_cap: int):
        return self._make_edge_batch(u, v, w, n, b_cap=b_cap,
                                     device=self.device)

    def louvain(self, graph):
        return self._louvain(graph, self.config)

    def louvain_dynamic(self, graph, batch, prev, screening):
        return self._louvain_dynamic(graph, [batch], prev=prev,
                                     config=self.config, screening=screening)

    @staticmethod
    def slots(graph) -> int:
        return int(graph.e_valid)

    @staticmethod
    def e_cap(graph) -> int:
        return int(graph.e_cap)

    @staticmethod
    def directed(graph):
        """(vertex count, sorted directed keys ``src * n + dst``, their
        weights) of the live slots."""
        e, n = int(graph.e_valid), int(graph.n_valid)
        key = (graph.src[:e].to(torch.int64) * n
               + graph.indices[:e].to(torch.int64))
        key, order = torch.sort(key)
        return n, key, graph.weights[:e][order]


def membership_of(result) -> np.ndarray:
    return np.asarray(result.membership, dtype=np.int32)
