"""GVE-Louvain in PyTorch: the static single-device pass loop, with the ELL
move kernels (K1, K2) and the aggregation kernel (K3) hand-written in CUDA
for Hopper (``repro_torch/csrc``).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); on a CPU tensor every kernel wrapper runs its plain
PyTorch version instead.  This package imports neither JAX nor ``repro``.
"""

from repro_torch.core.graph import CSRGraph, build_csr, from_networkx
from repro_torch.core.louvain import (LouvainConfig, LouvainResult, PassStats,
                                      louvain, membership_modularity)
from repro_torch.data.graphs import rmat_graph, sbm_graph

__all__ = ["CSRGraph", "LouvainConfig", "LouvainResult", "PassStats",
           "build_csr", "from_networkx", "louvain", "membership_modularity",
           "rmat_graph", "sbm_graph"]
