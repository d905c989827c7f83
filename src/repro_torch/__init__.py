"""GVE-Louvain in PyTorch: the single-device pass loop, the streaming
entry point ``louvain_dynamic`` and the batched multi-stream drivers
(``louvain_batched``, ``louvain_dynamic_batched``), with the ELL move
kernels (K1, K2), the aggregation kernel (K3) and the batch-apply kernel
(K4) hand-written in CUDA for Hopper (``repro_torch/csrc``).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); on a CPU tensor every kernel wrapper runs its plain
PyTorch version instead.  This package imports neither JAX nor ``repro``.
"""

from repro_torch.core.delta import EdgeBatch, apply_edge_batch, make_edge_batch
from repro_torch.core.dynamic import (BatchUpdateStats, DynamicResult,
                                      louvain_dynamic)
from repro_torch.core.graph import CSRGraph, build_csr, from_networkx
from repro_torch.core.louvain import (LouvainConfig, LouvainResult, PassStats,
                                      louvain, membership_modularity)
from repro_torch.core.multistream import (BatchedDynamicResult,
                                          BatchedLouvainResult, FleetBatch,
                                          FleetCapacityOverflow, FleetGraph,
                                          louvain_batched,
                                          louvain_dynamic_batched,
                                          stack_batches, stack_graphs)
from repro_torch.data.graphs import (rmat_graph, sbm_edge_stream, sbm_graph,
                                     sbm_holdout_stream)

__all__ = ["BatchUpdateStats", "BatchedDynamicResult", "BatchedLouvainResult",
           "CSRGraph", "DynamicResult", "EdgeBatch", "FleetBatch",
           "FleetCapacityOverflow", "FleetGraph", "LouvainConfig",
           "LouvainResult", "PassStats", "apply_edge_batch", "build_csr",
           "from_networkx", "louvain", "louvain_batched", "louvain_dynamic",
           "louvain_dynamic_batched", "make_edge_batch",
           "membership_modularity", "rmat_graph", "sbm_edge_stream",
           "sbm_graph", "sbm_holdout_stream", "stack_batches",
           "stack_graphs"]
