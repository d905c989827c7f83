"""GVE-Louvain in PyTorch: the single-device pass loop, the streaming
entry point ``louvain_dynamic``, the batched multi-stream drivers
(``louvain_batched``, ``louvain_dynamic_batched``), the sharded drivers
over ``torch.distributed`` (``distributed_louvain`` and the streaming
``louvain_dynamic_sharded`` on the ranks of a ``ShardGroup``) and the
multi-tenant sharded serving fleet (``FleetRouter``, ``serve_fleet``), with
the
ELL move kernels (K1, K2), the aggregation kernel (K3) and the batch-apply
kernel (K4) hand-written in CUDA for Hopper (``repro_torch/csrc``).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); on a CPU tensor every kernel wrapper runs its plain
PyTorch version instead.  This package imports neither JAX nor ``repro``.
"""

from repro_torch.configs.louvain_arch import (FLEET_E_SLACK,
                                              FLEET_GROW_FACTOR,
                                              FLEET_MIN_E_PER,
                                              FLEET_MIN_V_PER, FleetEnvelope,
                                              fleet_envelope,
                                              fleet_v_per_shard,
                                              migrate_envelope, plan_fleet)
from repro_torch.core.collectives import ShardGroup
from repro_torch.core.delta import EdgeBatch, apply_edge_batch, make_edge_batch
from repro_torch.core.distributed import (AggregationOverflow,
                                          distributed_louvain)
from repro_torch.core.distributed_dynamic import (ShardedDynamicResult,
                                                  louvain_dynamic_sharded)
from repro_torch.core.dynamic import (BatchUpdateStats, DynamicResult,
                                      louvain_dynamic)
from repro_torch.core.fleet import FleetResult, FleetRouter, serve_fleet
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

__all__ = ["AggregationOverflow", "BatchUpdateStats", "BatchedDynamicResult",
           "BatchedLouvainResult", "CSRGraph", "DynamicResult", "EdgeBatch",
           "FLEET_E_SLACK", "FLEET_GROW_FACTOR", "FLEET_MIN_E_PER",
           "FLEET_MIN_V_PER", "FleetBatch", "FleetCapacityOverflow",
           "FleetEnvelope", "FleetGraph", "FleetResult", "FleetRouter",
           "LouvainConfig", "LouvainResult", "PassStats", "ShardGroup",
           "ShardedDynamicResult",
           "apply_edge_batch", "build_csr", "distributed_louvain",
           "fleet_envelope", "fleet_v_per_shard", "from_networkx", "louvain",
           "louvain_batched", "louvain_dynamic", "louvain_dynamic_batched",
           "louvain_dynamic_sharded", "make_edge_batch",
           "membership_modularity", "migrate_envelope", "plan_fleet",
           "rmat_graph", "sbm_edge_stream", "sbm_graph",
           "sbm_holdout_stream", "serve_fleet", "stack_batches",
           "stack_graphs"]
