"""GVE-Louvain in PyTorch: the single-device pass loop, the streaming
entry point ``louvain_dynamic``, the batched multi-stream drivers
(``louvain_batched``, ``louvain_dynamic_batched``), the sharded drivers
over ``torch.distributed`` (``distributed_louvain`` and the streaming
``louvain_dynamic_sharded`` on the ranks of a ``ShardGroup``) and the
multi-tenant sharded serving fleet (``FleetRouter``, ``serve_fleet``), and
the graph workloads: the Louvain partitioner (``louvain_partition``,
``random_partition``) and Louvain-partitioned GNN training (the gin-tu,
gat-cora, equiformer-v2 and dimenet configs' ``ARCH``, ``build_gnn_step``,
and the halo exchange's ``build_halo_step`` / ``build_halo_inputs``), the
FM recommender (the fm config's ``ARCH`` as ``FM``: training, online and
bulk scoring and retrieval, the table split by rows over a
``ShardGroup``), the fault-tolerant training loop (the ``train``
subpackage: ``train.train``, ``TrainLoopConfig``; the name stays the
subpackage's, so ``import repro_torch.train.loop`` works) with its
checkpoints (``save_checkpoint`` / ``restore_checkpoint``) and gradient
compression, the NumPy LFR and powerlaw-cluster generators, and the
five decoder LMs (``configs.registry``, ``models.transformer``: train,
prefill and decode on one rank or over a (data, model) grid of ranks,
``collectives.RankGrid``) with the training launcher
``python -m repro_torch.launch.train``, with the ELL move kernels (K1,
K2), the aggregation kernel (K3) and the batch-apply kernel (K4)
hand-written in CUDA for Hopper (``repro_torch/csrc``).

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
from repro_torch.configs.dimenet_cfg import ARCH as DIMENET
from repro_torch.configs.equiformer_v2 import ARCH as EQUIFORMER_V2
from repro_torch.configs.fm import ARCH as FM
from repro_torch.configs.gat_cora import ARCH as GAT_CORA
from repro_torch.configs.gin_tu import ARCH as GIN_TU
from repro_torch.configs.gnn_common import build_gnn_step
from repro_torch.core.collectives import ShardGroup
from repro_torch.core.delta import EdgeBatch, apply_edge_batch, make_edge_batch
from repro_torch.core.distributed import (AggregationOverflow,
                                          distributed_louvain)
from repro_torch.core.distributed_dynamic import (ShardedDynamicResult,
                                                  louvain_dynamic_sharded)
from repro_torch.core.dynamic import (BatchUpdateStats, DynamicResult,
                                      louvain_dynamic)
from repro_torch.core.fleet import FleetResult, FleetRouter, serve_fleet
from repro_torch.core.gnn_halo import build_halo_inputs, build_halo_step
from repro_torch.core.graph import CSRGraph, build_csr, from_networkx
from repro_torch.core.louvain import (LouvainConfig, LouvainResult, PassStats,
                                      louvain, membership_modularity)
from repro_torch.core.multistream import (BatchedDynamicResult,
                                          BatchedLouvainResult, FleetBatch,
                                          FleetCapacityOverflow, FleetGraph,
                                          louvain_batched,
                                          louvain_dynamic_batched,
                                          stack_batches, stack_graphs)
from repro_torch.core.partition import (PartitionResult, louvain_partition,
                                        random_partition)
from repro_torch.data.graphs import (lfr_graph, powerlaw_cluster, rmat_graph,
                                     sbm_edge_stream, sbm_graph,
                                     sbm_holdout_stream)
from repro_torch import train
from repro_torch.train import (TrainLoopConfig, restore_checkpoint,
                               save_checkpoint)

__all__ = ["AggregationOverflow", "BatchUpdateStats", "BatchedDynamicResult",
           "BatchedLouvainResult", "CSRGraph", "DIMENET", "DynamicResult",
           "EQUIFORMER_V2", "EdgeBatch", "FM",
           "FLEET_E_SLACK", "FLEET_GROW_FACTOR", "FLEET_MIN_E_PER",
           "FLEET_MIN_V_PER", "FleetBatch", "FleetCapacityOverflow",
           "FleetEnvelope", "FleetGraph", "FleetResult", "FleetRouter",
           "GAT_CORA", "GIN_TU", "LouvainConfig", "LouvainResult",
           "PartitionResult", "PassStats", "ShardGroup",
           "ShardedDynamicResult",
           "apply_edge_batch", "build_csr", "build_gnn_step",
           "build_halo_inputs", "build_halo_step", "distributed_louvain",
           "fleet_envelope", "fleet_v_per_shard", "from_networkx", "louvain",
           "lfr_graph", "louvain_batched", "louvain_dynamic",
           "louvain_dynamic_batched",
           "louvain_dynamic_sharded", "louvain_partition", "make_edge_batch",
           "membership_modularity", "migrate_envelope", "plan_fleet",
           "powerlaw_cluster", "random_partition", "restore_checkpoint",
           "rmat_graph", "save_checkpoint", "sbm_edge_stream", "sbm_graph",
           "sbm_holdout_stream", "serve_fleet", "stack_batches",
           "stack_graphs", "train", "TrainLoopConfig"]
