"""Synthetic data of the PyTorch port: graph generators and click
batches."""

from repro_torch.data.graphs import (lfr_graph, powerlaw_cluster, rmat_graph,
                                     sbm_edge_stream, sbm_holdout_stream,
                                     sbm_graph)
from repro_torch.data.recsys import synthetic_click_batches

__all__ = ["lfr_graph", "powerlaw_cluster", "rmat_graph", "sbm_edge_stream",
           "sbm_graph", "sbm_holdout_stream", "synthetic_click_batches"]
