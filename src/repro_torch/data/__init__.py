"""Synthetic data of the PyTorch port: graph generators, click batches
and LM token batches."""

from repro_torch.data.graphs import (lfr_graph, powerlaw_cluster, rmat_graph,
                                     sbm_edge_stream, sbm_holdout_stream,
                                     sbm_graph)
from repro_torch.data.recsys import synthetic_click_batches
from repro_torch.data.tokens import synthetic_token_batches

__all__ = ["lfr_graph", "powerlaw_cluster", "rmat_graph", "sbm_edge_stream",
           "sbm_graph", "sbm_holdout_stream", "synthetic_click_batches",
           "synthetic_token_batches"]
