"""Synthetic graph generators of the PyTorch port."""

from repro_torch.data.graphs import (rmat_graph, sbm_edge_stream,
                                     sbm_holdout_stream, sbm_graph)

__all__ = ["rmat_graph", "sbm_edge_stream", "sbm_graph",
           "sbm_holdout_stream"]
