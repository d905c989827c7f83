"""Louvain core of the PyTorch port: graph, modularity, engine, scanners,
aggregation and the pass loop."""
