"""Graph neural networks of the PyTorch port: GIN, GAT, the shared
message-passing helpers and the fanout sampler."""
