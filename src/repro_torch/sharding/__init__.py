"""Input split rules of the PyTorch port."""

from repro_torch.sharding.rules import graph_batch_split

__all__ = ["graph_batch_split"]
