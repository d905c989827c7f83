"""Input split rules of the PyTorch port."""

from repro_torch.sharding.rules import (fm_batch_split, fm_param_split,
                                       graph_batch_split)

__all__ = ["fm_batch_split", "fm_param_split", "graph_batch_split"]
