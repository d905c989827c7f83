"""Input and parameter split rules of the PyTorch port."""

from repro_torch.sharding.rules import (assemble, dp_axes, fm_batch_split,
                                       fm_param_split, graph_batch_split,
                                       lm_batch_split, lm_cache_split,
                                       lm_param_split, map_split, share,
                                       shards_experts)

__all__ = ["assemble", "dp_axes", "fm_batch_split", "fm_param_split",
           "graph_batch_split", "lm_batch_split", "lm_cache_split",
           "lm_param_split", "map_split", "share", "shards_experts"]
