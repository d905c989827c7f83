"""Optimizers of the PyTorch port, and gradient compression."""

from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_apply,
                                     adamw_init, adamw_update, adamw_update_)
from repro_torch.optim.compression import (CompressionConfig, compress_grads,
                                           compression_init)

__all__ = ["AdamWConfig", "AdamWState", "CompressionConfig", "adamw_apply",
           "adamw_init", "adamw_update", "adamw_update_", "compress_grads",
           "compression_init"]
