"""Optimizers of the PyTorch port."""

from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_apply,
                                     adamw_init, adamw_update)

__all__ = ["AdamWConfig", "AdamWState", "adamw_apply", "adamw_init",
           "adamw_update"]
