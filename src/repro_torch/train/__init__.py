"""Training infrastructure of the PyTorch port: the fault-tolerant loop
and checkpoints."""

from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.loop import ElasticController, TrainLoopConfig, train

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "TrainLoopConfig", "ElasticController", "train"]
