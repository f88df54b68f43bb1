from repro_torch.ckpt.checkpoint import (CheckpointManager, latest_step,
                                         load_checkpoint, save_checkpoint)
from repro_torch.ckpt.index_io import load_index, save_index

__all__ = ["CheckpointManager", "latest_step", "load_checkpoint",
           "save_checkpoint", "load_index", "save_index"]
