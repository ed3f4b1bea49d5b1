from repro_torch.checkpoint.store import (
    CheckpointManager,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.elastic import reshard_state

__all__ = [
    "CheckpointManager",
    "restore_checkpoint",
    "save_checkpoint",
    "reshard_state",
]
