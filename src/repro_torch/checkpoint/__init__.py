"""repro_torch.checkpoint — atomic, versioned checkpoints of tensor trees."""

from repro_torch.checkpoint.manager import (
    CheckpointManager,
    restore_pytree,
    save_pytree,
)

__all__ = ["CheckpointManager", "restore_pytree", "save_pytree"]
