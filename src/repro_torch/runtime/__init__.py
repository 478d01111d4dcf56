"""repro_torch.runtime — the fault-tolerant training loop."""

from repro_torch.runtime.trainer import Trainer, TrainerConfig, TrainerEvents

__all__ = ["Trainer", "TrainerConfig", "TrainerEvents"]
