"""repro_torch.models — the model zoo's serving path (dense GQA and Mamba2
SSD stacks), the port of ``repro.models`` less training (``lm_loss``)."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    DecodeState,
    decode_step,
    forward_hidden,
    init,
    init_decode_state,
    prefill,
)

__all__ = [
    "ModelConfig",
    "DecodeState",
    "decode_step",
    "forward_hidden",
    "init",
    "init_decode_state",
    "prefill",
]
