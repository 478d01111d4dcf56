"""repro_torch.models — the decoder-only model zoo (dense GQA, Mamba2 SSD,
MoE and hybrid stacks): serving, and training through ``lm_loss``; the
port of ``repro.models``."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    DecodeState,
    decode_step,
    forward_hidden,
    init,
    init_decode_state,
    lm_loss,
    prefill,
)

__all__ = [
    "ModelConfig",
    "DecodeState",
    "decode_step",
    "forward_hidden",
    "init",
    "init_decode_state",
    "lm_loss",
    "prefill",
]
