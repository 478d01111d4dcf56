"""olmoe-1b-7b — 64-expert top-8 MoE [arXiv:2409.02060].

16L, d_model 2048, 16H (kv=16), expert d_ff 1024, vocab 50304.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    experts_per_token=8,
    qk_norm=True,  # OLMoE uses QK-norm
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="olmoe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=256,
    n_experts=8,
    experts_per_token=2,
    capacity_factor=8.0,  # dropless at smoke scale: decode == forward invariant
    dtype="float32",
)
