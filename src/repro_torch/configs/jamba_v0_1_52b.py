"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 with MoE [arXiv:2403.19887].

32L, d_model 4096, 32H (kv=8) on the attention layers (1 per 8, at period
position 4), MoE 16e top-2 every other layer, SwiGLU d_ff 14336.  SSD
adaptation of Jamba's Mamba layers (DESIGN.md §8): d_inner 8192, headdim
64 → 128 heads, state 16.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    attn_every=8,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_expand=2,
    ssm_conv=4,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="jamba-smoke",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    n_experts=4,
    experts_per_token=2,
    capacity_factor=8.0,  # dropless at smoke scale: decode == forward invariant
    ssm_state=8,
    ssm_head_dim=16,
    ssm_chunk=32,
    dtype="float32",
)
