"""arctic-480b — dense-MoE hybrid: 128e top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base].

35L, d_model 7168, 56H (kv=8), d_ff 4864 both for the dense residual
branch and per expert.  The reference pads the 56 query heads to 64 on
its fixed 16-way TP mesh (DESIGN.md §4); the port runs at tensor-parallel
degree 1, where every head is real.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    experts_per_token=2,
    dense_residual=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="arctic-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    n_experts=8,
    experts_per_token=2,
    capacity_factor=8.0,  # dropless at smoke scale: decode == forward invariant
    dtype="float32",
)
