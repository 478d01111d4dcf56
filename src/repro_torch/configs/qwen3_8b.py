"""qwen3-8b — dense GQA with QK-norm [hf:Qwen/Qwen3-8B].

36L, d_model 4096, 32H (kv=8), head_dim 128, SwiGLU d_ff 12288,
vocab 151936.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="qwen3-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    dtype="float32",
)
