"""qwen1.5-0.5b — small dense with QKV bias [hf:Qwen/Qwen1.5-0.5B].

24L, d_model 1024, 16H (kv=16), SwiGLU d_ff 2816, vocab 151936, tied
embeddings.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="qwen1.5-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    dtype="float32",
)
