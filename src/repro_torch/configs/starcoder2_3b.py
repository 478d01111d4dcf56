"""starcoder2-3b — dense GQA code model [arXiv:2402.19173].

30L, d_model 3072, 24H (kv=2), GELU MLP d_ff 12288, LayerNorm, RoPE,
QKV bias, vocab 49152.  (The reference pads the 24 query heads to 32 on
16-way TP; the port runs at degree 1, every head real.)
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    mlp_type="gelu",
    norm_type="layer",
    qkv_bias=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="starcoder2-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    dtype="float32",
)
