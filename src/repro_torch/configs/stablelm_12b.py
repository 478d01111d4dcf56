"""stablelm-12b — dense GQA with partial rotary [hf:stabilityai].

40L, d_model 5120, 32H (kv=8), SwiGLU d_ff 13824, LayerNorm, 25% rotary,
vocab 100352.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    norm_type="layer",
    rope_pct=0.25,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="stablelm-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    dtype="float32",
)
