"""mamba2-1.3b — SSD (state-space duality) stack [arXiv:2405.21060].

48L, d_model 2048, attention-free; d_inner = 2·2048 = 4096, headdim 64 →
64 SSD heads, state n=128, 1 B/C group, conv4.  Vocab 50280 (GPT-NeoX).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    rope=False,
    tie_embeddings=True,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_expand=2,
    ssm_conv=4,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="mamba2-smoke",
    n_layers=2,
    d_model=64,
    vocab_size=256,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=32,
    dtype="float32",
)
