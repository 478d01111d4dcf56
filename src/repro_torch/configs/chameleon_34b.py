"""chameleon-34b — early-fusion VLM backbone [arXiv:2405.09818].

48L, d_model 8192, 64H (kv=8), SwiGLU d_ff 22016, vocab 65536 (text + VQ
image codes), QK-norm.  The image tokenizer is a modality-frontend STUB:
input_specs() feeds precomputed VQ token ids (the backbone is what we
build, per the assignment).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="chameleon-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    dtype="float32",
)
