"""seamless-m4t-large-v2 — encoder-decoder, multimodal [arXiv:2308.11596].

24L encoder + 24L decoder, d_model 1024, 16H (kv=16), GELU d_ff 8192,
vocab 256206, sinusoidal positions (no RoPE), cross-attention.  The
speech frontend is a STUB: input_specs() feeds precomputed frame
embeddings (B, S_src, d_model) to the encoder.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    encoder_layers=24,
    cross_attention=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    mlp_type="gelu",
    norm_type="layer",
    rope=False,
    input_mode="embeddings",
    source_len=4096,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="seamless-smoke",
    n_layers=2,
    encoder_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    source_len=32,
    dtype="float32",
)
