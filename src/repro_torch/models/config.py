"""Architecture configuration schema: a copy of ``repro.models.config``.

One frozen dataclass describes every architecture of the zoo, with the
reference's fields, defaults and properties, so that a configuration reads
the same in both packages.  The port builds every family (dense GQA, pure
SSD, MoE, the SSD/attention/MoE hybrid and the encoder–decoder;
``repro_torch.configs`` registers them).

``attn_impl`` names the reference's lowerings ("chunked", "pallas",
"interpret"), which have no meaning here: the port runs its attention and
SSD kernels (or, on CPU tensors, their plain versions) whatever it says,
except that ``"reference"`` selects the materializing oracles of
:mod:`repro_torch.kernels.ref`.  ``logits_chunk`` sets the training
loss's sequence chunk; ``remat`` checkpoints each block of a recorded
full-sequence pass (see :mod:`repro_torch.models.transformer`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio

    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0  # 0 → d_model // n_heads
    d_ff: int = 0
    vocab_size: int = 0

    # -- attention features --------------------------------------------------
    rope: bool = True
    rope_theta: float = 10000.0
    rope_pct: float = 1.0  # stablelm-2: 0.25 (partial rotary)
    qk_norm: bool = False  # qwen3, chameleon
    qkv_bias: bool = False  # qwen1.5, starcoder2
    norm_type: str = "rms"  # rms | layer
    norm_eps: float = 1e-5
    mlp_type: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False

    # -- MoE -----------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # 0 → d_ff
    moe_every: int = 1  # apply MoE every k-th layer (jamba: 2)
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_dispatch: str = "grouped"  # grouped (data-axis-local) | global

    # -- SSM (Mamba2/SSD) ----------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0  # hybrid: one attention layer every k layers (jamba: 8)

    # -- encoder-decoder -----------------------------------------------------
    encoder_layers: int = 0  # > 0 → enc-dec (seamless)
    cross_attention: bool = False
    source_len: int = 0  # default encoder source length for serve shapes

    # -- modality frontend stubs ----------------------------------------------
    input_mode: str = "tokens"  # tokens | embeddings (audio stub feeds frames)

    # -- numerics / execution -------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    attn_impl: str = "chunked"
    attn_block_q: int = 512
    attn_block_k: int = 1024
    logits_chunk: int = 512  # seq chunking for the vocab-sharded loss

    # ------------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or (self.d_inner // self.ssm_head_dim)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Mixer kind per decoder layer: 'attn' or 'ssm'."""
        if self.family == "ssm":
            return tuple("ssm" for _ in range(self.n_layers))
        if self.attn_every > 0:  # hybrid: attention at position k-1 of period
            return tuple(
                "attn" if (i % self.attn_every) == self.attn_every // 2 else "ssm"
                for i in range(self.n_layers)
            )
        return tuple("attn" for _ in range(self.n_layers))

    def ffn_kinds(self) -> Tuple[str, ...]:
        """FFN kind per decoder layer: 'mlp', 'moe', or 'moe+mlp'."""
        kinds = []
        for i in range(self.n_layers):
            if self.n_experts > 0 and (i % self.moe_every) == (self.moe_every - 1):
                kinds.append("moe+mlp" if self.dense_residual else "moe")
            else:
                kinds.append("mlp" if self.d_ff > 0 else "none")
        return tuple(kinds)

    def period(self) -> int:
        """Smallest repeating block of (mixer, ffn) kinds — the scan unit.

        HLO size is O(period); n_layers/period periods are lax.scan-ed, so
        deep stacks compile in O(1) depth (compile-time discipline for the
        512-device dry-run; DESIGN.md §6).
        """
        mixers, ffns = self.layer_kinds(), self.ffn_kinds()
        n = self.n_layers
        for p in range(1, n + 1):
            if n % p:
                continue
            if all(
                mixers[i] == mixers[i % p] and ffns[i] == ffns[i % p]
                for i in range(n)
            ):
                return p
        return n

    def active_params(self) -> float:
        """Active parameters per token (MoE counts top-k experts only)."""
        return _param_count(self, active_only=True)

    def total_params(self) -> float:
        return _param_count(self, active_only=False)


def _ffn_params(cfg: ModelConfig, d_ff: int) -> float:
    mult = 3 if cfg.mlp_type == "swiglu" else 2
    return mult * cfg.d_model * d_ff


def _param_count(cfg: ModelConfig, active_only: bool) -> float:
    d, hd = cfg.d_model, cfg.head_dim
    attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
    ssm = 0.0
    if cfg.family in ("ssm", "hybrid"):
        di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
        h = cfg.n_ssm_heads
        in_proj = d * (2 * di + 2 * g * n + h)
        ssm = in_proj + (di + 2 * g * n) * cfg.ssm_conv + di * d + 2 * h + di

    total = 0.0
    for mixer, ffn in zip(cfg.layer_kinds(), cfg.ffn_kinds()):
        total += attn if mixer == "attn" else ssm
        moe_ff = cfg.moe_d_ff or cfg.d_ff
        if ffn == "mlp":
            total += _ffn_params(cfg, cfg.d_ff)
        elif ffn in ("moe", "moe+mlp"):
            experts = (
                cfg.experts_per_token if active_only else cfg.n_experts
            )
            total += experts * _ffn_params(cfg, moe_ff) + d * cfg.n_experts
            if ffn == "moe+mlp":
                total += _ffn_params(cfg, cfg.d_ff)
        total += 2 * d  # norms
    if cfg.encoder_layers:
        enc = attn + _ffn_params(cfg, cfg.d_ff) + 2 * d
        dec_cross = attn + d  # cross-attention per decoder layer
        total += cfg.encoder_layers * enc + cfg.n_layers * dec_cross
    total += cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return total
