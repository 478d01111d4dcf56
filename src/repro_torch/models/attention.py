"""GQA attention layer: projections, bias, qk-norm, RoPE, KV cache.

The port of ``repro.models.attention`` at tensor-parallel degree 1 (no
head padding: every query head is real).  Full-sequence and prefill
attention run the flash-attention kernel (``kernels.ops.attention``, K9)
on CUDA tensors and its plain version on CPU tensors; one-token decode
reads the cache with the reference's grouped einsum, plain PyTorch as the
reference's is plain jnp.  The KV cache is written in place (the
reference returns an updated copy); its ``length`` is a host int, so a
decode step needs no device read.  Cross-attention (``memory=``, the
encoder–decoder's decoder) attends to K/V that :func:`encode_memory`
projects once from the encoder's output, non-causally on the kernel: in
prefill a rectangular call, in decode a one-row one (as the reference
calls its kernel there, not the grouped einsum).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    _param,
    compute_dtype,
    dense_init,
    param_dtype,
    rms_head_norm,
    rope_apply,
)

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, Hkv, S_max, dh)
    v: torch.Tensor
    length: int  # valid prefix


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` (+ ``bq``/``bk``/``bv`` with
    ``qkv_bias``, ``q_norm``/``k_norm`` with ``qk_norm``)."""

    def __init__(self, generator, cfg: ModelConfig, device):
        super().__init__()
        pd, dh, d = param_dtype(cfg), cfg.head_dim, cfg.d_model
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        self.wq = dense_init(generator, d, hq * dh, pd, device)
        self.wk = dense_init(generator, d, hkv * dh, pd, device)
        self.wv = dense_init(generator, d, hkv * dh, pd, device)
        self.wo = dense_init(generator, hq * dh, d, pd, device)
        if cfg.qkv_bias:
            self.bq = _param(torch.zeros((hq * dh,), dtype=pd, device=device))
            self.bk = _param(torch.zeros((hkv * dh,), dtype=pd, device=device))
            self.bv = _param(torch.zeros((hkv * dh,), dtype=pd, device=device))
        if cfg.qk_norm:
            self.q_norm = _param(torch.ones((dh,), dtype=pd, device=device))
            self.k_norm = _param(torch.ones((dh,), dtype=pd, device=device))


def attn_init(generator, cfg: ModelConfig, *, device="cuda") -> Attention:
    return Attention(generator, cfg, device)


def _project_q(p: Attention, x, cfg: ModelConfig, positions):
    dt = x.dtype
    b, s, _ = x.shape
    q = x @ p.wq.to(dt)
    if cfg.qkv_bias:
        q = q + p.bq.to(dt)
    q = q.reshape(b, s, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_head_norm(p.q_norm, q, cfg.norm_eps)
    if cfg.rope:
        q = rope_apply(q, positions, cfg.rope_theta, cfg.rope_pct)
    return q


def _project_kv(p: Attention, x, cfg: ModelConfig, positions):
    dt = x.dtype
    b, s, _ = x.shape
    k = x @ p.wk.to(dt)
    v = x @ p.wv.to(dt)
    if cfg.qkv_bias:
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    k = k.reshape(b, s, -1, cfg.head_dim)
    v = v.reshape(b, s, -1, cfg.head_dim)
    if cfg.qk_norm:
        k = rms_head_norm(p.k_norm, k, cfg.norm_eps)
    if cfg.rope:
        k = rope_apply(k, positions, cfg.rope_theta, cfg.rope_pct)
    return k, v


def attn_apply(
    p: Attention,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    cache: Optional[KVCache] = None,
    memory=None,
    backend: str = "auto",
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Self- or cross-attention with an optional KV cache.

    * ``cache=None``: attends within ``x`` (causal optional);
    * cache prefill (``s > 1``): writes K/V at ``cache.length`` and attends
      causally within ``x`` (a fresh cache starts at length 0);
    * cache decode (``s == 1``): writes, then reads the valid prefix;
    * ``memory=(k, v)`` (B, Hkv, S_mem, dh) from :func:`encode_memory`:
      queries from ``x`` attend to all of it, no cache.

    Writing past the cache's ``max_len`` raises ``ValueError`` (the
    reference clamps the write and overwrites its last slot).
    ``cfg.attn_impl == "reference"`` runs the materializing oracle in place
    of the kernel; otherwise ``backend`` selects (see ``kernels.ops``).
    """
    b, s, _ = x.shape
    backend = "reference" if cfg.attn_impl == "reference" else backend
    blocks = dict(block_q=cfg.attn_block_q, block_k=cfg.attn_block_k, backend=backend)
    if positions is None:
        base = cache.length if cache is not None else 0
        positions = base + torch.arange(s, device=x.device)[None, :]

    q = _project_q(p, x, cfg, positions).transpose(1, 2)  # (B, H, S, dh)
    if memory is not None:
        ctx = kops.attention(q, *memory, causal=False, **blocks)
        return ctx.transpose(1, 2).reshape(b, s, -1) @ p.wo.to(x.dtype), None
    k, v = _project_kv(p, x, cfg, positions)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    new_cache = None
    if cache is None:
        ctx = kops.attention(q, k, v, causal=causal, **blocks)
    else:
        start = cache.length
        if start + s > cache.k.shape[2]:
            raise ValueError(
                f"KV cache overflow: {start} cached + {s} new tokens > max_len {cache.k.shape[2]}"
            )
        cache.k[:, :, start : start + s] = k.to(cache.k.dtype)
        cache.v[:, :, start : start + s] = v.to(cache.v.dtype)
        new_cache = KVCache(k=cache.k, v=cache.v, length=start + s)
        if s > 1:
            ctx = kops.attention(q, k.to(q.dtype), v.to(q.dtype), causal=True, **blocks)
        else:
            ctx = _decode_attention(q, cache.k, cache.v, start, s)
    ctx = ctx.transpose(1, 2).reshape(b, s, -1)
    return ctx @ p.wo.to(x.dtype), new_cache


def _decode_attention(q, kc, vc, length: int, s_new: int):
    """Masked attention of ``s_new`` fresh queries against the cache: the
    reference's grouped einsum (the repeated KV is never formed) with
    scores (B, H, s_new, S_max) and the prefix mask."""
    b, h, _, dh = q.shape
    hkv, s_max = kc.shape[1], kc.shape[2]
    qg = q.reshape(b, hkv, h // hkv, s_new, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, kc).float() * dh**-0.5
    kpos = torch.arange(s_max, device=q.device)
    qpos = length + torch.arange(s_new, device=q.device)[:, None]
    logits = torch.where(kpos <= qpos, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhgqk,bhkd->bhgqd", probs, vc)
    return ctx.reshape(b, h, s_new, dh)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=None, device="cuda") -> KVCache:
    dt = dtype or compute_dtype(cfg)
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dt, device=device),
        v=torch.zeros(shape, dtype=dt, device=device),
        length=0,
    )


def encode_memory(p: Attention, enc_out: torch.Tensor, cfg: ModelConfig):
    """Cross-attention K/V ``(B, Hkv, S, dh)`` from the encoder's output
    ``(B, S, D)``: its ``wk`` / ``wv`` products alone (no bias and no
    k-norm, even where the config has them, as the reference's), laid out
    contiguously once, so no decode step copies them."""
    b, s, _ = enc_out.shape
    dt = enc_out.dtype
    k = (enc_out @ p.wk.to(dt)).reshape(b, s, -1, cfg.head_dim)
    v = (enc_out @ p.wv.to(dt)).reshape(b, s, -1, cfg.head_dim)
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
