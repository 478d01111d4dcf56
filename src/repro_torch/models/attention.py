"""GQA attention layer: projections, bias, qk-norm, RoPE, KV cache.

The port of ``repro.models.attention``.  Full-sequence and prefill
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

Tensor parallelism, as the reference lays it out for a ``tp``-way
``model`` axis: query heads are padded up to a multiple of ``tp``
(:func:`padded_q_heads`: arctic 56 → 64, starcoder2 24 → 32, stablelm
40 → 48; the padded heads are drawn like the others, so a padded model is
a model of its own) and sharded over ``model``; KV projections are
column-sharded only where ``tp`` divides the KV heads
(:func:`kv_sharded`), else replicated.  K/V reach the attention
replicated over ``model`` (the reference's ``shard`` of them names no
model axis, and the caches' layout none), so on a mesh each rank attends
with its own query heads and the KV heads of their groups
(:func:`_rank_kv`): with padded heads the group of query head ``i`` is
``i // (padded heads / KV heads)``, which need not be a rank's local head
over its local group.  That region runs on each rank's local tensors
(``local_map``), where the kernel launches as on one device.
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
    round_up,
    weight,
)
from repro_torch.models.sharding import is_distributed, shard

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, Hkv, S_max, dh)
    v: torch.Tensor
    length: int  # valid prefix


def padded_q_heads(cfg: ModelConfig, tp: int) -> int:
    return round_up(cfg.n_heads, max(tp, 1))


def kv_sharded(cfg: ModelConfig, tp: int) -> bool:
    return tp > 1 and cfg.n_kv_heads % tp == 0


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` (+ ``bq``/``bk``/``bv`` with
    ``qkv_bias``, ``q_norm``/``k_norm`` with ``qk_norm``), with
    :func:`padded_q_heads` query heads at tensor-parallel degree ``tp``."""

    def __init__(self, generator, cfg: ModelConfig, device, tp: int = 1):
        super().__init__()
        pd, dh, d = param_dtype(cfg), cfg.head_dim, cfg.d_model
        hq, hkv = padded_q_heads(cfg, tp), cfg.n_kv_heads
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


def attn_init(generator, cfg: ModelConfig, *, device="cuda", tp: int = 1) -> Attention:
    return Attention(generator, cfg, device, tp)


def _project_q(p: Attention, x, cfg: ModelConfig, positions):
    dt = x.dtype
    b, s, _ = x.shape
    q = x @ weight(p.wq, dt)
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
    k = x @ weight(p.wk, dt)
    v = x @ weight(p.wv, dt)
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
    q = shard(q, "batch", "model", None, None)
    if memory is not None:
        ctx = _on_ranks(_attend, q, *memory, causal=False, **blocks)
        return ctx.transpose(1, 2).reshape(b, s, -1) @ weight(p.wo, x.dtype), None
    k, v = _project_kv(p, x, cfg, positions)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    new_cache = None
    if cache is None:
        ctx = _on_ranks(_attend, q, k, v, causal=causal, **blocks)
    else:
        start = cache.length
        if start + s > cache.k.shape[2]:
            raise ValueError(
                f"KV cache overflow: {start} cached + {s} new tokens > max_len {cache.k.shape[2]}"
            )
        ctx = _on_ranks(_cached, q, k, v, cache.k, cache.v, start=start, **blocks)
        new_cache = KVCache(k=cache.k, v=cache.v, length=start + s)
    ctx = ctx.transpose(1, 2).reshape(b, s, -1)
    return ctx @ weight(p.wo, x.dtype), new_cache


def _attend(q, k, v, *, heads=None, **kw):
    """``q`` against the KV heads ``heads`` picks of ``k``/``v`` (all of
    them by default) on the kernel."""
    heads = heads or (lambda t: t)
    return kops.attention(q, heads(k), heads(v), **kw)


def _cached(q, k, v, kc, vc, *, start: int, heads=None, seq=None, **kw):
    """Write ``k``/``v`` into the caches ``kc``/``vc`` at ``start``, then
    attend: within the new rows on the kernel in prefill (a fresh cache
    starts at length 0), against the cache's valid prefix in decode.
    ``seq = (group, first)``: the caches hold the positions ``[first,
    first + len)`` of a sequence sharded over ``group``."""
    heads = heads or (lambda t: t)
    s = q.shape[2]
    first = 0 if seq is None else seq[1]
    lo, hi = max(start, first), min(start + s, first + kc.shape[2])
    if lo < hi:  # the new positions this rank's caches hold
        kc[:, :, lo - first : hi - first] = k[:, :, lo - start : hi - start].to(kc.dtype)
        vc[:, :, lo - first : hi - first] = v[:, :, lo - start : hi - start].to(vc.dtype)
    if seq is not None and s == 1:
        return _split_decode(q, kc, vc, start, heads, *seq)
    if s > 1:
        return kops.attention(q, heads(k).to(q.dtype), heads(v).to(q.dtype), causal=True, **kw)
    return _decode_attention(q, heads(kc), heads(vc), start, s)


def _split_decode(q, kc, vc, start: int, heads, group, first: int):
    """One decode query against caches whose sequence is sharded over
    ``group`` (``long_500k``: batch 1, the positions spread over the data
    ranks): each rank attends over its positions ``[first, first + len)``
    and the partial softmaxes combine by their maxima and sums
    (``all_reduce`` over ``group``)."""
    from torch.distributed import _functional_collectives as funcol

    local = kc.shape[2]
    kh, vh = heads(kc), heads(vc)
    b, h, _, dh = q.shape
    hkv = kh.shape[1]
    qg = q.reshape(b, hkv, h // hkv, 1, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, kh).float() * dh**-0.5
    kpos = first + torch.arange(local, device=q.device)
    logits = torch.where(kpos <= start, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    top = funcol.all_reduce(m, "max", group)
    p = torch.exp(logits - top)
    total = funcol.all_reduce(p.sum(dim=-1, keepdim=True), "sum", group)
    ctx = funcol.all_reduce(torch.einsum("bhgqk,bhkd->bhgqd", p, vh.float()), "sum", group)
    return (ctx / total).to(q.dtype).reshape(b, h, 1, dh)


def _rank_kv(hq_local: int, hkv: int, tp: int, rank: int):
    """The KV heads of model rank ``rank``'s query heads ``[rank·hq_local,
    (rank+1)·hq_local)``, as a function of a ``(B, Hkv, …)`` tensor: query
    head ``i`` reads KV head ``i // (tp·hq_local / hkv)``.  A contiguous
    block of heads each shared by the same number of local query heads is
    a view; otherwise one KV head per query head is gathered."""
    group = hq_local * tp // hkv
    idx = [(rank * hq_local + j) // group for j in range(hq_local)]
    lo, n = idx[0], idx[-1] - idx[0] + 1
    if hq_local % n == 0 and idx == [lo + j // (hq_local // n) for j in range(hq_local)]:
        return lambda t: t.narrow(1, lo, n)
    return lambda t: t[:, idx]


def _on_ranks(fn, q, k, v, *caches, **kw):
    """``fn(q, k, v, *caches, **kw)``; on DTensors, on each rank's local
    tensors: ``q`` (and the output) sharded on batch and heads, ``k``/``v``
    replicated over ``model`` (their gradients partial there: each model
    rank reads only its query heads' KV heads), the caches as they are
    laid out, and ``fn`` given the rank's KV heads (:func:`_rank_kv`)."""
    if not is_distributed(q):
        return fn(q, k, v, *caches, **kw)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    k, v = (shard(t, "batch", None, None, None) for t in (k, v))
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    tp = mesh.size(names.index("model")) if "model" in names else 1
    rank = mesh.get_local_rank("model") if "model" in names else 0
    heads = _rank_kv(q.shape[1] // tp, k.shape[1], tp, rank)
    split = [i for i, p in enumerate(caches[0].placements) if p.is_shard(2)] if caches else []
    if split:  # the caches' sequence sharded (one axis): the rank's first position
        rows = -(-caches[0].shape[2] // mesh.size(split[0]))
        kw["seq"] = ((mesh, split[0]), mesh.get_local_rank(split[0]) * rows)
    grad_kv = tuple(Partial() if isinstance(pl, Replicate) and name == "model" else pl
                    for name, pl in zip(names, k.placements))
    args = (q, k, v, *caches)
    run = local_map(
        lambda *local: fn(*local, heads=heads, **kw),
        out_placements=list(q.placements),
        in_placements=tuple(t.placements for t in args),
        in_grad_placements=(q.placements, grad_kv, grad_kv) + tuple(t.placements for t in caches),
        device_mesh=mesh,
    )
    return run(*args)


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


def init_cache(cfg: ModelConfig, batch: int, max_len: int, tp: int = 1, *, dtype=None,
               device="cuda") -> KVCache:
    """Zeroed ``(batch, Hkv, max_len, dh)`` caches: every KV head at any
    ``tp`` (the reference's shape; a mesh replicates them over ``model``)."""
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
    k = (enc_out @ weight(p.wk, dt)).reshape(b, s, -1, cfg.head_dim)
    v = (enc_out @ weight(p.wv, dt)).reshape(b, s, -1, cfg.head_dim)
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
