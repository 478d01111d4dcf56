"""Shared building blocks: norms, RoPE, MLPs, embeddings.

The port of ``repro.models.layers``.  Parameters live in ``nn.Module``s
whose names are the reference's leaf names without their sharding suffixes
(``wq_cs`` → ``wq``; :func:`repro_torch.convert.model_params_from_numpy`
maps one onto the other), in the reference's ``(d_in, d_out)`` layout, so
a layer is ``x @ w``.  ``<name>_init(generator, cfg, ..., device=)`` draws
from an explicit ``torch.Generator`` on ``device``; ``<name>_apply(module,
x, cfg)`` runs it.  The reference's cast points are kept: parameters are
stored in ``cfg.param_dtype``, compute runs in ``cfg.dtype``, and norms,
RoPE and activations compute in f32 and cast back, as the reference does,
so the two packages round alike in bf16.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import gathered, is_distributed, shard

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The compute dtype, ``cfg.dtype``."""
    return DTYPES[cfg.dtype]


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def weight(w: torch.Tensor, dtype) -> torch.Tensor:
    """A parameter in the compute dtype ``dtype``, ready for a product: on
    a mesh cast on its shards, then its ZeRO shards gathered
    (``sharding.gathered``)."""
    return gathered(w.to(dtype))


def dense_init(generator, d_in: int, d_out: int, dtype, device, scale: Optional[float] = None):
    """A ``(d_in, d_out)`` weight, ``N(0, 1)·scale`` with scale ``d_in^-½``."""
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    w = torch.randn((d_in, d_out), generator=generator, dtype=dtype, device=device)
    return _param(w * scale)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """RMS norm (``scale``) or layer norm (``scale``, ``bias``)."""

    def __init__(self, cfg: ModelConfig, d: int, device):
        super().__init__()
        self.scale = _param(torch.ones((d,), dtype=param_dtype(cfg), device=device))
        if cfg.norm_type == "layer":
            self.bias = _param(torch.zeros((d,), dtype=param_dtype(cfg), device=device))


def norm_init(cfg: ModelConfig, d: Optional[int] = None, *, device="cuda") -> Norm:
    return Norm(cfg, d or cfg.d_model, device)


def norm_apply(norm: Norm, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "layer":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * norm.scale.float() + norm.bias.float()
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + cfg.norm_eps) * norm.scale.float()
    return out.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over the trailing (head) dim: qk-norm."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float, pct: float) -> torch.Tensor:
    """Rotary embedding on (..., seq, n_heads, head_dim); partial if pct < 1."""
    dh = x.shape[-1]
    rot = int(dh * pct) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = xr[..., :half].float(), xr[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < dh else out


def sinusoidal_positions(seq: int, d: int, dtype, *, start: int = 0, device="cuda") -> torch.Tensor:
    """Rows ``[start, start + seq)`` of the absolute sinusoidal position
    table: the reference's formula and dtype, without building the rows
    before ``start`` (its decode step builds 2¹⁷ and slices)."""
    pos = torch.arange(start, start + seq, dtype=torch.float32, device=device)[:, None]
    half = d // 2
    freqs = 10000.0 ** (-torch.arange(half, dtype=torch.float32, device=device) / half)
    ang = pos * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """SwiGLU (``gate``, ``up``, ``down``) or GELU (``up``, ``up_bias``,
    ``down``, ``down_bias``)."""

    def __init__(self, generator, cfg: ModelConfig, d_ff: int, device):
        super().__init__()
        pd, d = param_dtype(cfg), cfg.d_model
        if cfg.mlp_type == "swiglu":
            self.gate = dense_init(generator, d, d_ff, pd, device)
            self.up = dense_init(generator, d, d_ff, pd, device)
            self.down = dense_init(generator, d_ff, d, pd, device)
        else:
            self.up = dense_init(generator, d, d_ff, pd, device)
            self.up_bias = _param(torch.zeros((d_ff,), dtype=pd, device=device))
            self.down = dense_init(generator, d_ff, d, pd, device)
            self.down_bias = _param(torch.zeros((d,), dtype=pd, device=device))


def mlp_init(generator, cfg: ModelConfig, d_ff: Optional[int] = None, *, device="cuda") -> MLP:
    return MLP(generator, cfg, d_ff or cfg.d_ff, device)


def mlp_apply(mlp: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = compute_dtype(cfg)
    if cfg.mlp_type == "swiglu":
        g = x @ weight(mlp.gate, dt)
        u = x @ weight(mlp.up, dt)
        h = F.silu(g.float()).to(dt) * u
        h = shard(h, "batch", None, "model")
        return h @ weight(mlp.down, dt)
    h = x @ weight(mlp.up, dt) + mlp.up_bias.to(dt)
    h = F.gelu(h.float(), approximate="tanh").to(dt)  # jax.nn.gelu's default
    h = shard(h, "batch", None, "model")
    return h @ weight(mlp.down, dt) + mlp.down_bias.to(dt)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rounded up to 256, as the reference pads it."""
    return round_up(cfg.vocab_size, 256)


class Embed(nn.Module):
    """The (padded vocab, d) ``table`` and, untied, the ``lm_head``."""

    def __init__(self, generator, cfg: ModelConfig, device):
        super().__init__()
        pd, v = param_dtype(cfg), padded_vocab(cfg)
        table = torch.randn((v, cfg.d_model), generator=generator, dtype=pd, device=device)
        self.table = _param(table * 0.02)
        if not cfg.tie_embeddings:
            self.lm_head = dense_init(generator, cfg.d_model, v, pd, device)


def embed_init(generator, cfg: ModelConfig, *, device="cuda") -> Embed:
    return Embed(generator, cfg, device)


def embed_apply(embed: Embed, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # Gather, then cast: the same values as the reference's cast-then-take,
    # without casting the whole table each step.
    if is_distributed(embed.table):
        return shard(_sharded_lookup(gathered(embed.table), tokens), "batch", None, None).to(
            compute_dtype(cfg))
    return embed.table[tokens].to(compute_dtype(cfg))


def _sharded_lookup(table, tokens):
    """``table[tokens]`` for a vocab-sharded DTensor ``table``: each model
    rank looks up the tokens in its rows (zeros for the others), so the
    rows come out partial over ``model``, batch-sharded as ``tokens``."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    model = names.index("model")
    rows = -(-table.shape[0] // mesh.size(model))
    first = mesh.get_local_rank("model") * rows
    tok = tokens.placements
    out = [Partial() if i == model else p for i, p in enumerate(tok)]
    grad = [p if i == model else Partial() if t.is_shard() else Replicate()
            for i, (p, t) in enumerate(zip(table.placements, tok))]

    def lookup(t, ids):
        own = (ids >= first) & (ids < first + t.shape[0])
        return torch.where(own[..., None], t[(ids - first).clamp(0, t.shape[0] - 1)], 0)

    return local_map(lookup, out_placements=out, in_placements=(table.placements, tok),
                     in_grad_placements=(grad, tok), device_mesh=mesh)(table, tokens)


def lm_head_weights(embed: Embed, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return weight(embed.table, compute_dtype(cfg)).T
    return weight(embed.lm_head, compute_dtype(cfg))
