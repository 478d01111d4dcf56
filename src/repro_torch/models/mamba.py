"""Mamba2 (SSD) mixer block: in-proj → causal conv → SSD → gated norm → out.

The port of ``repro.models.mamba``.  One input projection gives
``[z (gate), x (heads·headdim), B, C (groups·state), dt (heads)]``; x/B/C
pass through a short causal depthwise conv; the SSD scan mixes along the
sequence; the output is RMS-gated by ``silu(z)`` and projected back.

The three modes and what runs them:

* full sequence (``state=None``): the SSD scan kernel (K10,
  ``kernels.ops.ssd``) on CUDA tensors, its plain version on CPU tensors;
* stateful prefill (``s > 1``): the same kernel, seeded with the carried
  state and returning the final one (the reference runs its chunked jnp
  scan here, since its Pallas kernel takes no state);
* one-token decode: ``kernels.ops.ssd_decode_step``, plain PyTorch as the
  reference's step is plain jnp.

The decode state is ``(conv tail (K−1 inputs), SSD state (h, p, n) f32)``,
O(1) in the sequence length.

On a mesh (the reference's layout) the ``d_inner`` heads are sharded over
``model`` (``in_proj`` column-, ``out_proj`` row-parallel, the per-head
vectors with them) and B/C (one group) replicated: the SSD mixing runs on
each rank's local heads (``local_map``), the kernel launching there as on
one device; the depthwise convolution runs on the whole channels, which
the split after it needs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _param, compute_dtype, dense_init, param_dtype, weight
from repro_torch.models.sharding import is_distributed, shard


class SSMState(NamedTuple):
    conv: torch.Tensor  # (B, K-1, conv_dim) rolling input tail
    ssd: torch.Tensor  # (B, H, P, N) f32


def _dims(cfg: ModelConfig):
    di, h, p = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    return di, h, p, g, n, di + 2 * g * n


class Mamba(nn.Module):
    """``in_proj``, ``conv_w``, ``conv_b``, ``a_log``, ``dt_bias``,
    ``d_skip``, ``gate_norm``, ``out_proj``."""

    def __init__(self, generator, cfg: ModelConfig, device):
        super().__init__()
        pd = param_dtype(cfg)
        di, h, p, g, n, conv_dim = _dims(cfg)

        def uniform(lo, hi, size):
            u = torch.rand((size,), generator=generator, dtype=pd, device=device)
            return lo + (hi - lo) * u

        self.in_proj = dense_init(generator, cfg.d_model, 2 * di + 2 * g * n + h, pd, device)
        conv_w = torch.randn((conv_dim, cfg.ssm_conv), generator=generator, dtype=pd,
                             device=device)
        self.conv_w = _param(conv_w * cfg.ssm_conv**-0.5)
        self.conv_b = _param(torch.zeros((conv_dim,), dtype=pd, device=device))
        self.a_log = _param(torch.log(uniform(1.0, 16.0, h)))
        self.dt_bias = _param(torch.log(torch.expm1(uniform(1e-3, 0.1, h))))
        self.d_skip = _param(torch.ones((h,), dtype=pd, device=device))
        self.gate_norm = _param(torch.ones((di,), dtype=pd, device=device))
        self.out_proj = dense_init(generator, di, cfg.d_model, pd, device)


def mamba_init(generator, cfg: ModelConfig, *, device="cuda") -> Mamba:
    return Mamba(generator, cfg, device)


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di, h, p, g, n, _ = _dims(cfg)
    return torch.split(zxbcdt, [di, di, g * n, g * n, h], dim=-1)


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (C, K): the
    reference's einsum over the K taps, summed in f32 on the weights cast
    to ``seq.dtype`` and rounded once, then the bias in ``seq.dtype``."""
    k, s = w.shape[-1], seq.shape[1]
    wk = weight(w, seq.dtype).float()
    pad = F.pad(seq, (0, 0, k - 1, 0))
    acc = pad[:, 0:s].float() * wk[:, 0]
    for i in range(1, k):
        acc = acc + pad[:, i : i + s].float() * wk[:, i]
    return acc.to(seq.dtype) + b.to(seq.dtype)


def _conv(seq, w, b):
    """:func:`_causal_conv`; on DTensors, on each rank's local rows with the
    whole kernel (every channel: the split that follows needs them all),
    its gradient partial over the batch axes."""
    if not is_distributed(seq):
        return _causal_conv(seq, w, b)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = seq.device_mesh
    whole = (Replicate(),) * mesh.ndim
    grad = tuple(Partial() if p.is_shard() else Replicate() for p in seq.placements)
    w, b = (t.redistribute(mesh, whole) for t in (w, b))
    return local_map(_causal_conv, out_placements=list(seq.placements),
                     in_placements=(seq.placements, whole, whole),
                     in_grad_placements=(seq.placements, grad, grad), device_mesh=mesh)(seq, w, b)


def mamba_apply(
    m: Mamba,
    xres: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    *,
    state: Optional[SSMState] = None,
    backend: str = "auto",
) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """Full-sequence scan (``state=None``) or stateful prefill / decode,
    which return the advanced state.  ``cfg.attn_impl == "reference"``
    runs the sequential oracle where it applies (no state)."""
    dt_ = xres.dtype
    b, s, _ = xres.shape
    di, h, p, g, n, _ = _dims(cfg)
    backend = "reference" if cfg.attn_impl == "reference" else backend

    z, xin, bmat, cmat, dtraw = _split_proj(xres @ weight(m.in_proj, dt_), cfg)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)  # (B, S, conv_dim)
    new_state = None
    if state is None:
        conv_out = _conv(conv_in, m.conv_w, m.conv_b)
    else:
        ktail = cfg.ssm_conv - 1
        hist = torch.cat([shard(state.conv, "batch", None, None), conv_in], dim=1)
        conv_out = _conv(hist, m.conv_w, m.conv_b)[:, ktail:]
        new_conv = hist[:, hist.shape[1] - ktail :]

    conv_out = F.silu(conv_out.float()).to(dt_)
    xc, bc, cc = torch.split(conv_out, [di, g * n, g * n], dim=-1)
    xh = shard(xc.reshape(b, s, h, p), "batch", None, "model", None)
    bh = bc.reshape(b, s, g, n)
    ch = cc.reshape(b, s, g, n)
    dt_act = F.softplus(dtraw.float() + m.dt_bias.float())
    a = -torch.exp(m.a_log.float())
    d_skip = m.d_skip.float()

    h0 = None if state is None else state.ssd
    y, ssd_state = _on_head_ranks(xh, dt_act, a, bh, ch, d_skip, h0, chunk=cfg.ssm_chunk,
                                  backend=backend)
    if state is not None:
        new_state = SSMState(conv=new_conv, ssd=ssd_state)

    y = y.reshape(b, s, di).to(dt_)
    # Gated RMS norm (Mamba2's norm before the out-projection).
    yf = y.float() * F.silu(z.float())
    ms = yf.square().mean(dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(ms + cfg.norm_eps) * m.gate_norm.float()).to(dt_)
    return y @ weight(m.out_proj, dt_), new_state


def _scan(xh, dt_act, a, bh, ch, d_skip, h0, *, chunk: int, backend: str):
    """The SSD mixing of ``xh`` (B, S, H, P): the kernel over the sequence
    without a state (``h0`` None), seeded with ``h0`` and returning the
    final state in a prefill, the plain decode step for one token;
    ``(y, state | None)``."""
    if h0 is None:
        return kops.ssd(xh, dt_act, a, bh, ch, d_skip, chunk=chunk, backend=backend), None
    if xh.shape[1] > 1:
        return kops.ssd(xh, dt_act, a, bh, ch, d_skip, chunk=chunk, backend=backend,
                        initial_state=h0, return_state=True)
    ssd_state, y = kops.ssd_decode_step(h0, xh[:, 0].float(), dt_act[:, 0], a,
                                        bh[:, 0].float(), ch[:, 0].float(), d_skip)
    return y[:, None], ssd_state


def _on_head_ranks(xh, dt_act, a, bh, ch, d_skip, h0, **kw):
    """:func:`_scan`; on DTensors, on each rank's local tensors with its own
    heads (sharded over ``model`` on the head dims of ``xh``, ``dt``,
    ``a``, ``D`` and the state), ``B``/``C`` replicated over ``model``
    (their gradients partial there), so each rank scans its heads."""
    if not is_distributed(xh):
        return _scan(xh, dt_act, a, bh, ch, d_skip, h0, **kw)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = xh.device_mesh
    names = mesh.mesh_dim_names
    dt_act = shard(dt_act, "batch", None, "model")
    a, d_skip = shard(a, "model"), shard(d_skip, "model")
    bh, ch = shard(bh, "batch", None, None, None), shard(ch, "batch", None, None, None)
    h0 = None if h0 is None else shard(h0, "batch", "model", None, None)
    shared = bh.placements
    shared_grad = tuple(Partial() if isinstance(pl, Replicate) and name == "model" else pl
                        for name, pl in zip(names, shared))
    # a and D are the same on every batch rank: their gradients sum over them.
    per_head_grad = tuple(Partial() if x.is_shard(0) else p
                          for x, p in zip(xh.placements, a.placements))
    state = None if h0 is None else h0.placements
    return local_map(
        lambda *local: _scan(*local, **kw),
        out_placements=(xh.placements, state),
        in_placements=(xh.placements, dt_act.placements, a.placements, shared, shared,
                       d_skip.placements, state),
        in_grad_placements=(xh.placements, dt_act.placements, per_head_grad, shared_grad,
                            shared_grad, per_head_grad, state),
        device_mesh=mesh,
    )(xh, dt_act, a, bh, ch, d_skip, h0)


def init_ssm_state(cfg: ModelConfig, batch: int, *, dtype=None, device="cuda") -> SSMState:
    di, h, p, g, n, conv_dim = _dims(cfg)
    return SSMState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype or compute_dtype(cfg),
                         device=device),
        ssd=torch.zeros((batch, h, p, n), dtype=torch.float32, device=device),
    )
