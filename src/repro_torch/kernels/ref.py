"""Plain-torch oracles: the semantic definitions the kernels must match.

One per oracle of ``repro.kernels.ref`` that the port uses so far.
They are simple, materialise everything, and are functional: the
recording buffers of :func:`fused_deflate_direction` are copied, not
written in place.
"""

from __future__ import annotations

import torch


def rbf_gram(x: torch.Tensor, theta: float, lengthscale: float) -> torch.Tensor:
    """Materialized RBF kernel Gram matrix K(X, X) — O(n²) memory.

    Built in one (n, n) buffer, updated in place: at the paper's n the
    matrix alone is ~10.7 GB in f64.
    """
    sq = torch.sum(x * x, 1)
    k = x @ x.T
    k.mul_(-2.0).add_(sq[:, None]).add_(sq[None, :]).clamp_(min=0.0)
    return k.mul_(-0.5 / lengthscale**2).exp_().mul_(theta**2)


def rbf_matvec(
    x: torch.Tensor, v: torch.Tensor, theta: float, lengthscale: float
) -> torch.Tensor:
    """``K(X,X) @ v`` by materializing K — oracle for the fused kernel."""
    return rbf_gram(x, theta, lengthscale) @ v


def rbf_matvec_rect(
    x_rows: torch.Tensor,
    x_cols: torch.Tensor,
    v: torch.Tensor,
    theta: float,
    lengthscale: float,
) -> torch.Tensor:
    """``K(X_rows, X_cols) @ v`` by materializing the rectangular Gram
    block — oracle for the sharded operator's row-block kernel."""
    xr = x_rows / lengthscale
    xc = x_cols / lengthscale
    d2 = torch.sum(xr * xr, 1)[:, None] + torch.sum(xc * xc, 1)[None, :] - 2.0 * (xr @ xc.T)
    return (theta**2) * torch.exp(-0.5 * torch.clamp(d2, min=0.0)) @ v


def fused_cg_update(x, r, p, ap, alpha, aw=None):
    """``(x + α p, r − α ap, ‖r_new‖², AW @ r_new | None)``."""
    x_new = x + alpha * p
    r_new = r - alpha * ap
    rr = torch.dot(r_new, r_new)
    awr = aw @ r_new if aw is not None else None
    return x_new, r_new, rr, awr


def fused_rz_reduce(r, z, aw=None):
    """``(rᵀz, AW @ z | None)`` — the PCG recurrence scalar and the
    deflation GEMV in the preconditioned inner product."""
    rz = torch.dot(r, z)
    awz = aw @ z if aw is not None else None
    return rz, awz


def fused_deflate_direction(
    r, p, beta, w=None, mu=None, ap=None, idx=None, p_buf=None, ap_buf=None
):
    """``p_new = β p + r − μᵀ W``; with buffers, the incoming ``(p, ap)``
    go to row ``idx`` of copies of them.  Returns ``(p_new, p_buf, ap_buf)``."""
    p_new = beta * p + r
    if w is not None:
        p_new = p_new - mu @ w
    if p_buf is not None:
        p_buf = p_buf.clone()
        ap_buf = ap_buf.clone()
        p_buf[idx] = p
        ap_buf[idx] = ap
    return p_new, p_buf, ap_buf


def lsmr_update(x, hbar, h, v, c0, c1, c2):
    """One LSMR iteration's three vector recurrences (Fong & Saunders 2011,
    rotation scalars pre-reduced by the caller)::

        hbar_new = h − c0·hbar      (c0 = θ̄ρ / (ρ_old ρ̄_old))
        x_new    = x + c1·hbar_new  (c1 = ζ / (ρρ̄))
        h_new    = v − c2·h         (c2 = θ_new / ρ)

    Returns ``(x_new, hbar_new, h_new)``.
    """
    hbar_new = h - c0 * hbar
    x_new = x + c1 * hbar_new
    h_new = v - c2 * h
    return x_new, hbar_new, h_new


def self_gram(s: torch.Tensor) -> torch.Tensor:
    """``S Sᵀ`` for a stacked flat basis ``S`` of shape ``(m, n)``."""
    return s @ s.T


def recombine_blocks(s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``[uᵀ Z; uᵀ AZ]`` for ``s = [Z; AZ]`` of shape ``(2m, n)``."""
    m = u.shape[0]
    ua = u.to(s.dtype)
    return torch.cat([ua.T @ s[:m], ua.T @ s[m:]], dim=0)


def mha_attention(q, k, v, *, causal=False, scale=None, q_offset=0):
    """Softmax attention with grouped KV heads, the (sq × sk) scores
    materialized.  ``q`` (b, h, sq, dh), ``k``/``v`` (b, hkv, sk, dh); query
    row ``i`` sits at absolute position ``q_offset + i`` for the causal mask."""
    b, h, sq, dh = q.shape
    group = h // k.shape[1]
    scale = dh**-0.5 if scale is None else scale
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kk).float() * scale
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(k.shape[2], device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits, -torch.inf)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), vv)


def ssd_reference(x, dt, a, bmat, cmat, d=None):
    """The exact sequential SSD recurrence (arXiv 2405.21060), per head::

        h_t = exp(a·dt_t)·h_{t−1} + dt_t·B_t x_tᵀ,    y_t = C_t h_t (+ D x_t)

    with ``g`` B/C groups shared by the ``h`` heads.  ``x`` (b, l, h, p),
    ``dt`` (b, l, h), ``a`` (h,), ``bmat``/``cmat`` (b, l, g, n)."""
    b, l, h, p = x.shape
    hpg = h // bmat.shape[2]
    state = torch.zeros((b, h, p, bmat.shape[3]), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(l):
        decay = torch.exp(a[None, :] * dt[:, t])  # (b, h)
        bth = bmat[:, t].repeat_interleave(hpg, dim=1)  # (b, h, n)
        cth = cmat[:, t].repeat_interleave(hpg, dim=1)
        upd = dt[:, t, :, None] * x[:, t]  # (b, h, p)
        state = state * decay[..., None, None] + torch.einsum("bhp,bhn->bhpn", upd, bth)
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cth))
    y = torch.stack(ys, dim=1)
    if d is not None:
        y = y + x * d[None, None, :, None]
    return y
