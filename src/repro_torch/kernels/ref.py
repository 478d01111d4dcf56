"""Plain-torch oracles: the semantic definitions the kernels must match.

One per oracle of ``repro.kernels.ref`` that this slice of the port uses.
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
