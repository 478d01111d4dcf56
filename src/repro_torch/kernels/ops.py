"""Public kernel entry points, dispatched by device.

Every op takes a keyword-only ``backend ∈ {"auto", "cuda", "plain",
"reference"}``:

* ``cuda``      — the hand-written Hopper kernel (raises off the card);
* ``plain``     — the plain PyTorch version beside the kernel;
* ``reference`` — the oracle in :mod:`repro_torch.kernels.ref`;
* ``auto``      — ``cuda`` for CUDA tensors, ``plain`` for CPU tensors.

Nothing falls back: a CUDA tensor under ``auto`` launches the kernel or
the call raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cg_fused, ref
from repro_torch.kernels import rbf_matvec as rbf_mod

_BACKENDS = ("auto", "cuda", "plain", "reference")


def _resolve(backend: str, t: torch.Tensor) -> str:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend={backend!r}; expected one of {_BACKENDS}")
    if backend == "auto":
        return "cuda" if t.device.type == "cuda" else "plain"
    if backend == "cuda" and t.device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors, got a {t.device} tensor")
    return backend


def rbf_matvec(
    x: torch.Tensor,
    v: torch.Tensor,
    theta: float,
    lengthscale: float,
    *,
    backend: str = "auto",
    block: int = 1024,
) -> torch.Tensor:
    """``K(X, X) @ v`` for the RBF kernel without forming K (except the
    ``reference`` oracle).  ``v`` may be ``(n,)`` or ``(n, r)`` (multi-RHS,
    e.g. the ``A·W`` refresh of a k-vector basis in one pass).  ``block``
    is the plain version's row block; the kernel's tiles are fixed."""
    backend = _resolve(backend, x)
    if backend == "cuda":
        return rbf_mod.rbf_matvec_cuda(x, v, theta, lengthscale)
    if backend == "plain":
        return rbf_mod.rbf_matvec_plain(x, v, theta, lengthscale, block)
    return ref.rbf_matvec(x, v, theta, lengthscale)


def rbf_matvec_rect(
    x_rows: torch.Tensor,
    x_cols: torch.Tensor,
    v: torch.Tensor,
    theta: float,
    lengthscale: float,
    *,
    backend: str = "auto",
    block: int = 1024,
) -> torch.Tensor:
    """Rectangular Gram matvec ``K(X_rows, X_cols) @ v`` without forming
    the (m, n) block (except the ``reference`` oracle): the per-rank
    product of the sharded RBF operator, this rank's rows against all
    columns.  ``x_rows`` is (m, d), ``x_cols`` (n, d), ``v`` (n,) or
    (n, r); the result (m,) or (m, r)."""
    backend = _resolve(backend, x_rows)
    if backend == "cuda":
        return rbf_mod.rbf_matvec_rect_cuda(x_rows, x_cols, v, theta, lengthscale)
    if backend == "plain":
        return rbf_mod.rbf_matvec_rect_plain(x_rows, x_cols, v, theta, lengthscale, block)
    return ref.rbf_matvec_rect(x_rows, x_cols, v, theta, lengthscale)


def fused_cg_update(
    x: torch.Tensor,
    r: torch.Tensor,
    p: torch.Tensor,
    ap: torch.Tensor,
    alpha,
    aw: Optional[torch.Tensor] = None,
    *,
    backend: str = "auto",
):
    """``(x + α p, r − α ap, ‖r_new‖², AW @ r_new | None)`` in one pass."""
    backend = _resolve(backend, x)
    if backend == "cuda":
        return cg_fused.fused_cg_update_cuda(x, r, p, ap, alpha, aw)
    if backend == "plain":
        return cg_fused.fused_cg_update_plain(x, r, p, ap, alpha, aw)
    return ref.fused_cg_update(x, r, p, ap, alpha, aw)


def fused_rz_reduce(
    r: torch.Tensor,
    z: torch.Tensor,
    aw: Optional[torch.Tensor] = None,
    *,
    backend: str = "auto",
):
    """``(rᵀz, AW @ z | None)`` in one pass: the preconditioned def-CG
    iteration's second sweep (``z = M⁻¹r`` exists only after the residual
    update, so it cannot ride in :func:`fused_cg_update`)."""
    backend = _resolve(backend, r)
    if backend == "cuda":
        return cg_fused.fused_rz_reduce_cuda(r, z, aw)
    if backend == "plain":
        return cg_fused.fused_rz_reduce_plain(r, z, aw)
    return ref.fused_rz_reduce(r, z, aw)


def fused_deflate_direction(
    r: torch.Tensor,
    p: torch.Tensor,
    beta,
    w: Optional[torch.Tensor] = None,
    mu: Optional[torch.Tensor] = None,
    ap: Optional[torch.Tensor] = None,
    idx=None,
    p_buf: Optional[torch.Tensor] = None,
    ap_buf: Optional[torch.Tensor] = None,
    *,
    backend: str = "auto",
):
    """``p ← β p + r − μᵀ W`` fused with the guarded recording write.

    With ``p_buf``/``ap_buf`` the incoming ``(p, ap)`` go to row ``idx``
    (callers point ``idx`` at a spare row to suppress the write).  The
    ``cuda`` and ``plain`` backends write the buffers in place; the
    ``reference`` oracle returns written copies.  Returns
    ``(p_new, p_buf, ap_buf)``.
    """
    backend = _resolve(backend, r)
    args = (r, p, beta, w, mu, ap, idx, p_buf, ap_buf)
    if backend == "cuda":
        return cg_fused.fused_deflate_direction_cuda(*args)
    if backend == "plain":
        return cg_fused.fused_deflate_direction_plain(*args)
    return ref.fused_deflate_direction(*args)


def self_gram(s: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """``S Sᵀ`` for a stacked flat basis ``S`` of shape ``(m, n)``."""
    backend = _resolve(backend, s)
    if backend == "cuda":
        return cg_fused.self_gram_cuda(s)
    if backend == "plain":
        return cg_fused.self_gram_plain(s)
    return ref.self_gram(s)


def recombine_blocks(
    s: torch.Tensor, u: torch.Tensor, *, backend: str = "auto"
) -> torch.Tensor:
    """``[uᵀ·S_top; uᵀ·S_bot]`` — the next ``W`` and ``AW`` in one pass."""
    backend = _resolve(backend, s)
    if backend == "cuda":
        return cg_fused.recombine_blocks_cuda(s, u)
    if backend == "plain":
        return cg_fused.recombine_blocks_plain(s, u)
    return ref.recombine_blocks(s, u)


def lsmr_update(
    x: torch.Tensor,
    hbar: torch.Tensor,
    h: torch.Tensor,
    v: torch.Tensor,
    c0,
    c1,
    c2,
    *,
    backend: str = "auto",
):
    """``(x + c1·(h − c0·h̄), h − c0·h̄, v − c2·h)`` in one pass: the LSMR
    iteration's coupled vector recurrences.  ``c0, c1, c2`` are the
    pre-reduced Givens scalars (0-d device tensors in the solver loop)."""
    backend = _resolve(backend, x)
    if backend == "cuda":
        return cg_fused.lsmr_update_cuda(x, hbar, h, v, c0, c1, c2)
    if backend == "plain":
        return cg_fused.lsmr_update_plain(x, hbar, h, v, c0, c1, c2)
    return ref.lsmr_update(x, hbar, h, v, c0, c1, c2)
