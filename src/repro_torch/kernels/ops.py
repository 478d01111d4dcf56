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

from repro_torch.kernels import _runtime, cg_fused, ref
from repro_torch.kernels import flash_attention as attn_mod
from repro_torch.kernels import rbf_matvec as rbf_mod
from repro_torch.kernels import ssd_scan as ssd_mod

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
    gate: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``K(X, X) @ v`` for the RBF kernel without forming K (except the
    ``reference`` oracle).  ``v`` may be ``(n,)`` or ``(n, r)`` (multi-RHS,
    e.g. the ``A·W`` refresh of a k-vector basis in one pass).  ``block``
    is the plain version's row block; the kernel's tiles are fixed.
    ``gate`` (a bool device vector or 0-d flag, any stride) makes the
    product zeros when no flag is set: on the card the kernel reads the
    flags itself and skips the Gram tiles, with no host read."""
    backend = _resolve(backend, x)
    if backend == "cuda":
        return rbf_mod.rbf_matvec_cuda(x, v, theta, lengthscale, gate)
    if backend == "plain":
        return rbf_mod.rbf_matvec_plain(x, v, theta, lengthscale, block, gate)
    return rbf_mod._gated_plain(ref.rbf_matvec(x, v, theta, lengthscale), gate)


def rbf_matvec_rect(
    x_rows: torch.Tensor,
    x_cols: torch.Tensor,
    v: torch.Tensor,
    theta: float,
    lengthscale: float,
    *,
    backend: str = "auto",
    block: int = 1024,
    gate: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Rectangular Gram matvec ``K(X_rows, X_cols) @ v`` without forming
    the (m, n) block (except the ``reference`` oracle): the per-rank
    product of the sharded RBF operator, this rank's rows against all
    columns.  ``x_rows`` is (m, d), ``x_cols`` (n, d), ``v`` (n,) or
    (n, r); the result (m,) or (m, r).  ``gate`` as in :func:`rbf_matvec`."""
    backend = _resolve(backend, x_rows)
    if backend == "cuda":
        return rbf_mod.rbf_matvec_rect_cuda(x_rows, x_cols, v, theta, lengthscale, gate)
    if backend == "plain":
        return rbf_mod.rbf_matvec_rect_plain(x_rows, x_cols, v, theta, lengthscale, block,
                                             gate)
    return rbf_mod._gated_plain(ref.rbf_matvec_rect(x_rows, x_cols, v, theta, lengthscale),
                                gate)


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


def fused_cg_step(
    x: torch.Tensor,
    r: torch.Tensor,
    p: torch.Tensor,
    ap: torch.Tensor,
    d: torch.Tensor,
    rs: torch.Tensor,
    rnorm: torch.Tensor,
    js: torch.Tensor,
    active: torch.Tensor,
    threshold: torch.Tensor,
    diverged_at: torch.Tensor,
    maxiter: int,
    aw: Optional[torch.Tensor] = None,
    waw_inv: Optional[torch.Tensor] = None,
    *,
    recurrence: bool = True,
    trace: Optional[torch.Tensor] = None,
    row: Optional[int] = None,
    a_rows: Optional[torch.Tensor] = None,
    b_rows: Optional[torch.Tensor] = None,
    window: int = 0,
    best: Optional[torch.Tensor] = None,
    backend: str = "auto",
):
    """def-CG's iteration from ``d = pᵀAp`` on, around the fused update:
    breakdown test, α, the update, and (``recurrence``) β and μ, then the
    residual norm, status, trace, j, the next active flag and, with
    ``window > 0``, the stall detector — one launch on the card.  Returns
    ``(x, r, ap, so, js, flags)``; see
    :func:`repro_torch.kernels.cg_fused.fused_cg_step_cuda`.  The step has
    no oracle of its own: ``reference`` runs its plain version, built on
    the oracles."""
    backend = _resolve(backend, x)
    step = cg_fused.fused_cg_step_cuda if backend == "cuda" else cg_fused.fused_cg_step_plain
    return step(x, r, p, ap, d, rs, rnorm, js, active, threshold, diverged_at, maxiter, aw,
                waw_inv, recurrence=recurrence, trace=trace, row=row, a_rows=a_rows,
                b_rows=b_rows, window=window, best=best)


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


def fused_rz_step(
    r: torch.Tensor,
    z: torch.Tensor,
    rs: torch.Tensor,
    aw: Optional[torch.Tensor] = None,
    waw_inv: Optional[torch.Tensor] = None,
    *,
    alpha: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
    row: Optional[int] = None,
    a_rows: Optional[torch.Tensor] = None,
    b_rows: Optional[torch.Tensor] = None,
    backend: str = "auto",
):
    """The preconditioned def-CG / cg tail after ``z = M⁻¹r``: ``rᵀz``,
    ``β = rᵀz / safe(rs)``, ``μ = waw_inv·(AW)ᵀz`` and, on a recording step,
    ``α, β`` into row ``active ? row : ell`` of ``a_rows, b_rows`` — one
    launch on the card.  Returns ``so = [rᵀz, β, μ…]``; see
    :func:`repro_torch.kernels.cg_fused.fused_rz_step_cuda`.  ``reference``
    runs the plain version, built on the oracle."""
    backend = _resolve(backend, r)
    step = cg_fused.fused_rz_step_cuda if backend == "cuda" else cg_fused.fused_rz_step_plain
    return step(r, z, rs, aw, waw_inv, alpha=alpha, active=active, row=row, a_rows=a_rows,
                b_rows=b_rows)


def fused_rz_pair(
    r: torch.Tensor,
    ap: torch.Tensor,
    aw: Optional[torch.Tensor] = None,
    *,
    backend: str = "auto",
):
    """``(rᵀap, AW @ ap, rᵀr, AW @ r)`` in one pass over ``r``, ``ap`` and
    ``aw``: the sharded def-CG's fresh reductions, each summed as
    :func:`fused_rz_reduce` sums it.  ``reference`` runs the two oracle
    calls it replaces."""
    backend = _resolve(backend, r)
    if backend == "cuda":
        return cg_fused.fused_rz_pair_cuda(r, ap, aw)
    if backend == "plain":
        return cg_fused.fused_rz_pair_plain(r, ap, aw)
    return ref.fused_rz_reduce(r, ap, aw) + ref.fused_rz_reduce(r, r, aw)


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


def fused_direction_step(
    z: torch.Tensor,
    p: torch.Tensor,
    beta: torch.Tensor,
    keep: torch.Tensor,
    w: Optional[torch.Tensor] = None,
    mu: Optional[torch.Tensor] = None,
    *,
    ap: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
    row: Optional[int] = None,
    p_buf: Optional[torch.Tensor] = None,
    ap_buf: Optional[torch.Tensor] = None,
    backend: str = "auto",
):
    """The solver loops' direction step: a fresh ``keep ? β p + z − μᵀW :
    p`` with ``β``, ``μ`` and ``keep`` on the device, and on a recording
    step the incoming ``(p, ap)`` written to row ``active ? row : ell`` of
    the buffers in place — one launch on the card.  See
    :func:`repro_torch.kernels.cg_fused.fused_direction_step_cuda`;
    ``reference`` runs the plain version, built on the oracle."""
    backend = _resolve(backend, z)
    step = (cg_fused.fused_direction_step_cuda if backend == "cuda"
            else cg_fused.fused_direction_step_plain)
    return step(z, p, beta, keep, w, mu, ap=ap, active=active, row=row, p_buf=p_buf,
                ap_buf=ap_buf)


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


def lsmr_step(
    x: torch.Tensor,
    hbar: torch.Tensor,
    h: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    wsq: torch.Tensor,
    beta: torch.Tensor,
    s: torch.Tensor,
    js: torch.Tensor,
    active: torch.Tensor,
    threshold: torch.Tensor,
    diverged_at: torch.Tensor,
    maxiter: int,
    trace: Optional[torch.Tensor] = None,
    *,
    window: int = 0,
    backend: str = "auto",
):
    """The LSMR iteration after its last reduction (``wsq = ‖w‖²``): α⁺,
    both Givens rotations, ``v⁺``, the three vector recurrences, the
    latches, trace, j, the next active flag and, with ``window > 0``, the
    stall detector, every output masked by ``active`` — one launch on the
    card.  Returns ``(x, h̄, h, v, s, js,
    active)``; see :func:`repro_torch.kernels.cg_fused.lsmr_step_cuda`.
    ``reference`` runs the plain version, built on the oracles."""
    backend = _resolve(backend, x)
    step = cg_fused.lsmr_step_cuda if backend == "cuda" else cg_fused.lsmr_step_plain
    return step(x, hbar, h, v, w, wsq, beta, s, js, active, threshold, diverged_at, maxiter,
                trace, window)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    backend: str = "auto",
    block_q: int = 512,
    block_k: int = 1024,
) -> torch.Tensor:
    """GQA softmax attention (see :func:`ref.mha_attention`): ``q`` (b, h,
    sq, dh) against ``k``/``v`` (b, hkv, sk, dh).  ``block_q``/``block_k``
    are the plain version's blocks; the kernel's tiles are fixed.

    When autograd or a ``torch.func`` transform tracks an input, the
    ``cuda`` and ``plain`` backends run through
    :class:`~repro_torch.kernels.flash_attention.FlashAttention` (its
    forward with the row log-sum-exp, its backward and forward-mode arms;
    ``q_offset`` must be 0 there, as in training); otherwise the serving
    arm runs as it is.  ``reference`` is differentiated by autograd."""
    backend = _resolve(backend, q)
    if backend != "reference" and _runtime.differentiated(q, k, v):
        if q_offset:
            raise ValueError(f"attention: a differentiated call needs q_offset = 0, got {q_offset}")
        return attn_mod.flash_attention_differentiable(q, k, v, causal=causal, scale=scale,
                                                       plain=backend == "plain")
    if backend == "cuda":
        return attn_mod.flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                             q_offset=q_offset)
    if backend == "plain":
        return attn_mod.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                              q_offset=q_offset, block_q=block_q,
                                              block_k=block_k)
    return ref.mha_attention(q, k, v, causal=causal, scale=scale, q_offset=q_offset)


def ssd(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    bmat: torch.Tensor,
    cmat: torch.Tensor,
    d: Optional[torch.Tensor] = None,
    *,
    backend: str = "auto",
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """Mamba2 SSD scan over ``x`` (b, l, h, p); optionally seeded with and
    returning the (b, h, p, n) f32 state (the serving path's prefill).  The
    ``reference`` oracle has no state, so with one it runs the plain
    version, as the reference's own oracle arm falls back to its chunked
    scan.

    When autograd or a ``torch.func`` transform tracks an input, the
    ``cuda`` and ``plain`` backends run through
    :class:`~repro_torch.kernels.ssd_scan.SSDScan` (its training forward,
    backward and forward-mode arms), with the D skip ``y + x·d`` added
    outside it; otherwise the serving arm runs as it is.  ``reference`` is
    differentiated by autograd."""
    backend = _resolve(backend, x)
    if backend != "reference" and _runtime.differentiated(x, dt, a, bmat, cmat, d,
                                                          initial_state):
        y, h1 = ssd_mod.ssd_differentiable(x, dt, a, bmat, cmat, chunk=chunk,
                                           initial_state=initial_state,
                                           plain=backend == "plain")
        y = ssd_mod._skip(y, x, d)
        return (y, h1) if return_state else y
    kw = dict(chunk=chunk, initial_state=initial_state, return_state=return_state)
    if backend == "cuda":
        return ssd_mod.ssd_scan_cuda(x, dt, a, bmat, cmat, d, **kw)
    if backend == "plain" or return_state or initial_state is not None:
        return ssd_mod.ssd_plain(x, dt, a, bmat, cmat, d, **kw)
    return ref.ssd_reference(x, dt, a, bmat, cmat, d)


def ssd_decode_step(hstate, x_t, dt_t, a, b_t, c_t, d=None):
    """One SSD decode step, ``O(h·p·n)``: the state (b, h, p, n) advances by
    the token ``x_t`` (b, h, p) with ``dt_t`` (b, h), ``b_t``/``c_t``
    (b, g, n).  Plain PyTorch, as the reference's step is plain jnp.
    Returns ``(new_state, y_t)``."""
    hpg = x_t.shape[1] // b_t.shape[1]
    decay = torch.exp(a[None, :] * dt_t)  # (b, h)
    bth = b_t.repeat_interleave(hpg, dim=1)
    cth = c_t.repeat_interleave(hpg, dim=1)
    upd = torch.einsum("bhp,bhn->bhpn", x_t * dt_t[..., None], bth)
    new = hstate * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new, cth)
    if d is not None:
        y = y + x_t * d[None, :, None]
    return new, y.to(x_t.dtype)
