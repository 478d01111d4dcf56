"""Recycled LSMR: regularized least squares (the counterpart of
``repro.core.lsmr``).

LSMR (Fong & Saunders 2011) solves

    min_x ‖A x − b‖² + λ‖x‖²,        A: (m, n) rectangular,

by Golub–Kahan bidiagonalization of the augmented operator
``Â = [A; √λ·I]``, ``b̂ = [b; 0]``.  The initial residual
``r̂₀ = [b − A x₀; −√λ x₀]`` is carried as an explicit ``(u_m, u_n)``
block pair, so a warm start converges to the TRUE ridge solution, not a
proximal one; ``λ = 0`` drops the bottom block.

Recycling lives in the normal-equations geometry: LSMR is MINRES on
``N dx = Âᵀ r̂₀`` with ``N = AᵀA + λI`` (SPD), so a basis ``W`` with
products ``NW`` plays the role ``(W, AW)`` plays for def-CG:

* warm start ``x₀' = x_prev + W (WᵀNW)⁻¹ Wᵀ s₀``, ``s₀ = Âᵀ r̂(x_prev)``;
* right projection ``Q v = v − W (WᵀNW)⁻¹ (NW)ᵀ v`` on every product
  (two k×n GEMVs, no extra A/Aᵀ product);
* the window ``(v_j, N̂ v_j)`` with ``N̂ v_j = α_j g_j + β_{j+1} g_{j+1}``
  comes free from the recurrence and feeds the SAME harmonic-Ritz
  extraction def-CG uses (``self_gram`` and ``recombine_blocks``).

The loop is the port's masked-step harness (:mod:`repro_torch.core.engine`):
every scalar lives on the device, the host reads the convergence test once
per ``CHUNK`` steps, and a frozen step's two products are computed and
discarded (the reference hides them behind ``cond``).  Everything of an
iteration after ``‖w‖²`` — α⁺ and ``v⁺``, both Givens rotations, the three
vector recurrences, the exact-termination latch, the status, the trace
slot, j, the next active flag and the frozen-step mask of ``x, h̄, h, v``
— is ONE ``lsmr_update`` launch (:func:`lsmr_tail`, shared with the
sharded engine), the stall detector (``stagnation_window > 0``) included.

The same solver runs B tenants' systems at once (``lanes=True``, the
least-squares half of ``solve_batch``): every vector gains a leading lane
axis, the operator is a batched one
(:class:`repro_torch.core.operators.LaneDenseOperator` or
:func:`~repro_torch.core.operators.lane_operator`: ``(B, n) → (B, m)`` and
back), the per-lane reductions run through
:func:`repro_torch.core.operators.over_lanes` (lane by lane on the CPU, so a
lane is bit for bit its one-system solve there) and the tail is ONE
lane-axis launch of ``lsmr_step`` for all lanes.

Matvec accounting counts ``A`` and ``Aᵀ`` applications each as 1: the
initial ``Âᵀu₁`` costs 1 (+1 ``A`` with a warm start), every iteration 2.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.core import engine
from repro_torch.core import operators as ops_mod
from repro_torch.core import pytree as pt
from repro_torch.core.recycle import SequenceResult, _lane_mask, _stack_infos, system_at
from repro_torch.core.solvers import (
    DEFAULT_WAW_JITTER,
    CGResult,
    RecycleData,
    SolveInfo,
    _basis_dot,
    _basis_dot_batched,
    _chol_solve,
    _combine,
    _dot,
    factor_waw_gram,
)
from repro_torch.core.strategies import extract_next_basis_core
from repro_torch.kernels import ops as kops
from repro_torch.kernels.cg_fused import safe as _safe
from repro_torch.kernels.cg_fused import still_active


def lsmr_initial_state(x, u_m, u_n, v, g, alpha1, normar0, threshold, maxiter, trace,
                       window=0):
    """The LSMR loop's state before its first step:
    ``(js, s, active, x, u_m, u_n, v, g, h, h̄, trace)`` with ``js = [j,
    fail]`` and ``s`` the packed scalars of ``kernels.cg_fused.LSMR_SLOTS``
    (ᾱ = α₁, ζ̄ = ‖Âᵀr̂₀‖, ρ = ρ̄ = c̄ = 1, s̄ = 0).  With the stall detector
    armed (``window > 0``) ``s`` carries its best residual ``‖Âᵀr̂₀‖`` in
    one more slot and ``js`` its stall count.  On a lane axis (``normar0``
    ``(B,)``) ``s`` is ``(B, 7|8)``, ``js`` ``(B, 2|3)`` and ``active``
    ``(B,)``."""
    one = torch.ones_like(normar0)
    stag = engine.stagnation_init(normar0, window)
    s = torch.stack([alpha1, normar0, alpha1, one, one, one, torch.zeros_like(one)]
                    + ([stag[0]] if stag else []), dim=-1)
    js = torch.stack([torch.zeros(normar0.shape, dtype=torch.int32, device=v.device),
                      engine.initial_fail(normar0)] + ([stag[1]] if stag else []), dim=-1)
    active = still_active(js[..., 0], torch.abs(normar0), js[..., 1], threshold, maxiter)
    return (js, s, active, x, u_m, u_n, v, g, v, torch.zeros_like(v), trace)


def lsmr_tail(state, active, u_m_new, u_n_new, g_new, w_vec, wsq, beta_new, threshold,
              diverged_at, maxiter, window=0):
    """Everything of an LSMR step after its last reduction (``wsq = ‖w‖²``):
    one ``lsmr_step`` launch on the card, then the frozen-step selects of
    ``u_m``, ``u_n`` and ``g``.  The unsharded and the sharded loops both
    end their step here (a lane axis's ``(B, n)`` state too: one lane-axis
    launch for every lane).  Returns the next state."""
    js, s, _, x, u_m, u_n, v, g, h, hbar, trace = state
    x, hbar, h, v, s, js, active_next = kops.lsmr_step(
        x, hbar, h, v, w_vec, wsq, beta_new, s, js, active, threshold, diverged_at, maxiter,
        trace, window=window,
    )
    mask = active[..., None] if active.ndim else active

    def sel(new, cur):
        return torch.where(mask, new, cur)

    return (js, s, active_next, x, sel(u_m_new, u_m),
            None if u_n is None else sel(u_n_new, u_n), v, sel(g_new, g), h, hbar, trace)


def domain_size(A, x0: Optional[torch.Tensor] = None) -> int:
    """``n`` of ``A``'s domain, from ``x0`` or from what the operator
    knows (``domain_size`` of a dense matrix, a GGN or Gauss-Newton
    operator) — never from an extra product."""
    if x0 is not None:
        return x0.shape[0]
    n = getattr(A, "domain_size", None)
    if n is None:
        raise ValueError(
            "the domain size of this operator is unknown: pass x0 (or a "
            "recycle state), or give the operator a domain_size"
        )
    return n


def flat_lsq_problem(A, b, x0=None):
    """A rectangular problem over pytrees as flat coordinates:
    ``(op, b_flat, x0_flat, unravel_x)``.  ``op`` maps flat domain vectors
    to flat range vectors and back; the domain's structure comes from
    ``x0`` or, at no extra product, from the first adjoint product ``op``
    computes, and ``unravel_x()`` returns its inverse once known."""
    b_flat, unravel_b = pt.ravel_vector(b)
    dom = {}
    x0_flat = None
    if x0 is not None:
        x0_flat, dom["unravel"] = pt.ravel_vector(x0)
    At = ops_mod.adjoint_matvec(A)

    def rmv(u):
        g = At(unravel_b(u))
        if "unravel" not in dom:
            _, dom["unravel"] = pt.ravel_vector(g)
        return pt.ravel(g)

    def mv(v):
        return pt.ravel(A(dom["unravel"](v)))

    op = ops_mod.LinearOperator(mv, rmatvec=rmv)
    return op, b_flat, x0_flat, lambda: dom["unravel"]


def lsmr(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    W: Optional[torch.Tensor] = None,
    NW: Optional[torch.Tensor] = None,
    *,
    damp: float = 0.0,
    ell: int = 0,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    record_residuals: bool = False,
    waw_jitter: float = DEFAULT_WAW_JITTER,
    stagnation_window: int = 0,
    lanes: bool = False,
) -> CGResult:
    """(Deflated) LSMR for ``min ‖Ax − b‖² + damp·‖x‖²`` on flat tensors.

    ``A`` is a rectangular operator whose adjoint resolves through
    :func:`repro_torch.core.operators.adjoint_matvec`; ``b`` is ``(m,)``
    and ``x0`` (the warm start, handled exactly) ``(n,)``.  ``W``/``NW``
    are an optional flat ``(k, n)`` deflation basis and its products
    ``(AᵀA + damp·I)·W`` (the ``deflsmr`` method; zero rows deflate as
    exact no-ops).  ``ell`` leading ``(v, N̂v)`` pairs are recorded for the
    extraction at no extra product.  Convergence is declared on the
    normal residual ``‖Âᵀr̂‖ ≤ max(tol·‖Âᵀr̂₀‖, atol)``, reported as
    ``info.residual_norm``.  Returns a :class:`CGResult` whose ``recycle``
    holds the flat ``(v, N̂v)`` window.  ``stagnation_window > 0`` arms
    the stall detector on ``‖Âᵀr̂‖`` (inside the tail's launch).

    ``b`` (range) and ``x0`` (domain) may be pytrees, with ``A`` and its
    adjoint mapping pytrees: the solve runs on flat coordinates and ``x``
    comes back in the domain's structure, read off ``x0`` or off the first
    adjoint product (which the iteration computes anyway).

    ``lanes``: B independent systems at once (flat tensors only): ``b``
    ``(B, m)``, ``x0`` ``(B, n)``, ``W``/``NW`` ``(B, k, n)``, ``A`` a batched
    operator (``(B, n) → (B, m)``, its ``rmatvec`` back).  Each lane has
    its own threshold, flags, counts, trace and window slot; the host reads
    "any lane active" once per chunk.  The info fields and the window gain
    the leading B.
    """
    if not all(t is None or pt.is_flat(t) for t in (b, x0, W, NW)):
        op, b_flat, x0_flat, unravel_x = flat_lsq_problem(A, b, x0)
        res = lsmr(
            op, b_flat, x0_flat, None if W is None else pt.ravel_basis(W),
            None if NW is None else pt.ravel_basis(NW), damp=damp, ell=ell, tol=tol,
            atol=atol, maxiter=maxiter, record_residuals=record_residuals,
            waw_jitter=waw_jitter, stagnation_window=stagnation_window,
        )
        return res._replace(x=unravel_x()(res.x))
    if damp < 0.0:
        raise ValueError(f"damp must be >= 0, got {damp}")
    has_shift = damp > 0.0
    sqrt_damp = float(damp) ** 0.5
    At = ops_mod.adjoint_matvec(A)
    dtype, device = b.dtype, b.device
    lead = b.shape[:-1]

    def col(t):  # a per-system scalar scaling that system's vector
        return t[..., None] if lanes else t

    deflating = W is not None
    proj = None
    if deflating:
        k = W.shape[-2]
        nw = NW if NW is not None else torch.zeros_like(W)
        chol = factor_waw_gram(W, nw, waw_jitter, lanes)
        eye = torch.eye(k, dtype=W.dtype, device=device)
        winv = _chol_solve(chol, eye.expand(lead + (k, k)) if lanes else eye, lanes)
        proj = (W, nw, winv)
    consts = dict(A=A, proj=proj, lanes=lanes, sqrt_damp=sqrt_damp if has_shift else None)

    # -- initial augmented residual r̂₀ = [b − A x₀; −√λ x₀] ----------------
    init_mv = 1  # the Âᵀu₁ below
    if x0 is not None:
        r_m = b - A(x0)
        init_mv += 1
        beta_sq = _dot(r_m, r_m, lanes)
        if has_shift:
            u_n0 = -sqrt_damp * x0
            beta_sq = beta_sq + _dot(u_n0, u_n0, lanes)
    else:
        r_m = b
        beta_sq = _dot(r_m, r_m, lanes)
    beta1 = torch.sqrt(beta_sq)
    u_m0 = r_m / col(_safe(beta1))
    g0 = At(u_m0)
    x_flat = torch.zeros_like(g0) if x0 is None else x0
    if has_shift:
        # A cold start's bottom block is zero: its size is the domain's,
        # which the first adjoint product reveals.
        u_n0 = torch.zeros_like(g0) if x0 is None else u_n0 / col(_safe(beta1))
        g0 = g0 + sqrt_damp * u_n0
    else:
        u_n0 = None
    g0 = _qt_apply(consts, g0)
    alpha1 = torch.sqrt(_dot(g0, g0, lanes))
    v0 = g0 / col(_safe(alpha1))
    n = v0.shape[-1]

    normar0 = alpha1 * beta1
    threshold = torch.clamp(tol * normar0, min=atol)
    diverged_at = 1e8 * normar0
    trace0 = engine.trace_init(normar0, maxiter, record_residuals)

    consts.update(threshold=threshold, diverged_at=diverged_at, maxiter=maxiter,
                  window=stagnation_window,
                  lane_rows=torch.arange(lead[0], device=device) if lanes else None)
    # The window's buffers ride in the state (the steps write them in
    # place); row ``ell`` is the spare row frozen recording steps write to,
    # so rows past ``stored`` stay zero (the reference zero-masks them).
    bufs = None
    if ell > 0:
        bufs = (torch.zeros(lead + (ell + 1, n), dtype=dtype, device=device),
                torch.zeros(lead + (ell + 1, n), dtype=dtype, device=device))
    state = lsmr_initial_state(x_flat, u_m0, u_n0, v0, g0, alpha1, normar0, threshold,
                               maxiter, trace0, stagnation_window)
    state, bufs = engine.run_recording_loop(_lsmr_step, _lsmr_active, (state, bufs), ell=ell,
                                            consts=consts)
    js, s, _, x = state[:4]
    j, fail, zetabar, trace = js[..., 0], js[..., 1], s[..., 1], state[10]
    normar = torch.abs(zetabar)
    if deflating:
        # The Krylov correction lives in the Q-subspace: one exit-time
        # projection of the accumulated update.
        x = x_flat + _q_apply(consts, x - x_flat)

    converged = normar <= threshold
    info = SolveInfo(
        iterations=j,
        converged=converged,
        residual_norm=normar,
        matvecs=init_mv + 2 * j,
        residual_norms=None if trace is None else trace[..., : maxiter + 1],
        breakdown=fail > 0,
        status=engine.exit_status(converged, fail),
    )
    recycle = None
    if ell > 0:
        recycle = RecycleData(P=bufs[0][..., :ell, :], AP=bufs[1][..., :ell, :],
                              stored=torch.clamp(j, max=ell))
    return CGResult(x=x, info=info, recycle=recycle)


def _small(c, vec):
    """``(WᵀNW)⁻¹ vec`` of the deflation ``c["proj"] = (W, NW, (WᵀNW)⁻¹)``."""
    winv = c["proj"][2]
    return ops_mod.over_lanes(torch.matmul, _basis_dot_batched, c["lanes"], winv, vec)


def _q_apply(c, vv):
    """The right projection: ``vv`` N-orthogonalized against ``W`` (``vv``
    itself without a deflation basis)."""
    if c["proj"] is None:
        return vv
    W, nw, _ = c["proj"]
    return vv - _combine(W, _small(c, _basis_dot(nw, vv, c["lanes"])), c["lanes"])


def _qt_apply(c, gg):
    """The projection's transpose, on adjoint products."""
    if c["proj"] is None:
        return gg
    W, nw, _ = c["proj"]
    return gg - _combine(nw, _small(c, _basis_dot(W, gg, c["lanes"])), c["lanes"])


def _record(c, buf, vec, active, row):
    """``vec`` into row ``active ? row : ell`` of a window buffer, in place."""
    slot = torch.where(active, row, buf.shape[-2] - 1).to(torch.int64)
    if c["lanes"]:
        buf.index_put_((c["lane_rows"], slot), vec)
    else:
        buf.index_copy_(0, slot.reshape(1), vec[None])


def _lsmr_active(state):
    """The LSMR loop's carried active flag."""
    return state[0][2]


def _lsmr_step(c, state, active, row):
    """One masked LSMR iteration of :func:`lsmr` (``c``: its consts; the
    state the :func:`lsmr_tail` state and the window's buffers);
    ``active=False`` freezes the state."""
    core, bufs = state
    A, lanes, sqrt_damp = c["A"], c["lanes"], c["sqrt_damp"]

    def col(t):  # a per-system scalar scaling that system's vector
        return t[..., None] if lanes else t

    u_m, u_n, v, g = core[4:8]
    alpha = col(core[1][..., 0])

    # -- bidiagonalization: β u⁺ = Â(Qv) − α u -------------------------------
    qv = _q_apply(c, v)
    u_m_new = A(qv) - alpha * u_m
    beta_sq_ = _dot(u_m_new, u_m_new, lanes)
    if sqrt_damp is not None:
        u_n_new = sqrt_damp * qv - alpha * u_n
        beta_sq_ = beta_sq_ + _dot(u_n_new, u_n_new, lanes)
    beta_new = torch.sqrt(beta_sq_)
    sb = col(_safe(beta_new))
    u_m_new = u_m_new / sb
    if sqrt_damp is not None:
        u_n_new = u_n_new / sb

    # -- α v⁺ = Qᵀ(Âᵀu⁺) − β v (α⁺ and v⁺ in the tail) ------------------------
    g_new = ops_mod.adjoint_matvec(A)(u_m_new)
    if sqrt_damp is not None:
        g_new = g_new + sqrt_damp * u_n_new
    g_new = _qt_apply(c, g_new)
    w_vec = g_new - col(beta_new) * v

    if row is not None:
        # The window row, free from the recurrence:
        #   N̂ v_j = α_j·B̂ᵀu_j + β_{j+1}·B̂ᵀu_{j+1}.
        _record(c, bufs[0], v, active, row)
        _record(c, bufs[1], alpha * g + col(beta_new) * g_new, active, row)

    core = lsmr_tail(core, active, u_m_new, u_n_new if sqrt_damp is not None else None, g_new,
                     w_vec, _dot(w_vec, w_vec, lanes), beta_new, c["threshold"],
                     c["diverged_at"], c["maxiter"], c["window"])
    return core, bufs


# ---------------------------------------------------------------------------
# Recycled least-squares sequences
# ---------------------------------------------------------------------------


def _normal_basis_flat(A, w: torch.Tensor, damp: float) -> torch.Tensor:
    """``(AᵀA + damp·I) @ W`` for a flat ``(k, n)`` basis (or each tenant's
    on a lane axis, ``(B, k, n)`` and ``A`` batched): one multi-RHS forward
    pass and one adjoint pass (2k accounted matvecs)."""
    aw = ops_mod.apply_to_basis(A, w)
    adjoint = A.T if hasattr(A, "T") else ops_mod.adjoint_matvec(A)
    nw = ops_mod.apply_to_basis(adjoint, aw)
    if damp > 0.0:
        nw = nw + damp * w
    return nw


def _one_recycled_lsmr(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor],
    w: torch.Tensor,
    nw_carry: torch.Tensor,
    *,
    k: int,
    ell: int,
    damp: float,
    tol: float,
    atol: float,
    maxiter: int,
    select: str,
    waw_jitter: float,
    refresh_aw: str,
    record_residuals: bool = False,
    stagnation_window: int = 0,
    lanes: bool = False,
):
    """ONE system of the recycled LSMR step, on flat state — shared by
    :func:`repro_torch.core.solve`, :func:`solve_sequence_lsmr` and, with
    ``lanes`` (``b`` ``(B, m)``, state leaves with a leading B, ``A``
    batched), ``solve_batch``.

    1. ``refresh_aw="exact"`` re-derives ``NW = (AᵀA + λI)W`` under this
       system's operator (2k matvecs, charged); ``"stale"`` reuses the
       carried products;
    2. deflated warm start ``x₀' = x_prev + W (WᵀNW)⁻¹ Wᵀ s₀`` (2 matvecs;
       an exact no-op on a cold basis);
    3. the deflated solve (:func:`lsmr`);
    4. extraction of the next ``(W, NW)`` from the ``(v, N̂v)`` window.

    A broken or non-finite outcome retires the basis (zeroed carry: the
    sequence re-bootstraps cold) and falls back to the finite warm start.
    Returns ``(x, info, w_next, nw_next, theta, rung)``; ``theta`` is None
    when ``ell == 0`` and ``rung`` is always 0 (LSMR has no ladder).  On a
    lane axis each lane retires its own basis, and the extraction (K4 and
    K5) runs once a lane.
    """
    refresh_charge = 0
    if refresh_aw == "exact":
        nw_used = _normal_basis_flat(A, w, damp)
        refresh_charge = 2 * k
    else:
        nw_used = nw_carry

    # Deflated warm start in x-space (s₀ = Aᵀ(b − A x_prev) − λ x_prev).
    x_prev = (torch.zeros(w.shape[:-2] + w.shape[-1:], dtype=b.dtype, device=b.device)
              if x0 is None else x0)
    s0 = ops_mod.adjoint_matvec(A)(b - A(x_prev))
    if damp > 0.0:
        s0 = s0 - damp * x_prev
    chol = factor_waw_gram(w, nw_used, waw_jitter, lanes)
    x0p = x_prev + _combine(w, _chol_solve(chol, _basis_dot(w, s0, lanes), lanes), lanes)

    result = lsmr(
        A, b, x0p, W=w, NW=nw_used, damp=damp, ell=ell, tol=tol, atol=atol,
        maxiter=maxiter, record_residuals=record_residuals, waw_jitter=waw_jitter,
        stagnation_window=stagnation_window, lanes=lanes,
    )
    info = result.info._replace(matvecs=result.info.matvecs + refresh_charge + 2)
    if ell > 0:
        rec = result.recycle
        if lanes:  # K4 and K5 once a lane
            outs = [extract_next_basis_core(w[i], nw_used[i], rec.P[i], rec.AP[i],
                                            rec.stored[i], k, select=select)
                    for i in range(w.shape[0])]
            w2, nw2, theta = (torch.stack([o[q] for o in outs]) for q in range(3))
        else:
            w2, nw2, theta, _ = extract_next_basis_core(
                w, nw_used, rec.P, rec.AP, rec.stored, k, select=select
            )
    else:
        w2, nw2, theta = w, nw_used, None

    # Terminal retirement: never hand a poisoned basis (or non-finite
    # coordinates) to the next system (each lane its own).
    x_safe = torch.where(torch.isfinite(x_prev), x_prev, 0.0)
    x = torch.where(torch.all(torch.isfinite(result.x), dim=-1, keepdim=True), result.x, x_safe)
    retire = (info.breakdown
              | ~torch.all(torch.isfinite(w2).flatten(-2), dim=-1)
              | ~torch.all(torch.isfinite(nw2).flatten(-2), dim=-1))
    w2 = torch.where(_lane_mask(retire, w2), 0.0, w2)
    nw2 = torch.where(_lane_mask(retire, nw2), 0.0, nw2)
    if theta is not None:
        theta = torch.where(_lane_mask(retire, theta), 0.0, theta)
    rung = torch.zeros(b.shape[:-1], dtype=torch.int32, device=b.device)
    return x, info, w2, nw2, theta, rung


def solve_sequence_lsmr(
    systems: Any,
    b_seq: Any,
    W0: Optional[torch.Tensor] = None,
    NW0: Optional[torch.Tensor] = None,
    *,
    k: int,
    ell: int,
    damp: float = 0.0,
    make_operator: Optional[Callable[[Any], Any]] = None,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    select: str = "largest",
    waw_jitter: float = DEFAULT_WAW_JITTER,
    refresh_aw: str = "exact",
    carry_x: bool = False,
    stagnation_window: int = 0,
    x_prev0: Optional[torch.Tensor] = None,
) -> SequenceResult:
    """Recycled LSMR across a sequence of least-squares problems.

    ``systems[i]`` (a stacked tensor or a list) mapped through
    ``make_operator`` is the i-th operator and ``b_seq[i]`` its ``(m,)``
    right-hand side.  The flat ``(W, NW)`` basis (and, with ``carry_x``,
    the solution as the next warm start) is carried from system to
    system (``x_prev0`` the first warm start; zeros when None).  Returns
    a :class:`SequenceResult` whose ``AW`` slot holds the normal-operator
    products ``NW``.
    """
    if refresh_aw not in ("exact", "stale"):
        raise ValueError(f"unknown refresh_aw={refresh_aw!r}")
    make_op = make_operator if make_operator is not None else (lambda s: s)
    n = W0.shape[1] if W0 is not None else domain_size(make_op(system_at(systems, 0)))
    dtype, device = b_seq[0].dtype, b_seq[0].device

    w = torch.zeros((k, n), dtype=dtype, device=device) if W0 is None else W0.to(dtype)
    nw = (
        torch.zeros((k, n), dtype=dtype, device=device)
        if (NW0 is None or W0 is None) else NW0.to(dtype)
    )
    x_prev = (torch.zeros((n,), dtype=dtype, device=device) if x_prev0 is None
              else x_prev0.to(dtype))

    xs, infos, thetas, rungs = [], [], [], []
    for i in range(len(b_seq)):
        x, info, w, nw, theta, rung = _one_recycled_lsmr(
            make_op(system_at(systems, i)), b_seq[i], x_prev if carry_x else None, w, nw,
            k=k, ell=ell, damp=damp, tol=tol, atol=atol, maxiter=maxiter,
            select=select, waw_jitter=waw_jitter, refresh_aw=refresh_aw,
            stagnation_window=stagnation_window,
        )
        x_prev = x
        xs.append(x)
        infos.append(info)
        thetas.append(theta)
        rungs.append(rung)
    return SequenceResult(
        x=torch.stack(xs),
        info=_stack_infos(infos),
        theta=None if thetas[0] is None else torch.stack(thetas),
        W=w,
        AW=nw,
        drift=torch.zeros((), dtype=dtype, device=device),
        rung=torch.stack(rungs),
    )


# ---------------------------------------------------------------------------
# Compiled entry points (the reference's jitted doors)
# ---------------------------------------------------------------------------

lsmr_jit = engine.compiled_door(lsmr, """:func:`lsmr` as one compiled program
(:mod:`repro_torch.core.engine`): on the card the loop's recording steps
and its chunks of steps, K7's step arm inside them, are captured once a
shape and replayed.  Same arguments and results as :func:`lsmr`, bit for
bit.""")

solve_sequence_lsmr_jit = engine.compiled_door(
    solve_sequence_lsmr, """:func:`solve_sequence_lsmr` with every system's
LSMR loop a compiled program: the systems of one shape share its graphs.
Same arguments and results, bit for bit.""")
