"""CG and deflated CG (the paper's Algorithm 1) on flat tensors.

The counterpart of ``repro.core.solvers``: the same iteration, the same
state, the same accounting, on the masked-step harness of
:mod:`repro_torch.core.engine`.  An iteration past its product is ``pᵀAp``,
ONE ``fused_cg_step`` launch (breakdown test, α, the update, β, μ, the
residual norm, status, trace, j and the next active flag;
:mod:`repro_torch.kernels.ops`) and ONE ``fused_direction_step`` launch
(the direction update with the ``p`` select and the recording slot); with
a preconditioner, ``z = M⁻¹r`` and ONE ``fused_rz_step`` launch come
between, which forms ``rᵀz``, β, μ and the recorded α / β on the card.
The first ``ell`` search directions and their products are recorded by
the direction step straight into ``(ell + 1, n)`` buffers: row ``ell`` is
the spare row frozen steps write to, so rows past ``stored`` stay zero as
the reference's masked scan outputs do.

Deflation (Alg. 1 lines 3 and 11):

    x0  = x_{-1} + W (WᵀAW)⁻¹ Wᵀ r_{-1}          # Wᵀ r0 = 0
    p0  = r0 − Wᵀμ0,        WᵀAW μ0 = (AW)ᵀ r0
    p_j = β p_{j-1} + r_j − Wᵀμ_j,  WᵀAW μ_j = (AW)ᵀ r_j
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import engine
from repro_torch.core import operators as ops_mod
from repro_torch.core import pytree as pt
from repro_torch.core.engine import SolveInfo
from repro_torch.kernels import ops as kops
from repro_torch.kernels.cg_fused import still_active

# The one waw_jitter default (the reference's value; see repro.core.solvers).
DEFAULT_WAW_JITTER = 1e-12

# Noise floor of drift-guard thresholds, in units of the working eps.
DRIFT_NOISE_FLOOR_EPS = 500.0


class RecycleData(NamedTuple):
    """Recorded Krylov quantities — the solver→strategy window handoff."""

    P: torch.Tensor  # (ell, n) search directions
    AP: torch.Tensor  # (ell, n) their A-products
    stored: torch.Tensor  # valid rows (may be < ell on early convergence)
    alpha: Optional[torch.Tensor] = None  # (ell,) step sizes along P[j]
    beta: Optional[torch.Tensor] = None  # (ell,) direction coefficients
    aw_used: Optional[torch.Tensor] = None  # AW after an in-solve refresh


class CGResult(NamedTuple):
    x: torch.Tensor
    info: SolveInfo
    recycle: Optional[RecycleData] = None


def _info(j, matvecs, rnorm, threshold, trace, fail, maxiter, guard_fired=False):
    converged = rnorm <= threshold
    return SolveInfo(
        iterations=j,
        converged=converged,
        residual_norm=rnorm,
        matvecs=matvecs + j,
        residual_norms=None if trace is None else trace[: maxiter + 1],
        breakdown=fail > 0,
        status=engine.exit_status(converged, fail),
        guard_fired=torch.tensor(guard_fired, device=rnorm.device),
    )


# ---------------------------------------------------------------------------
# Conjugate gradients (the paper's CG baseline)
# ---------------------------------------------------------------------------


def cg(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-5,
    atol: float = 0.0,
    maxiter: int = 1000,
    M=None,
    record_residuals: bool = False,
    stagnation_window: int = 0,
) -> CGResult:
    """(Preconditioned) conjugate gradients for SPD ``A``.

    ``M`` is an SPD preconditioner apply ``r ↦ M⁻¹ r``; ``None`` gives
    plain CG, the paper's baseline.  The loop carries ``rᵀz``: without a
    preconditioner that is the ``‖r‖²`` the fused update pass emits; with
    one, ``fused_rz_step`` forms it and β after ``z = M(r)``.
    ``stagnation_window > 0`` arms the stall detector inside the update's
    launch: STAGNATED once the best residual has not improved by 1 % for
    that many iterations (0 adds no state and no work).
    """
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    z = r if M is None else M(r)
    p = z
    rz = pt.tree_dot(r, z)
    rnorm0 = pt.tree_norm(r)
    threshold, _ = engine.tolerances(b, tol, atol)
    trace0 = engine.trace_init(rnorm0, maxiter, record_residuals)
    diverged_at = 1e8 * torch.maximum(rnorm0, pt.tree_norm(b))

    def step(state, active, row):
        del row  # CG records no window
        js, x, r, p, rz, rnorm, _, trace, best = state
        ap = A(p)
        d = pt.tree_dot(p, ap)
        x, r, ap, so, js, flags = kops.fused_cg_step(
            x, r, p, ap, d, rz, rnorm, js, active, threshold, diverged_at, maxiter,
            recurrence=M is None, trace=trace, window=stagnation_window, best=best,
        )
        if M is None:
            z, rz_new, beta = r, so[0], so[3]
        else:
            z = M(r)
            sz = kops.fused_rz_step(r, z, rz)
            rz_new, beta = sz[0], sz[1]
        p = kops.fused_direction_step(z, p, beta, flags[1])
        return (js, x, r, p, rz_new, so[1], flags[0], trace, so[-1] if stagnation_window else None)

    js0, active0, best0 = _initial_flags(rnorm0, threshold, maxiter,
                                          stagnation_window)
    state = (js0, x, r, p, rz, rnorm0, active0, trace0, best0)
    state = engine.run_recording_loop(step, lambda st: st[6], state, ell=0)
    js, x, _, _, _, rnorm, _, trace, _ = state
    j, fail = js[0], js[1]
    return CGResult(x=x, info=_info(j, 1, rnorm, threshold, trace, fail, maxiter))


# ---------------------------------------------------------------------------
# Deflated conjugate gradients — paper Algorithm 1
# ---------------------------------------------------------------------------


def _initial_flags(rnorm0, threshold, maxiter: int, window: int):
    """``(js, active, best)`` before a cg / def-CG loop's first step:
    ``js = [j, fail]``, with the stall count appended and ``best = ‖r₀‖``
    when the detector is armed (``best`` None otherwise)."""
    js = [torch.zeros((), dtype=torch.int32, device=rnorm0.device),
          engine.initial_fail(rnorm0)]
    stag = engine.stagnation_init(rnorm0, window)
    js = torch.stack(js + ([stag[1]] if stag else []))
    active = still_active(js[0], rnorm0, js[1], threshold, maxiter)
    return js, active, stag[0] if stag else None


def _chol_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    if rhs.ndim == 1:
        return torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    return torch.cholesky_solve(rhs, chol)


def factor_waw_gram(W: torch.Tensor, AW: torch.Tensor, jitter: float) -> torch.Tensor:
    """Lower Cholesky factor of the symmetrized ``WᵀAW`` (``(k, k)``).

    Relative diagonal jitter, plus unconditional regularization of
    exactly-zero columns (clamped extraction slots, cold states): ``Wᵀr = 0``
    there, so any positive diagonal gives the same deflation (``c_i = μ_i
    = 0``).  LSMR factors ``WᵀNW`` with the same policy.
    """
    k = W.shape[0]
    waw = pt.gram(W, AW)
    waw = 0.5 * (waw + waw.T)
    dj = torch.diagonal(waw)
    tr = torch.sum(dj)
    if jitter:
        scale = torch.where(tr > 0, tr / k, 1.0)
        waw = waw + jitter * scale * torch.eye(k, dtype=waw.dtype, device=waw.device)
    waw = waw + torch.diag(torch.where(dj == 0.0, torch.clamp(tr / k, min=1.0), 0.0))
    return torch.linalg.cholesky_ex(waw)[0]


def deflated_initial_guess(x_prev, r_prev, W, AW, waw_chol):
    """Line 3 of Alg. 1: ``x0 = x_{-1} + W (WᵀAW)⁻¹ Wᵀ r_{-1}``, with
    ``r0 = r_{-1} − AWᵀc`` updated through ``AW`` (no extra matvec)."""
    c = _chol_solve(waw_chol, pt.basis_dot(W, r_prev))
    x0 = x_prev + pt.basis_combine(W, c)
    r0 = r_prev - pt.basis_combine(AW, c)
    return x0, r0


def defcg(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    W: Optional[torch.Tensor] = None,
    AW: Optional[torch.Tensor] = None,
    *,
    ell: int = 0,
    tol: float = 1e-5,
    atol: float = 0.0,
    maxiter: int = 1000,
    record_residuals: bool = False,
    waw_jitter: float = DEFAULT_WAW_JITTER,
    exact_aw: bool = True,
    M=None,
    stale_guard: Optional[float] = None,
    stagnation_window: int = 0,
) -> CGResult:
    """Deflated CG — ``def-CG(k, ell)`` with k the rows of ``W``.

    ``W``/``AW`` are flat ``(k, n)`` tensors; ``W=None`` runs plain CG that
    still records the first ``ell`` directions (a cold sequence start).
    ``AW`` is computed here (k matvecs, charged) when not given.
    ``exact_aw=False`` re-derives the initial residual with one true
    matvec, and ``stale_guard`` then arms the in-solve drift guard, whose
    refresh decision is one host read of the setup.  The ``recycle``
    field of the result holds the flat ``(ell, n)`` window.

    ``M`` (an SPD apply ``r ↦ M⁻¹ r``) runs the split-preconditioned
    def-CG of the reference: the loop carries ``rᵀz`` (``z = M⁻¹r``) and
    deflates in the preconditioned inner product, ``μ = (WᵀAW)⁻¹(AW)ᵀz``.
    The update pass then emits ``‖r‖²`` only, ``z = M(r)`` follows, and
    one ``fused_rz_step`` launch forms ``rᵀz``, ``(AW)ᵀz``, β, μ and the
    recorded α / β on the card; convergence is still tested on the true
    residual ``‖r‖``.  ``stagnation_window`` arms the stall detector, as
    in :func:`cg`.
    """
    threshold, _ = engine.tolerances(b, tol, atol)
    matvecs = 0
    guard_fired = False
    x = torch.zeros_like(b) if x0 is None else x0
    n = b.shape[0]
    dtype, device = b.dtype, b.device

    deflating = W is not None
    aw = waw_inv = None
    if deflating:
        k = W.shape[0]
        if AW is None:
            aw = ops_mod.apply_to_basis(A, W)
            matvecs += k
        else:
            aw = AW

        def post_guess(aw_f, chol, z):
            # Deflation in the preconditioned inner product: μ from (AW)ᵀz.
            mu0 = _chol_solve(chol, pt.basis_dot(aw_f, z))
            p0 = z - pt.basis_combine(W, mu0)
            winv = _chol_solve(chol, torch.eye(k, dtype=aw_f.dtype, device=device))
            return p0, winv.contiguous()  # row-major, as the step kernel reads it

        chol = factor_waw_gram(W, aw, waw_jitter)
        x_in = x
        r_init = b - A(x_in)
        matvecs += 1
        x, r = deflated_initial_guess(x_in, r_init, W, aw, chol)
        if not exact_aw:
            r_short = r
            r = b - A(x)
            matvecs += 1
            if stale_guard is not None:
                # ‖r_true − r_short‖ = ‖(A·W − AW)c‖: the staleness of AW
                # along the deflated component, already paid for.
                drift_obs = pt.tree_norm(r - r_short) / torch.clamp(
                    pt.tree_norm(r_init), min=torch.finfo(dtype).tiny
                )
                guard_eff = max(
                    stale_guard, DRIFT_NOISE_FLOOR_EPS * torch.finfo(dtype).eps
                )
                if bool(drift_obs > guard_eff):
                    aw = ops_mod.apply_to_basis(A, W)
                    chol = factor_waw_gram(W, aw, waw_jitter)
                    x, r = deflated_initial_guess(x_in, r_init, W, aw, chol)
                    matvecs += k
                    guard_fired = True
    else:
        r = b - A(x)
        matvecs += 1
    z = r if M is None else M(r)
    if deflating:
        p, waw_inv = post_guess(aw, chol, z)
    else:
        p = z

    rnorm0 = pt.tree_norm(r)
    # The carried recurrence scalar: rᵀz (‖r‖² without a preconditioner).
    rs0 = pt.tree_dot(r, z)
    trace0 = engine.trace_init(rnorm0, maxiter, record_residuals)
    diverged_at = 1e8 * torch.maximum(rnorm0, pt.tree_norm(b))

    if ell > 0:
        p_buf = torch.zeros((ell + 1, n), dtype=dtype, device=device)
        ap_buf = torch.zeros((ell + 1, n), dtype=dtype, device=device)
        a_rows = torch.zeros((ell + 1,), dtype=dtype, device=device)
        b_rows = torch.zeros((ell + 1,), dtype=dtype, device=device)

    def step(state, active, row):
        """One masked def-CG iteration; ``active=False`` freezes the state."""
        js, x, r, p, rs, rnorm, _, trace, best = state
        ap = A(p)
        d = pt.tree_dot(p, ap)
        rows = {} if row is None else dict(row=row, a_rows=a_rows, b_rows=b_rows)
        if M is None:
            # rᵀr IS the recurrence scalar: the deflation GEMV, β and μ
            # ride in the update's launch.
            x, r, ap, so, js, flags = kops.fused_cg_step(
                x, r, p, ap, d, rs, rnorm, js, active, threshold, diverged_at, maxiter,
                aw, waw_inv, trace=trace, window=stagnation_window, best=best, **rows,
            )
            zvec, rs_new, beta = r, so[0], so[3]
            mu = so[4:4 + k] if deflating else None
        else:
            # z = M⁻¹r exists only after the update: rᵀz, (AW)ᵀz, β, μ and
            # the recorded α / β come from K6's step arm, a second launch.
            x, r, ap, so, js, flags = kops.fused_cg_step(
                x, r, p, ap, d, rs, rnorm, js, active, threshold, diverged_at, maxiter,
                recurrence=False, trace=trace, window=stagnation_window, best=best,
            )
            zvec = M(r)
            sz = kops.fused_rz_step(r, zvec, rs, aw, waw_inv, alpha=so[2], active=active, **rows)
            rs_new, beta = sz[0], sz[1]
            mu = sz[2:] if deflating else None
        # Frozen steps record into the spare row ``ell``.  p is frozen on
        # breakdown too (flags[1] = active ∧ ¬bad): a poisoned basis can
        # make p_new non-finite through μ even with a sanitized A·p.
        rec = {} if row is None else dict(ap=ap, active=active, row=row, p_buf=p_buf,
                                          ap_buf=ap_buf)
        p = kops.fused_direction_step(zvec, p, beta, flags[1], W, mu, **rec)
        return (js, x, r, p, rs_new, so[1], flags[0], trace, so[-1] if stagnation_window else None)

    js0, active0, best0 = _initial_flags(rnorm0, threshold, maxiter,
                                          stagnation_window)
    state = (js0, x, r, p, rs0, rnorm0, active0, trace0, best0)
    state = engine.run_recording_loop(step, lambda st: st[6], state, ell=ell)
    js, x, _, _, _, rnorm, _, trace, _ = state
    j, fail = js[0], js[1]

    info = _info(j, matvecs, rnorm, threshold, trace, fail, maxiter, guard_fired)
    recycle = None
    if ell > 0:
        recycle = RecycleData(
            P=p_buf[:ell],
            AP=ap_buf[:ell],
            stored=torch.clamp(j, max=ell),
            alpha=a_rows[:ell],
            beta=b_rows[:ell],
            aw_used=(
                aw if (deflating and not exact_aw and stale_guard is not None)
                else None
            ),
        )
    return CGResult(x=x, info=info, recycle=recycle)


# ---------------------------------------------------------------------------
# Dense baseline (paper Table 1's Cholesky column)
# ---------------------------------------------------------------------------


def cholesky_solve(mat: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact SPD solve via Cholesky — the paper's cubic-cost baseline."""
    return _chol_solve(torch.linalg.cholesky(mat), b)
