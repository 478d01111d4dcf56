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

:func:`defcg_lanes` runs B independent systems at once on the lane axis
of the same three kernels (``(B, n)`` vectors, one launch a kernel a step
for all lanes).

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
        residual_norms=None if trace is None else trace[..., : maxiter + 1],
        breakdown=fail > 0,
        status=engine.exit_status(converged, fail),
        guard_fired=torch.as_tensor(guard_fired, device=rnorm.device),
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

    ``b`` and ``x0`` may be pytrees (nested dicts, lists, tuples of
    tensors; ``A`` and ``M`` then map pytrees to pytrees): the solve runs
    on their flat coordinates (:func:`repro_torch.core.pytree.ravel_vector`)
    and returns ``x`` in ``b``'s structure.
    """
    if not (pt.is_flat(b) and (x0 is None or pt.is_flat(x0))):
        b_flat, unravel = pt.ravel_vector(b)
        res = cg(
            pt.flat_operator(A, unravel), b_flat, None if x0 is None else pt.ravel(x0),
            tol=tol, atol=atol, maxiter=maxiter,
            M=None if M is None else pt.flat_operator(M, unravel),
            record_residuals=record_residuals, stagnation_window=stagnation_window,
        )
        return res._replace(x=unravel(res.x))
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    z = r if M is None else M(r)
    p = z
    rz = pt.tree_dot(r, z)
    rnorm0 = pt.tree_norm(r)
    threshold, _ = engine.tolerances(b, tol, atol)
    trace0 = engine.trace_init(rnorm0, maxiter, record_residuals)
    diverged_at = 1e8 * torch.maximum(rnorm0, pt.tree_norm(b))
    consts = dict(A=A, M=M, threshold=threshold, diverged_at=diverged_at, maxiter=maxiter,
                  window=stagnation_window)
    js0, active0, best0 = _initial_flags(rnorm0, threshold, maxiter,
                                          stagnation_window)
    state = (js0, x, r, p, rz, rnorm0, active0, trace0, best0)
    state = engine.run_recording_loop(_cg_step, _active, state, ell=0, consts=consts)
    js, x, _, _, _, rnorm, _, trace, _ = state
    j, fail = js[0], js[1]
    return CGResult(x=x, info=_info(j, 1, rnorm, threshold, trace, fail, maxiter))


def _active(state):
    """The cg / def-CG loop's carried active flag."""
    return state[6]


def _cg_step(c, state, active, row):
    """One masked CG iteration of :func:`cg` (``c``: its consts)."""
    del row  # CG records no window
    js, x, r, p, rz, rnorm, _, trace, best = state
    A, M, window = c["A"], c["M"], c["window"]
    ap = engine.gated_matvec(A, p, active)
    d = pt.tree_dot(p, ap)
    x, r, ap, so, js, flags = kops.fused_cg_step(
        x, r, p, ap, d, rz, rnorm, js, active, c["threshold"], c["diverged_at"], c["maxiter"],
        recurrence=M is None, trace=trace, window=window, best=best,
    )
    if M is None:
        z, rz_new, beta = r, so[0], so[3]
    else:
        z = M(r)
        sz = kops.fused_rz_step(r, z, rz)
        rz_new, beta = sz[0], sz[1]
    p = kops.fused_direction_step(z, p, beta, flags[1])
    return (js, x, r, p, rz_new, so[1], flags[0], trace, so[-1] if window else None)


# ---------------------------------------------------------------------------
# Deflated conjugate gradients — paper Algorithm 1
# ---------------------------------------------------------------------------


def _initial_flags(rnorm0, threshold, maxiter: int, window: int):
    """``(js, active, best)`` before a cg / def-CG loop's first step:
    ``js = [j, fail]``, with the stall count appended and ``best = ‖r₀‖``
    when the detector is armed (``best`` None otherwise).  On a lane axis
    (``rnorm0`` ``(B,)``) ``js`` is ``(B, 2|3)`` and the flags ``(B,)``."""
    js = [torch.zeros(rnorm0.shape, dtype=torch.int32, device=rnorm0.device),
          engine.initial_fail(rnorm0)]
    stag = engine.stagnation_init(rnorm0, window)
    js = torch.stack(js + ([stag[1]] if stag else []), dim=-1)
    active = still_active(js[..., 0], rnorm0, js[..., 1], threshold, maxiter)
    return js, active, stag[0] if stag else None


# ---------------------------------------------------------------------------
# The solve's small reductions, for one system or over a lane axis
# ---------------------------------------------------------------------------


def _dot(a, b, lanes=False):
    """``aᵀb``: 0-d, or ``(B,)`` for ``(B, n)`` stacks."""
    return ops_mod.over_lanes(pt.tree_dot, torch.linalg.vecdot, lanes, a, b)


def _norm(a, lanes=False):
    return torch.sqrt(_dot(a, a, lanes))


def _basis_dot(W, v, lanes=False):
    """``W v``: ``(k,)``, or ``(B, k)`` for ``(B, k, n)`` against ``(B, n)``."""
    return ops_mod.over_lanes(pt.basis_dot, _basis_dot_batched, lanes, W, v)


def _basis_dot_batched(W, v):
    return (W @ v[..., None])[..., 0]


def _combine(W, c, lanes=False):
    """``cᵀ W``: ``(n,)``, or ``(B, n)``."""
    return ops_mod.over_lanes(pt.basis_combine, _combine_batched, lanes, W, c)


def _combine_batched(W, c):
    return (c[..., None, :] @ W)[..., 0, :]


def _chol_solve(chol: torch.Tensor, rhs: torch.Tensor, lanes=False) -> torch.Tensor:
    """``(L Lᵀ)⁻¹ rhs`` for a vector or matrix ``rhs`` (each lane's with
    ``lanes``)."""
    return ops_mod.over_lanes(_chol_solve_batched, _chol_solve_batched, lanes, chol, rhs)


def _chol_solve_batched(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    if rhs.ndim == chol.ndim - 1:
        return torch.cholesky_solve(rhs[..., None], chol)[..., 0]
    return torch.cholesky_solve(rhs, chol)


def _factor(W, AW, jitter: float):
    """The lower factor of the symmetrized, regularized ``WᵀAW`` (see
    :func:`factor_waw_gram`), over any leading lane axis."""
    k = W.shape[-2]
    waw = pt.gram(W, AW) if W.ndim == 2 else W @ AW.transpose(-2, -1)
    waw = 0.5 * (waw + waw.transpose(-2, -1))
    dj = torch.diagonal(waw, dim1=-2, dim2=-1)
    tr = torch.sum(dj, -1, keepdim=True)
    if jitter:
        scale = torch.where(tr > 0, tr / k, 1.0)
        waw = waw + jitter * scale[..., None] * torch.eye(k, dtype=waw.dtype, device=waw.device)
    waw = waw + torch.diag_embed(torch.where(dj == 0.0, torch.clamp(tr / k, min=1.0), 0.0))
    return torch.linalg.cholesky_ex(waw)[0]


def factor_waw_gram(W: torch.Tensor, AW: torch.Tensor, jitter: float,
                    lanes: bool = False) -> torch.Tensor:
    """Lower Cholesky factor of the symmetrized ``WᵀAW`` (``(k, k)``; each
    lane's, ``(B, k, k)``, with ``lanes``).

    Relative diagonal jitter, plus unconditional regularization of
    exactly-zero columns (clamped extraction slots, cold states): ``Wᵀr = 0``
    there, so any positive diagonal gives the same deflation (``c_i = μ_i
    = 0``).  LSMR factors ``WᵀNW`` with the same policy.
    """
    def factor(w, aw):
        return _factor(w, aw, jitter)

    return ops_mod.over_lanes(factor, factor, lanes, W, AW)


def deflated_initial_guess(x_prev, r_prev, W, AW, waw_chol, lanes: bool = False):
    """Line 3 of Alg. 1: ``x0 = x_{-1} + W (WᵀAW)⁻¹ Wᵀ r_{-1}``, with
    ``r0 = r_{-1} − AWᵀc`` updated through ``AW`` (no extra matvec)."""
    c = _chol_solve(waw_chol, _basis_dot(W, r_prev, lanes), lanes)
    x0 = x_prev + _combine(W, c, lanes)
    r0 = r_prev - _combine(AW, c, lanes)
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
    flat_recycle: bool = False,
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

    Pytrees: ``b``, ``x0`` and the bases ``W``/``AW`` (a vector's
    structure with a leading axis of k) may be pytrees, as in :func:`cg`;
    ``x`` and, unless ``flat_recycle``, the recorded window come back in
    ``b``'s structure (the setup runs on the flat coordinates too, so any
    layout of the same coordinates gives the same iterates).
    """
    if not all(t is None or pt.is_flat(t) for t in (b, x0, W, AW)):
        b_flat, unravel = pt.ravel_vector(b)
        res = defcg(
            pt.flat_operator(A, unravel), b_flat, None if x0 is None else pt.ravel(x0),
            None if W is None else pt.ravel_basis(W),
            None if AW is None else pt.ravel_basis(AW),
            ell=ell, tol=tol, atol=atol, maxiter=maxiter, record_residuals=record_residuals,
            waw_jitter=waw_jitter, exact_aw=exact_aw,
            M=None if M is None else pt.flat_operator(M, unravel), stale_guard=stale_guard,
            stagnation_window=stagnation_window, flat_recycle=True,
        )
        rec = res.recycle
        if rec is not None and not flat_recycle:
            rec = rec._replace(P=pt.unravel_basis(rec.P, unravel),
                               AP=pt.unravel_basis(rec.AP, unravel))
        return res._replace(x=unravel(res.x), recycle=rec)
    return _defcg(A, b, x0, W, AW, lanes=False, ell=ell, tol=tol, atol=atol, maxiter=maxiter,
                  record_residuals=record_residuals, waw_jitter=waw_jitter, exact_aw=exact_aw,
                  M=M, stale_guard=stale_guard, stagnation_window=stagnation_window)


def defcg_lanes(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    W: Optional[torch.Tensor] = None,
    AW: Optional[torch.Tensor] = None,
    **kwargs,
) -> CGResult:
    """:func:`defcg` for B tenants at once: ``b`` is ``(B, n)``, ``W``/``AW``
    ``(B, k, n)``, ``A`` a batched operator
    (:func:`repro_torch.core.operators.lane_operator`) and ``M`` a batched
    apply; the keywords are :func:`defcg`'s.  Each lane is its own solve:
    its threshold, flags, counts, trace and recording slot; ``W=None`` is
    (preconditioned) CG.

    The same iteration as :func:`defcg`, with every vector ``(B, n)``: a
    step is ONE product of the stack behind the lanes' gate (skipped, on
    operators with a device gate, once every lane is frozen), then the
    lane-axis step arms: K1's ``fused_cg_step`` (and, with ``M``, K6's
    ``fused_rz_step``) and K2's ``fused_direction_step``, one launch each
    for all lanes.  The host reads "any lane active" once per chunk and
    never during the ``ell`` recording steps; the stale guard's refresh is
    one host read ("any lane fired") and a ``where`` per lane.  The info
    fields and the window gain the leading B.
    """
    return _defcg(A, b, x0, W, AW, lanes=True, **kwargs)


def _defcg(A, b, x0, W, AW, *, lanes: bool, ell: int = 0, tol: float = 1e-5,
           atol: float = 0.0, maxiter: int = 1000, record_residuals: bool = False,
           waw_jitter: float = DEFAULT_WAW_JITTER, exact_aw: bool = True, M=None,
           stale_guard: Optional[float] = None, stagnation_window: int = 0) -> CGResult:
    """The def-CG solve of :func:`defcg` (``lanes`` False: flat ``(n,)``
    vectors) and :func:`defcg_lanes` (a leading lane axis)."""
    lead = b.shape[:-1]
    n = b.shape[-1]
    dtype, device = b.dtype, b.device
    threshold = torch.clamp(tol * _norm(b, lanes), min=atol)
    matvecs = 0
    guard_fired = torch.zeros(lead, dtype=torch.bool, device=device) if lanes else False
    x = torch.zeros_like(b) if x0 is None else x0

    deflating = W is not None
    k = W.shape[-2] if deflating else 0
    aw = waw_inv = None
    if deflating:
        # Row-major, as the step kernels read it (and so that a lane's
        # reductions meet the layout its one-system solve's meet).
        aw = (ops_mod.apply_to_basis(A, W) if AW is None else AW).contiguous()
        if AW is None:
            matvecs += k
        chol = factor_waw_gram(W, aw, waw_jitter, lanes)
        x_in = x
        r_init = b - A(x_in)
        matvecs += 1
        x, r = deflated_initial_guess(x_in, r_init, W, aw, chol, lanes)
        if not exact_aw:
            r_short = r
            r = b - A(x)
            matvecs += 1
            if stale_guard is not None:
                # ‖r_true − r_short‖ = ‖(A·W − AW)c‖: the staleness of AW
                # along the deflated component, already paid for.
                drift_obs = _norm(r - r_short, lanes) / torch.clamp(
                    _norm(r_init, lanes), min=torch.finfo(dtype).tiny
                )
                guard_eff = max(
                    stale_guard, DRIFT_NOISE_FLOOR_EPS * torch.finfo(dtype).eps
                )
                fire = drift_obs > guard_eff
                # One host read: does any lane refresh?
                if bool(torch.any(fire) if lanes else fire):
                    aw_new = ops_mod.apply_to_basis(A, W).contiguous()
                    chol_new = factor_waw_gram(W, aw_new, waw_jitter, lanes)
                    x_new, r_new = deflated_initial_guess(x_in, r_init, W, aw_new, chol_new,
                                                          lanes)
                    if lanes:  # each lane keeps its own setup
                        sel = fire[:, None]
                        aw = torch.where(sel[..., None], aw_new, aw)
                        chol = torch.where(sel[..., None], chol_new, chol)
                        x, r = torch.where(sel, x_new, x), torch.where(sel, r_new, r)
                        matvecs = matvecs + k * fire.to(torch.int32)
                        guard_fired = fire
                    else:
                        aw, chol, x, r = aw_new, chol_new, x_new, r_new
                        matvecs += k
                        guard_fired = True
    else:
        r = b - A(x)
        matvecs += 1
    x, r = x.contiguous(), r.contiguous()
    z = r if M is None else M(r).contiguous()
    if deflating:
        # Deflation in the preconditioned inner product: μ from (AW)ᵀz.
        mu0 = _chol_solve(chol, _basis_dot(aw, z, lanes), lanes)
        p = (z - _combine(W, mu0, lanes)).contiguous()
        eye = torch.eye(k, dtype=aw.dtype, device=device).expand(lead + (k, k))
        # Row-major, as the step kernel reads it.
        waw_inv = _chol_solve(chol, eye, lanes).contiguous()
    else:
        p = z

    rnorm0 = _norm(r, lanes)
    # The carried recurrence scalar: rᵀz (‖r‖² without a preconditioner).
    rs0 = _dot(r, z, lanes)
    trace0 = engine.trace_init(rnorm0, maxiter, record_residuals)
    diverged_at = 1e8 * torch.maximum(rnorm0, _norm(b, lanes))

    # What the steps write in place rides in the state: the recording
    # buffers, row ``ell`` the spare row frozen steps write to.
    bufs = None
    if ell > 0:
        bufs = (torch.zeros(lead + (ell + 1, n), dtype=dtype, device=device),
                torch.zeros(lead + (ell + 1, n), dtype=dtype, device=device),
                torch.zeros(lead + (ell + 1,), dtype=dtype, device=device),
                torch.zeros(lead + (ell + 1,), dtype=dtype, device=device))
    consts = dict(A=A, M=M, W=W, aw=aw, waw_inv=waw_inv, threshold=threshold,
                  diverged_at=diverged_at, maxiter=maxiter, window=stagnation_window,
                  lanes=lanes)
    js0, active0, best0 = _initial_flags(rnorm0, threshold, maxiter,
                                          stagnation_window)
    state = (js0, x, r, p, rs0, rnorm0, active0, trace0, best0, bufs)
    state = engine.run_recording_loop(_defcg_step, _active, state, ell=ell, consts=consts)
    js, x, _, _, _, rnorm, _, trace, _, bufs = state
    j, fail = js[..., 0], js[..., 1]

    info = _info(j, matvecs, rnorm, threshold, trace, fail, maxiter, guard_fired)
    recycle = None
    if ell > 0:
        p_buf, ap_buf, a_rows, b_rows = bufs
        recycle = RecycleData(
            P=p_buf[..., :ell, :],
            AP=ap_buf[..., :ell, :],
            stored=torch.clamp(j, max=ell),
            alpha=a_rows[..., :ell],
            beta=b_rows[..., :ell],
            aw_used=(
                aw if (deflating and not exact_aw and stale_guard is not None)
                else None
            ),
        )
    return CGResult(x=x, info=info, recycle=recycle)


def _defcg_step(c, state, active, row):
    """One masked def-CG iteration of :func:`defcg` / :func:`defcg_lanes`
    (``c``: its consts); ``active=False`` freezes the state."""
    js, x, r, p, rs, rnorm, _, trace, best, bufs = state
    A, M, W, aw, waw_inv = c["A"], c["M"], c["W"], c["aw"], c["waw_inv"]
    lanes, window = c["lanes"], c["window"]
    ap = engine.gated_matvec(A, p, active).contiguous()
    d = _dot(p, ap, lanes)
    rows = {} if row is None else dict(row=row, a_rows=bufs[2], b_rows=bufs[3])
    if M is None:
        # rᵀr IS the recurrence scalar: the deflation GEMV, β and μ ride
        # in the update's launch.
        x, r, ap, so, js, flags = kops.fused_cg_step(
            x, r, p, ap, d, rs, rnorm, js, active, c["threshold"], c["diverged_at"],
            c["maxiter"], aw, waw_inv, trace=trace, window=window, best=best, **rows,
        )
        zvec, rs_new, beta = r, so[..., 0], so[..., 3]
        mu = so[..., 4:4 + W.shape[-2]] if W is not None else None
    else:
        # z = M⁻¹r exists only after the update: rᵀz, (AW)ᵀz, β, μ and the
        # recorded α / β come from K6's step arm, a second launch.
        x, r, ap, so, js, flags = kops.fused_cg_step(
            x, r, p, ap, d, rs, rnorm, js, active, c["threshold"], c["diverged_at"],
            c["maxiter"], recurrence=False, trace=trace, window=window, best=best,
        )
        zvec = M(r).contiguous()
        sz = kops.fused_rz_step(r, zvec, rs, aw, waw_inv, alpha=so[..., 2], active=active,
                                **rows)
        rs_new, beta = sz[..., 0], sz[..., 1]
        mu = sz[..., 2:] if W is not None else None
    # Frozen steps record into the spare row ``ell``.  p is frozen on
    # breakdown too (flags[1] = active ∧ ¬bad): a poisoned basis can make
    # p_new non-finite through μ even with a sanitized A·p.
    rec = {} if row is None else dict(ap=ap, active=active, row=row, p_buf=bufs[0],
                                      ap_buf=bufs[1])
    p = kops.fused_direction_step(zvec, p, beta, flags[..., 1], W, mu, **rec)
    return (js, x, r, p, rs_new, so[..., 1], flags[..., 0], trace,
            so[..., -1] if window else None, bufs)


# ---------------------------------------------------------------------------
# Dense baseline (paper Table 1's Cholesky column)
# ---------------------------------------------------------------------------


def cholesky_solve(mat: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact SPD solve via Cholesky — the paper's cubic-cost baseline."""
    return _chol_solve(torch.linalg.cholesky(mat), b)


# ---------------------------------------------------------------------------
# Compiled entry points (the reference's jitted doors)
# ---------------------------------------------------------------------------
#
# One program per loop shape (repro_torch.core.engine.Program): on the card
# the masked loop's two phases are CUDA graphs, captured by the first solve
# of a shape and replayed by every later one.  Tensors (``b``, ``x0``, the
# bases, an operator's or a preconditioner's tensors) are copied into the
# program's buffers; shapes, dtypes, the keyword settings and each callable
# by its identity select the program, so a Newton loop that reuses one
# ``kernel_matvec`` closure captures each solver variant once.

cg_jit = engine.compiled_door(cg, """:func:`cg` as one compiled program.

``M`` may be None, a registered preconditioner (its tensors copied in:
rebuild it freely) or a bare callable (static by identity, as in the
reference's static-``M`` jit).  Same arguments and results as :func:`cg`,
bit for bit.""")

defcg_jit = engine.compiled_door(defcg, """:func:`defcg` as one compiled program.

Same arguments and results as :func:`defcg`, bit for bit; the setup (the
deflated initial guess, the stale guard's host read) and the window's
hand-off run eagerly around the captured loop.""")
