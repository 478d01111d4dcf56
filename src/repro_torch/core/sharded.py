"""The sharded Krylov engine on ``torch.distributed`` (DESIGN.md §5).

The counterpart of ``repro.core.sharded``.  The reference runs one
program over a 1-D ``"solve"`` mesh under ``shard_map``; here every rank
of a :class:`repro_torch.launch.SolveMesh` is its own process running the
same solve (SPMD).  Every length-n vector of an iteration (``x, r, p``),
the ``(k, n)`` recycled basis ``W, AW`` and the ``(ell, n)`` window rows
are split by columns: rank ``i`` of ``p`` owns ``[i·n/p, (i+1)·n/p)``.
The fused kernels (K1, K2, K6, K7, and K4/K5 in the extraction) run per
rank on its columns.

The communication contract is ONE all-reduce per cg / def-CG iteration:
every scalar reduction of a step — ``pᵀAp``, ``rᵀAp``, ``ApᵀAp``, the
deflation GEMVs ``(AW)ᵀAp`` / ``(AW)ᵀr`` and a FRESH ``‖r‖²`` of the
incoming residual — rides one :func:`repro_torch.core.engine.psum_merged`.
The post-update quantities follow from one-step recurrences

    ‖r₊‖² = ‖r‖² − 2α·rᵀAp + α²·ApᵀAp,
    (AW)ᵀr₊ = (AW)ᵀr − α·(AW)ᵀAp,

used only for β, μ and the stopping test; α always comes from the freshly
reduced ``‖r‖²``, so recurrence rounding does not accumulate (parity with
the unsharded engine is ~1e-13 in f64).  LSMR needs two all-reduces per
iteration (``β = ‖u₊‖`` must normalize ``u`` before ``Âᵀu`` exists).
:data:`COLLECTIVES` counts them by kind, where the reference reads them
from compiled HLO (``repro.launch.hlo_stats``).

Operator side: a product costs one ``all_gather`` of the direction.  Two
operator kinds shard natively:

* :class:`repro_torch.core.operators.DenseMatrixOperator` — each rank
  multiplies its row block by the gathered vector (LSMR: the transpose's
  row block too);
* :class:`repro_torch.core.operators.RBFKernelSystemOperator` — each rank
  keeps its rows of ``X`` and ``H½``; the full ``X`` is gathered ONCE per
  solve, outside the loop, and every product is K8
  (:func:`repro_torch.kernels.ops.rbf_matvec_rect`, this rank's rows
  against all columns), K never formed.

The loop is the port's masked-step harness (:mod:`repro_torch.core.engine`)
with one host read per chunk of steps, of a value every rank computes
from the same all-reduced scalars: every rank takes the same branch (a
rank that decided alone would leave the others waiting in a collective).

The front door (:func:`repro_torch.core.solve` with ``mesh=``) takes the
global operator and right-hand side on every rank; each rank reads only
its rows.  The result's ``x`` comes back whole on every rank (one
``all_gather`` after the loop); the returned :class:`RecycleState` holds
THIS RANK's columns, so that it carries into the next sharded solve on
the same group.  ``SolveMesh.gather_state`` makes it whole again, for a
solve at another group size or an unsharded one; a state passed in whole
``(k, n)`` is split here.

Differences from the unsharded front door, as in the reference: no
recovery ladder (a broken solve retires the basis and falls back to the
finite warm start), no preconditioner, methods ``cg``, ``defcg`` and
``lsmr`` only, and only the :class:`HarmonicRitz` strategy.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import engine
from repro_torch.core import operators as ops_mod
from repro_torch.core.engine import SolveStatus
from repro_torch.core.lsmr import _safe, _sym_ortho
from repro_torch.core.recycle import RecycleState
from repro_torch.core.solvers import _info, _trace_write
from repro_torch.core.strategies import HarmonicRitz, extract_next_basis_core
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import COLLECTIVES, SolveMesh

__all__ = ["COLLECTIVES", "shard_recycle_state", "solve_sharded"]

_SHARDED_METHODS = ("cg", "defcg", "lsmr")


def shard_recycle_state(state: RecycleState, mesh: SolveMesh) -> RecycleState:
    """This rank's columns of a full ``state`` (the rule of the solve mesh:
    W/AW split by columns, the k-sized and scalar leaves replicated)."""
    return mesh.shard_state(state)


# ---------------------------------------------------------------------------
# Operator planning — which leaves shard, and how a rank applies them
# ---------------------------------------------------------------------------


def _plan_operator(A, *, need_adjoint: bool):
    """``(kind, aux, leaves)``: the operator's full data leaves and the
    static ``aux`` that :func:`_make_applies` needs."""
    if isinstance(A, ops_mod.RBFKernelSystemOperator):
        aux = (float(A.theta), float(A.lengthscale), int(A.block), A.backend)
        return "rbf", aux, (A.x, A.sqrt_h)
    mat = getattr(A, "mat", None)
    if mat is not None:
        # LSMR contracts with Aᵀ too: its row block is a leaf of its own,
        # so the adjoint product is also a local row-block GEMV.
        leaves = (mat, mat.T) if need_adjoint else (mat,)
        return "dense", (), leaves
    raise TypeError(
        "solve(..., mesh=...) shards the operator's data leaves along n; "
        "that needs a DenseMatrixOperator (row-sharded matrix) or an "
        f"RBFKernelSystemOperator (row-sharded data) — got {type(A).__name__}. "
        "Unsharded callers: drop the mesh argument."
    )


def _make_applies(kind: str, aux, leaves, mesh: SolveMesh):
    """This rank's ``(apply, rapply, basis_apply)`` over its local leaves.

    Each product all-gathers its input once; the RBF operator gathers the
    full data ``X`` here, once per solve."""
    if kind == "dense":
        mat_loc = leaves[0]

        def apply(v):
            return mat_loc @ mesh.all_gather(v)

        if len(leaves) > 1:
            mat_t_loc = leaves[1]

            def rapply(u):
                return mat_t_loc @ mesh.all_gather(u)

        else:
            rapply = apply

        def basis_apply(w):  # (k, n_loc) -> (k, n_loc)
            return mesh.all_gather(w, dim=1) @ mat_loc.T

        return apply, rapply, basis_apply

    theta, lengthscale, block, backend = aux
    x_loc, sh_loc = leaves
    x_full = mesh.all_gather(x_loc)

    def product(u_full):  # this rank's rows of K(X, X) @ u_full
        return kops.rbf_matvec_rect(
            x_loc, x_full, u_full, theta, lengthscale, backend=backend, block=block
        )

    def apply(v):
        return v + sh_loc * product(mesh.all_gather(sh_loc * v))

    def basis_apply(w):  # (k, n_loc): one multi-RHS pass
        u_full = mesh.all_gather(w * sh_loc[None, :], dim=1)
        return w + sh_loc[None, :] * product(u_full.T).T

    return apply, apply, basis_apply


# ---------------------------------------------------------------------------
# The method bodies: per-rank state, merged all-reduces
# ---------------------------------------------------------------------------


def _zero_on(bad, *ts):
    return [torch.where(bad, 0.0, t) for t in ts]


def _sharded_cg(apply, mesh, b, x0, *, tol, atol, maxiter, record_residuals):
    """Plain CG on per-rank state: one merged all-reduce per iteration
    (``[pᵀAp, rᵀAp, ApᵀAp, ‖r‖²]``)."""
    r0 = b - apply(x0)
    bsq, rs0 = engine.psum_merged([torch.dot(b, b), torch.dot(r0, r0)], mesh)
    bnorm = torch.sqrt(bsq)
    threshold = torch.clamp(tol * bnorm, min=atol)
    rnorm0 = torch.sqrt(rs0)
    trace0 = engine.trace_init(rnorm0, maxiter, record_residuals)
    diverged_at = 1e8 * torch.maximum(rnorm0, bnorm)

    def active_fn(state):
        j, rnorm, fail = state[0], state[4], state[6]
        return (j < maxiter) & (rnorm > threshold) & (fail == 0)

    def step(state, active, row):
        del row  # CG records no window
        j, x, r, p, rnorm, trace, fail = state
        ap = apply(p)
        d, rap, apap, rs = engine.psum_merged(
            [torch.dot(p, ap), torch.dot(r, ap), torch.dot(ap, ap), torch.dot(r, r)],
            mesh,
        )
        bad, code = engine.classify_breakdown(d, rnorm, diverged_at)
        fail = torch.where(active & (fail == 0), code, fail)
        ap, rap, apap = _zero_on(bad, ap, rap, apap)
        alpha = torch.where(bad | ~active, 0.0, rs / torch.where(bad, 1.0, d))
        x, r, _, _ = kops.fused_cg_update(x, r, p, ap, alpha)
        # One-step ‖r₊‖² recurrence off the fresh ‖r‖² (clamped: at
        # convergence the cancellation can go eps-negative).
        rs_new = torch.clamp(rs - 2.0 * alpha * rap + alpha * alpha * apap, min=0.0)
        beta = rs_new / torch.where(rs == 0.0, 1.0, rs)
        p_new, _, _ = kops.fused_deflate_direction(r, p, beta)
        p = torch.where(active, p_new, p)
        rnorm_new = torch.sqrt(rs_new)
        fail = torch.where(
            (fail == 0) & active & ~torch.isfinite(rnorm_new),
            SolveStatus.BREAKDOWN_NONFINITE,
            fail,
        ).to(torch.int32)
        rnorm = torch.where(active, rnorm_new, rnorm)
        if trace is not None:
            _trace_write(trace, j, rnorm, active)
        return (j + active.to(j.dtype), x, r, p, rnorm, trace, fail)

    j0 = torch.zeros((), dtype=torch.int32, device=b.device)
    state = (j0, x0, r0, r0, rnorm0, trace0, engine.initial_fail(rnorm0))
    j, x, _, _, rnorm, trace, fail = engine.run_recording_loop(step, active_fn, state)
    return x, _info(j, 1, rnorm, threshold, trace, fail, maxiter)


def _sharded_defcg(
    apply, basis_apply, mesh, b, x0, w, aw_carry, *, k, ell, tol, atol, maxiter,
    select, waw_jitter, refresh_aw, record_residuals,
):
    """Deflated CG + harmonic-Ritz extraction on per-rank state.

    The iteration's ONE all-reduce merges ``[pᵀAp, rᵀAp, ApᵀAp, (AW)ᵀAp,
    ‖r‖², (AW)ᵀr]``: fresh reductions of the incoming residual (two K6
    passes) plus the Ap products; ``‖r₊‖²`` and ``(AW)ᵀr₊`` for β and μ
    come from the one-step recurrences.  Returns ``(x, info, W', AW',
    theta)`` with ``theta`` None when ``ell == 0``.
    """
    dtype, device = b.dtype, b.device
    matvecs = 0

    # -- strategy.prepare (HarmonicRitz): exact refresh or stale ---------
    if refresh_aw == "stale":
        aw_used = aw_carry
    else:
        (nonzero,) = engine.psum_merged([torch.count_nonzero(w)], mesh)
        if bool(nonzero > 0):  # one host read, the same on every rank
            aw_used = basis_apply(w)
            matvecs += k
        else:
            aw_used = torch.zeros_like(w)

    # -- setup: WᵀAW factor + deflated initial guess ---------------------
    r_init = b - apply(x0)
    matvecs += 1
    waw, bsq, wr = engine.psum_merged([w @ aw_used.T, torch.dot(b, b), w @ r_init], mesh)
    bnorm = torch.sqrt(bsq)
    threshold = torch.clamp(tol * bnorm, min=atol)
    # Same regularization policy as solvers.factor_waw_gram.
    eye = torch.eye(k, dtype=dtype, device=device)
    waw = 0.5 * (waw + waw.T)
    dj = torch.diagonal(waw)
    tr = torch.sum(dj)
    if waw_jitter:
        waw = waw + waw_jitter * torch.where(tr > 0, tr / k, 1.0) * eye
    waw = waw + torch.diag(torch.where(dj == 0.0, torch.clamp(tr / k, min=1.0), 0.0))
    chol = torch.linalg.cholesky_ex(waw)[0]
    c = torch.cholesky_solve(wr[:, None], chol)[:, 0]
    x = x0 + c @ w
    r = r_init - c @ aw_used
    rs0, awr0 = engine.psum_merged([torch.dot(r, r), aw_used @ r], mesh)
    mu0 = torch.cholesky_solve(awr0[:, None], chol)[:, 0]
    p0 = r - mu0 @ w
    winv = torch.cholesky_solve(eye, chol)
    rnorm0 = torch.sqrt(rs0)
    trace0 = engine.trace_init(rnorm0, maxiter, record_residuals)
    diverged_at = 1e8 * torch.maximum(rnorm0, bnorm)

    n_loc = b.shape[0]
    if ell > 0:
        # Row ``ell`` is the spare row frozen recording steps write to.
        p_buf = torch.zeros((ell + 1, n_loc), dtype=dtype, device=device)
        ap_buf = torch.zeros((ell + 1, n_loc), dtype=dtype, device=device)

    def active_fn(state):
        j, rnorm, fail = state[0], state[4], state[6]
        return (j < maxiter) & (rnorm > threshold) & (fail == 0)

    def step(state, active, row):
        j, x, r, p, rnorm, trace, fail = state
        ap = apply(p)
        rap_l, awap_l = kops.fused_rz_reduce(r, ap, aw_used)
        rs_l, awr_l = kops.fused_rz_reduce(r, r, aw_used)
        d, rap, apap, awap, rs, awr = engine.psum_merged(
            [torch.dot(p, ap), rap_l, torch.dot(ap, ap), awap_l, rs_l, awr_l], mesh
        )
        bad, code = engine.classify_breakdown(d, rnorm, diverged_at)
        fail = torch.where((fail == 0) & active, code, fail)
        # Sanitize the poisoned reductions too: alpha is zeroed on
        # breakdown, but 0·NaN would still poison the recurrences.
        ap, rap, apap, awap = _zero_on(bad, ap, rap, apap, awap)
        alpha = torch.where(bad | ~active, 0.0, rs / torch.where(bad, 1.0, d))
        x, r, _, _ = kops.fused_cg_update(x, r, p, ap, alpha)
        rs_new = torch.clamp(rs - 2.0 * alpha * rap + alpha * alpha * apap, min=0.0)
        mu = winv @ (awr - alpha * awap)
        beta = rs_new / torch.where(rs == 0.0, 1.0, rs)
        if row is None:
            p_new, _, _ = kops.fused_deflate_direction(r, p, beta, w, mu)
        else:
            # The incoming (p, Ap) go to window row ``row``; frozen steps
            # write the spare row.
            slot = torch.where(active, row, ell).to(torch.int64)
            p_new, _, _ = kops.fused_deflate_direction(
                r, p, beta, w, mu, ap, slot, p_buf, ap_buf
            )
        p = torch.where(active & ~bad, p_new, p)
        rnorm_new = torch.sqrt(rs_new)
        fail = torch.where(
            (fail == 0) & active & ~torch.isfinite(rnorm_new),
            SolveStatus.BREAKDOWN_NONFINITE,
            fail,
        ).to(torch.int32)
        rnorm = torch.where(active, rnorm_new, rnorm)
        if trace is not None:
            _trace_write(trace, j, rnorm, active)
        return (j + active.to(j.dtype), x, r, p, rnorm, trace, fail)

    j0 = torch.zeros((), dtype=torch.int32, device=device)
    state = (j0, x, r, p0, rnorm0, trace0, engine.initial_fail(rnorm0))
    j, x, _, _, rnorm, trace, fail = engine.run_recording_loop(
        step, active_fn, state, ell=ell
    )
    info = _info(j, matvecs, rnorm, threshold, trace, fail, maxiter)

    # -- strategy.transition: sharded harmonic-Ritz extraction -----------
    theta = None
    if ell > 0:
        w2, aw2, theta, _ = extract_next_basis_core(
            w, aw_used, p_buf[:ell], ap_buf[:ell], torch.clamp(j, max=ell), k,
            select=select, psum_axis=mesh,
        )
    else:
        w2, aw2 = w, aw_used

    # -- terminal retirement: never hand poisoned coordinates or a
    # poisoned basis to the caller or the next system.  One merged
    # all-reduce covers both finiteness checks.
    nonfinite_x, nonfinite_basis = engine.psum_merged(
        [
            torch.sum(~torch.isfinite(x)),
            torch.sum(~torch.isfinite(w2)) + torch.sum(~torch.isfinite(aw2)),
        ],
        mesh,
    )
    x_safe = torch.where(torch.isfinite(x0), x0, 0.0)
    x = torch.where(nonfinite_x == 0, x, x_safe)
    retire = info.breakdown | (nonfinite_basis > 0)
    w2, aw2 = _zero_on(retire, w2, aw2)
    if theta is not None:
        theta = torch.where(retire, 0.0, theta)
    return x, info, w2, aw2, theta


def _sharded_lsmr(
    apply, rapply, mesh, b, x0, *, has_x0, damp, tol, atol, maxiter, record_residuals
):
    """Plain LSMR on per-rank state: 2 all-reduces per iteration (the
    Golub–Kahan β and α normalizations are serially dependent)."""
    has_shift = damp > 0.0
    sqrt_damp = float(damp) ** 0.5

    init_mv = 1
    if has_x0:
        r_m = b - apply(x0)
        init_mv += 1
    else:
        r_m = b
    bsum = torch.dot(r_m, r_m)
    u_n0 = None
    if has_shift:
        u_n0 = -sqrt_damp * x0
        bsum = bsum + torch.dot(u_n0, u_n0)
    (beta_sq,) = engine.psum_merged([bsum], mesh)
    beta1 = torch.sqrt(beta_sq)
    u_m0 = r_m / _safe(beta1)
    g0 = rapply(u_m0)
    if has_shift:
        u_n0 = u_n0 / _safe(beta1)
        g0 = g0 + sqrt_damp * u_n0
    (asum,) = engine.psum_merged([torch.dot(g0, g0)], mesh)
    alpha1 = torch.sqrt(asum)
    v0 = g0 / _safe(alpha1)

    normar0 = alpha1 * beta1
    threshold = torch.clamp(tol * normar0, min=atol)
    diverged_at = 1e8 * normar0
    trace0 = engine.trace_init(normar0, maxiter, record_residuals)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    def active_fn(state):
        j, zetabar, fail = state[0], state[7], state[16]
        return (j < maxiter) & (torch.abs(zetabar) > threshold) & (fail == 0)

    def step(state, active, row):
        del row  # no window
        (j, x, u_m, u_n, v, g, alpha, zetabar, alphabar, rho, rhobar,
         cbar, sbar, h, hbar, trace, fail) = state

        u_m_new = apply(v) - alpha * u_m
        bs = torch.dot(u_m_new, u_m_new)
        if has_shift:
            u_n_new = sqrt_damp * v - alpha * u_n
            bs = bs + torch.dot(u_n_new, u_n_new)
        (beta_sq_,) = engine.psum_merged([bs], mesh)
        beta_new = torch.sqrt(beta_sq_)
        u_m_new = u_m_new / _safe(beta_new)
        g_new = rapply(u_m_new)
        if has_shift:
            u_n_new = u_n_new / _safe(beta_new)
            g_new = g_new + sqrt_damp * u_n_new
        w_vec = g_new - beta_new * v
        (as_,) = engine.psum_merged([torch.dot(w_vec, w_vec)], mesh)
        alpha_new = torch.sqrt(as_)
        v_new = w_vec / _safe(alpha_new)

        c, s, rho_new = _sym_ortho(alphabar, beta_new)
        thetanew = s * alpha_new
        alphabar_new = c * alpha_new
        thetabar = sbar * rho_new
        cbar_new, sbar_new, rhobar_new = _sym_ortho(cbar * rho_new, thetanew)
        zeta = cbar_new * zetabar
        zetabar_new = -sbar_new * zetabar

        c0 = thetabar * rho_new / (rho * rhobar)
        c1 = zeta / (_safe(rho_new) * _safe(rhobar_new))
        c2 = thetanew / _safe(rho_new)
        x_new, hbar_new, h_new = kops.lsmr_update(x, hbar, h, v_new, c0, c1, c2)

        exact = (beta_new == 0.0) | (alpha_new == 0.0)
        zetabar_new = torch.where(exact, 0.0, zetabar_new)
        normar_new = torch.abs(zetabar_new)
        live = (fail == 0) & active
        fail = torch.where(
            live & ~torch.isfinite(normar_new), SolveStatus.BREAKDOWN_NONFINITE, fail
        ).to(torch.int32)
        fail = torch.where(
            (fail == 0) & active & (normar_new > diverged_at), SolveStatus.STAGNATED, fail
        ).to(torch.int32)
        if trace is not None:
            _trace_write(trace, j, normar_new, active)

        def sel(new, cur):
            return torch.where(active, new, cur)

        return (
            j + active.to(j.dtype), sel(x_new, x), sel(u_m_new, u_m),
            sel(u_n_new, u_n) if has_shift else None, sel(v_new, v), sel(g_new, g),
            sel(alpha_new, alpha), sel(zetabar_new, zetabar),
            sel(alphabar_new, alphabar), sel(rho_new, rho), sel(rhobar_new, rhobar),
            sel(cbar_new, cbar), sel(sbar_new, sbar), sel(h_new, h),
            sel(hbar_new, hbar), trace, fail,
        )

    j0 = torch.zeros((), dtype=torch.int32, device=b.device)
    state = (
        j0, x0, u_m0, u_n0, v0, g0, alpha1, normar0, alpha1, one, one, one,
        torch.zeros_like(one), v0, torch.zeros_like(v0), trace0,
        engine.initial_fail(normar0),
    )
    state = engine.run_recording_loop(step, active_fn, state)
    j, x, zetabar, trace, fail = state[0], state[1], state[7], state[15], state[16]
    # matvecs: init_mv + 2 per iteration (one A, one Aᵀ product).
    return x, _info(j, init_mv + j, torch.abs(zetabar), threshold, trace, fail, maxiter)


# ---------------------------------------------------------------------------
# The front door
# ---------------------------------------------------------------------------


def _divisible(name: str, size: int, mesh: SolveMesh) -> None:
    if size % mesh.size != 0:
        raise ValueError(
            f"{name} has length {size}, not divisible by the solve mesh's "
            f"{mesh.size} ranks — pad the problem or resize the mesh "
            "(repro_torch.launch.make_solve_mesh(n_devices=...))"
        )


def _check(spec, mesh) -> None:
    if not isinstance(mesh, SolveMesh):
        raise ValueError(
            "mesh must be a repro_torch.launch.SolveMesh (the 'solve' axis) — "
            f"build one with repro_torch.launch.make_solve_mesh(), got {type(mesh).__name__}"
        )
    if not mesh.member:
        raise ValueError(
            "this rank is not a member of the solve mesh: only the world's "
            f"first {mesh.size} ranks solve on it"
        )
    if spec.method not in _SHARDED_METHODS:
        raise NotImplementedError(
            f"method={spec.method!r} has no sharded path yet (supported: "
            f"{_SHARDED_METHODS}); drop the mesh argument"
        )
    if spec.precond != "none":
        raise ValueError(
            "the sharded engine has no preconditioner path — use "
            "precond='none' or drop the mesh argument"
        )
    if spec.method == "defcg" and type(spec.strategy) is not HarmonicRitz:
        raise ValueError(
            "the sharded def-CG path extracts through the default "
            f"HarmonicRitz strategy only, got {type(spec.strategy).__name__}"
        )
    if spec.stagnation_window > 0:
        raise NotImplementedError(
            "the stagnation detector (stagnation_window > 0) is not ported "
            "yet: ROADMAP queue 1 item 10"
        )


def _local_state(state, spec, n: int, mesh: SolveMesh, like: torch.Tensor):
    """This rank's columns of ``state``: cold when None, split when whole
    ``(k, n)``, as it is when already ``(k, n / size)``."""
    n_loc = n // mesh.size
    if state is None:
        return RecycleState.zeros(spec.k, n_loc, dtype=like.dtype, device=like.device)
    shape = tuple(state.W.shape)
    if shape == (spec.k, n):
        return mesh.shard_state(state)
    if shape == (spec.k, n_loc):
        return state
    raise ValueError(
        f"state.W has shape {shape}; spec(k={spec.k}) over this system needs "
        f"({spec.k}, {n}) whole or ({spec.k}, {n_loc}) per rank — state and "
        "spec must agree"
    )


def solve_sharded(
    A,
    b: torch.Tensor,
    spec=None,
    state: Optional[RecycleState] = None,
    *,
    mesh: SolveMesh,
    x0: Optional[torch.Tensor] = None,
    record_residuals: bool = False,
):
    """One solve split over ``mesh``'s ranks — the sharded twin of
    :func:`repro_torch.core.solve`, which forwards here when called with
    ``mesh=``.  Every rank calls it with the same global ``A``, ``b`` and
    ``x0``; see the module docstring for what comes back and for the
    (documented) differences from the unsharded path.
    """
    from repro_torch.core import api as api_mod

    spec = api_mod.SolveSpec() if spec is None else spec
    _check(spec, mesh)
    kind, aux, leaves = _plan_operator(A, need_adjoint=spec.method == "lsmr")
    m = b.shape[0]
    _divisible("b", m, mesh)
    n = leaves[0].shape[1] if (spec.method == "lsmr" and kind == "dense") else m
    if spec.method == "lsmr":
        _divisible("x", n, mesh)

    # This rank's rows of every leaf (the adjoint's rows are A's columns).
    rows_m, rows_n = mesh.block(m), mesh.block(n)
    local = [leaves[0][rows_m]]
    if kind == "rbf":
        local.append(leaves[1][rows_m])
    elif len(leaves) > 1:
        local.append(leaves[1][rows_n])
    local = [t.to(mesh.device).contiguous() for t in local]
    b_loc = b[rows_m].to(mesh.device)
    st = _local_state(state, spec, n, mesh, b_loc) if spec.method == "defcg" else None
    apply, rapply, basis_apply = _make_applies(kind, aux, local, mesh)
    x0_loc = (
        torch.zeros((n // mesh.size,), dtype=b.dtype, device=mesh.device)
        if x0 is None else x0[rows_n].to(mesh.device)
    )
    common = dict(tol=spec.tol, atol=spec.atol, maxiter=spec.maxiter,
                  record_residuals=record_residuals)

    new_state = state
    if spec.method == "cg":
        x, info = _sharded_cg(apply, mesh, b_loc, x0_loc, **common)
    elif spec.method == "lsmr":
        x, info = _sharded_lsmr(apply, rapply, mesh, b_loc, x0_loc,
                                has_x0=x0 is not None, damp=spec.lsq_shift, **common)
    else:
        x, info, w2, aw2, theta = _sharded_defcg(
            apply, basis_apply, mesh, b_loc, x0_loc, st.W, st.AW,
            k=spec.k, ell=spec.ell, select=spec.select, waw_jitter=spec.waw_jitter,
            refresh_aw=spec.refresh_aw, **common,
        )
        new_state = RecycleState(
            W=w2,
            AW=aw2,
            theta=st.theta if theta is None else theta,
            systems_solved=st.systems_solved + 1,
            drift=torch.zeros_like(st.drift) if spec.ell > 0 else st.drift,
        )
    return api_mod.SolveResult(
        x=mesh.gather(x), info=info, state=new_state,
        report=api_mod._make_report(info, 0),
    )
