"""Laplace-approximation GP classification — the paper's experiment (§3).

The counterpart of ``repro.gp.laplace``: Newton's method on
Ψ(f) = log p(y|f) − ½ fᵀK⁻¹f, where each Newton step solves the SPD system

    A⁽ⁱ⁾ = I + H½ K H½,       b⁽ⁱ⁾ = H½ K (H f + ∇ log p(y|f)),

by ``cholesky``, ``cg``, ``defcg`` (a :class:`RecycleManager` carrying the
deflation basis across Newton steps) or the ``spec`` front door.  This
slice runs the paper's own setup: K materialized once and applied as a
dense ``K @ v`` (``dense_matvec=True``); the matrix-free path comes with
the RBF matvec kernel.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import KernelSystemOperator, RecycleManager, SolveSpec
from repro_torch.core.api import solve
from repro_torch.core.solvers import cg, cholesky_solve
from repro_torch.gp.kernels import RBFKernel


def logistic_quantities(f: torch.Tensor, y: torch.Tensor):
    """Returns (log p(y|f), ∇ log p, H diag) for the logistic likelihood."""
    pi = torch.sigmoid(f)
    logp = torch.sum(F.logsigmoid(y * f))
    grad = (y + 1.0) / 2.0 - pi
    hdiag = pi * (1.0 - pi)
    return logp, grad, hdiag


@dataclasses.dataclass
class NewtonTrace:
    """Per-Newton-iteration record (the columns of paper Table 1)."""

    logp: List[float] = dataclasses.field(default_factory=list)
    psi: List[float] = dataclasses.field(default_factory=list)
    solver_iterations: List[int] = dataclasses.field(default_factory=list)
    solver_matvecs: List[int] = dataclasses.field(default_factory=list)
    cumulative_time: List[float] = dataclasses.field(default_factory=list)
    residual_traces: List = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class LaplaceResult:
    f: torch.Tensor
    psi: float
    logp: float
    trace: NewtonTrace
    converged: bool


def laplace_gpc(
    x: torch.Tensor,
    y: torch.Tensor,
    kernel: RBFKernel,
    *,
    solver: str = "defcg",
    solver_tol: float = 1e-5,
    solver_maxiter: int = 2000,
    recycle: Optional[RecycleManager] = None,
    spec: Optional[SolveSpec] = None,
    newton_tol: float = 1.0,
    max_newton: int = 30,
    record_residuals: bool = False,
    k_dense: Optional[torch.Tensor] = None,
    dense_matvec: bool = False,
) -> LaplaceResult:
    """Find the Laplace mode f̂ of GP classification by Newton's method.

    Args:
      solver: "cholesky" | "cg" | "defcg" (ignored when ``spec`` given).
      recycle: RecycleManager for solver="defcg" (created if None).
      spec: a :class:`SolveSpec` with ``precond="none"``: every Newton
        system goes through :func:`repro_torch.core.solve` with a
        :class:`RecycleState` carried across iterations.
      newton_tol: stop when ΔΨ < newton_tol.
      k_dense: pre-materialized K (built here, on ``x``'s device, if
        absent).
      dense_matvec: must be True in this slice — the iterative solvers
        apply K as a dense ``K @ v``.

    Solver time in the trace is host wall time around each solve, ended
    by a device synchronize on CUDA.
    """
    if not dense_matvec:
        raise NotImplementedError("matrix-free RBF matvec: ROADMAP K3")
    n = x.shape[0]
    f = torch.zeros(n, dtype=x.dtype, device=x.device)
    if spec is not None:
        if spec.precond != "none":
            raise NotImplementedError(
                "laplace_gpc with a preconditioned spec is not ported yet: "
                "ROADMAP queue 1 item 8"
            )
        solver = "spec"
    if k_dense is None:
        k_dense = kernel.gram(x)

    def k_mv(v):
        return k_dense @ v

    if solver == "defcg" and recycle is None:
        recycle = RecycleManager(k=8, ell=12, tol=solver_tol, maxiter=solver_maxiter)
    solve_state = None

    trace = NewtonTrace()
    psi_prev = float("-inf")
    x_prev = None
    solve_time = 0.0
    converged = False

    for _ in range(max_newton):
        logp, grad, hdiag = logistic_quantities(f, y)
        sqrt_h = torch.sqrt(hdiag)
        bg = hdiag * f + grad
        b = sqrt_h * k_mv(bg)

        t0 = time.perf_counter()
        if solver == "cholesky":
            # A = I + H½ K H½ in ONE (n, n) buffer, freed after the solve.
            amat = k_dense * sqrt_h[:, None]
            amat.mul_(sqrt_h[None, :])
            amat.diagonal().add_(1.0)
            xsol = cholesky_solve(amat, b)
            del amat
            info = None
        else:
            a_op = KernelSystemOperator(k_mv, sqrt_h)
            if solver == "spec":
                res = solve(
                    a_op, b, spec, solve_state, x0=x_prev,
                    record_residuals=record_residuals,
                )
                solve_state = res.state
            elif solver == "cg":
                res = cg(
                    a_op, b, x_prev,
                    tol=solver_tol, maxiter=solver_maxiter,
                    record_residuals=record_residuals,
                )
            elif solver == "defcg":
                res = recycle.solve(
                    a_op, b, x_prev,
                    tol=solver_tol, maxiter=solver_maxiter,
                    record_residuals=record_residuals,
                )
            else:
                raise ValueError(f"unknown solver={solver!r}")
            xsol, info = res.x, res.info
        if xsol.is_cuda:
            torch.cuda.synchronize(xsol.device)
        solve_time += time.perf_counter() - t0

        a_vec = bg - sqrt_h * xsol
        f = k_mv(a_vec)
        x_prev = xsol

        logp_new, _, _ = logistic_quantities(f, y)
        psi = float(logp_new - 0.5 * torch.dot(a_vec, f))

        trace.logp.append(float(logp_new))
        trace.psi.append(psi)
        trace.cumulative_time.append(solve_time)
        if info is not None:
            trace.solver_iterations.append(int(info.iterations))
            trace.solver_matvecs.append(int(info.matvecs))
            if record_residuals and info.residual_norms is not None:
                trace.residual_traces.append(info.residual_norms)
        else:
            trace.solver_iterations.append(n)  # direct solve ≙ full rank
            trace.solver_matvecs.append(0)

        if abs(psi - psi_prev) < newton_tol:
            converged = True
            break
        psi_prev = psi

    logp_final, _, _ = logistic_quantities(f, y)
    return LaplaceResult(
        f=f, psi=psi, logp=float(logp_final), trace=trace, converged=converged,
    )


def predict_latent(
    x_train: torch.Tensor,
    y_train: torch.Tensor,
    f_hat: torch.Tensor,
    x_test: torch.Tensor,
    kernel: RBFKernel,
) -> torch.Tensor:
    """Posterior-mean latent at test points: k(X*, X) ∇log p(y|f̂)."""
    _, grad, _ = logistic_quantities(f_hat, y_train)
    return kernel.cross(x_test, x_train) @ grad
