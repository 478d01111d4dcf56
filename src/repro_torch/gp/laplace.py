"""Laplace-approximation GP classification — the paper's experiment (§3).

The counterpart of ``repro.gp.laplace``: Newton's method on
Ψ(f) = log p(y|f) − ½ fᵀK⁻¹f, where each Newton step solves the SPD system

    A⁽ⁱ⁾ = I + H½ K H½,       b⁽ⁱ⁾ = H½ K (H f + ∇ log p(y|f)),

by ``cholesky``, ``cg``, ``defcg`` (a :class:`RecycleManager` carrying the
deflation basis across Newton steps) or the ``spec`` front door, which
also preconditions (``spec.precond`` = ``"jacobi"`` or ``"nystrom"``).
As in the reference, the iterative solves go through the compiled doors
(``cg_jit``, ``solve_jit``, the manager's ``defcg_jit``): on the card the
first Newton system captures each loop, the later ones replay it.
``K`` is applied either as the paper's dense ``K @ v`` over a materialized
K (``dense_matvec=True``) or matrix-free through the fused RBF Gram
matvec (the default; K is never formed).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import (
    KernelSystemOperator,
    RBFKernelSystemOperator,
    RecycleManager,
    SolveSpec,
)
from repro_torch.core.api import solve_jit
from repro_torch.core.operators import LinearOperator
from repro_torch.core.preconditioners import (
    jacobi,
    kernel_nystrom_preconditioner,
    randomized_nystrom,
)
from repro_torch.core.solvers import cg_jit, cholesky_solve
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
    precond_generator: Optional[torch.Generator] = None,
    newton_tol: float = 1.0,
    max_newton: int = 30,
    backend: str = "auto",
    block: int = 1024,
    record_residuals: bool = False,
    k_dense: Optional[torch.Tensor] = None,
    dense_matvec: bool = False,
) -> LaplaceResult:
    """Find the Laplace mode f̂ of GP classification by Newton's method.

    Args:
      solver: "cholesky" | "cg" | "defcg" (ignored when ``spec`` given).
      recycle: RecycleManager for solver="defcg" (created if None).
      spec: a :class:`SolveSpec`: every Newton system goes through
        :func:`repro_torch.core.solve` with a :class:`RecycleState` carried
        across iterations and the spec's preconditioner.
        ``precond="jacobi"`` uses ``diag(A) = 1 + h·k(x, x)`` per system;
        ``precond="nystrom"`` sketches the invariant kernel ``K ≈ UᵀΛU``
        once (``precond_rank + 8`` kernel matvecs, charged to the first
        system) and rebinds it to each system's ``H½`` by a rank-r
        Woodbury solve.  ``"custom"`` is refused: drive
        :func:`repro_torch.core.solve` directly for a custom ``M``.
      precond_generator: the :class:`torch.Generator` of the Nyström
        sketch's probes (a CPU generator seeded 0 if absent).
      newton_tol: stop when ΔΨ < newton_tol.
      backend, block: the fused Gram matvec's kernel selector and the
        plain version's row block (:func:`repro_torch.kernels.ops.rbf_matvec`).
      k_dense: pre-materialized K.  The Cholesky path needs it (built here
        if absent); with ``dense_matvec=True`` the iterative solvers apply
        it as a dense ``K @ v`` (the paper's own setup), otherwise they
        use the fused matrix-free Gram matvec and K is never formed.

    Solver time in the trace is host wall time around each solve, ended
    by a device synchronize on CUDA.
    """
    n = x.shape[0]
    f = torch.zeros(n, dtype=x.dtype, device=x.device)
    if spec is not None:
        if spec.precond == "custom":
            raise ValueError(
                "laplace_gpc builds the preconditioner itself and has no M "
                "parameter — use spec.precond='jacobi'/'nystrom'/'none', or "
                "drive repro_torch.core.solve directly for a custom M"
            )
        solver = "spec"
    if (solver == "cholesky" or dense_matvec) and k_dense is None:
        k_dense = kernel.gram(x)
    if dense_matvec:

        def k_mv(v):
            return k_dense @ v

    else:
        k_mv = kernel.matvec_fn(x, backend=backend, block=block)

    if solver == "defcg" and recycle is None:
        recycle = RecycleManager(k=8, ell=12, tol=solver_tol, maxiter=solver_maxiter)
    solve_state = None
    k_sketch = None  # once-per-call Nyström sketch (U, lam) of K
    sketch_matvecs = 0

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
            a_op = (
                KernelSystemOperator(k_mv, sqrt_h) if dense_matvec
                else RBFKernelSystemOperator(
                    x, sqrt_h, kernel.theta, kernel.lengthscale,
                    block=block, backend=backend,
                )
            )
            if solver == "spec":
                M = None
                if spec.precond == "jacobi":
                    # diag(A) = 1 + h_i k(x_i, x_i), exact and host-free.
                    diag_k = (
                        torch.diagonal(k_dense) if dense_matvec
                        else torch.full((n,), kernel.theta**2, dtype=x.dtype,
                                        device=x.device)
                    )
                    M = jacobi(1.0 + hdiag * diag_k)
                elif spec.precond == "nystrom":
                    if k_sketch is None:
                        gen = (
                            precond_generator if precond_generator is not None
                            else torch.Generator().manual_seed(0)
                        )
                        # K on all rank + 8 probes as one multi-RHS call.
                        k_sketch = randomized_nystrom(
                            LinearOperator(k_mv, matmat=k_mv),
                            torch.zeros(n, dtype=x.dtype, device=x.device),
                            rank=spec.precond_rank, generator=gen,
                        )
                        sketch_matvecs = spec.precond_rank + 8
                    M = kernel_nystrom_preconditioner(
                        k_sketch[0], k_sketch[1], sqrt_h
                    )
                res = solve_jit(
                    a_op, b, spec, solve_state, x0=x_prev, M=M,
                    record_residuals=record_residuals,
                )
                solve_state = res.state
            elif solver == "cg":
                res = cg_jit(
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
            # The one-off Nyström sketch is charged to the system that
            # built it.
            trace.solver_matvecs.append(int(info.matvecs) + sketch_matvecs)
            sketch_matvecs = 0
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
