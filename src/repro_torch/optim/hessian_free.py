"""Hessian-free (Gauss-Newton) optimizer with Krylov subspace recycling.

The counterpart of ``repro.optim.hessian_free``.  Every outer step solves
the damped GGN system ``(Jᵀ H_L J + λ I) δ = −∇L`` with def-CG(k, ell)
(``HFConfig(solver="ggn")``), or the damped least-squares problem
``min_δ ‖J δ + r‖² + λ‖δ‖²`` with (def)LSMR on the Jacobian itself
(``solver="gauss_newton"``), and carries the recycled basis from step to
step in the optimizer state: the paper's sequence of related systems, one
per training step.  Damping follows the Levenberg-Marquardt
reduction-ratio rule.

Parameters are a tensor or a dict of tensors; the solvers see them flat,
in :func:`repro_torch.core.pytree.ravel` order (dict keys sorted, as JAX
ravels them), so a basis carried from the reference lines up.  The LM
damping is a float32 0-d tensor whatever the parameters' dtype, as in the
reference, and promotes the same way where it meets them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import pytree as pt
from repro_torch.core.api import SolveSpec, solve
from repro_torch.core.operators import GaussNewtonOperator, GGNOperator, LinearOperator
from repro_torch.core.recycle import RecycleState, random_orthonormal_basis
from repro_torch.core.solvers import defcg
from repro_torch.core.strategies import HarmonicRitz, RecycleStrategy


@dataclasses.dataclass(frozen=True)
class HFConfig:
    k: int = 8  # recycled subspace size — def-CG(k, ell)
    ell: int = 12  # stored Krylov directions
    cg_tol: float = 1e-4
    cg_maxiter: int = 50
    lr: float = 1.0
    init_damping: float = 1.0
    min_damping: float = 1e-6
    max_damping: float = 1e6
    recycle: bool = True  # False: plain CG/LSMR baseline
    # "ggn": damped normal-equations system, GGNOperator + (def-)CG.
    # "gauss_newton": min ‖Jδ + r‖² + λ‖δ‖², GaussNewtonOperator + (def)LSMR;
    # needs hf_step(residual_fn=...).
    solver: str = "ggn"
    strategy: RecycleStrategy = HarmonicRitz()

    def __post_init__(self):
        if self.solver not in ("ggn", "gauss_newton"):
            raise ValueError(
                f"HFConfig.solver must be 'ggn' or 'gauss_newton', got {self.solver!r}"
            )

    def solve_spec(self) -> SolveSpec:
        """The inner solver's configuration as the shared SolveSpec."""
        if self.solver == "gauss_newton":
            # lsq_shift = 1: the LM damping is folded into the operator
            # (J/√λ), so the spec's shift stays fixed.
            return SolveSpec(
                method="deflsmr" if self.recycle else "lsmr",
                k=self.k,
                ell=self.ell if self.recycle else 0,
                tol=self.cg_tol,
                maxiter=self.cg_maxiter,
                lsq_shift=1.0,
            )
        return SolveSpec(
            method="defcg",
            k=self.k,
            ell=self.ell if self.recycle else 0,
            tol=self.cg_tol,
            maxiter=self.cg_maxiter,
            strategy=self.strategy,
        )


class HFState(NamedTuple):
    recycle: RecycleState  # recycled deflation state (flat (k, n) basis)
    delta_prev: Any  # previous step direction, shaped like params (warm start)
    damping: torch.Tensor  # f32 0-d
    step: torch.Tensor  # int32 0-d
    last_cg_iters: torch.Tensor  # int32 0-d


def hf_init(params: Any, cfg: HFConfig, generator: torch.Generator) -> HFState:
    """A fresh state: a random orthonormal basis from ``generator`` (a
    valid, merely unhelpful deflation space; its ``AW`` placeholder is
    zeros, which the exact per-step refresh overwrites before use)."""
    flat = pt.ravel(params)
    w = random_orthonormal_basis(generator, flat, cfg.k)
    device = flat.device
    return HFState(
        recycle=RecycleState(
            W=w,
            AW=torch.zeros_like(w),
            theta=torch.zeros((cfg.k,), dtype=w.dtype, device=device),
            systems_solved=torch.zeros((), dtype=torch.int32, device=device),
            drift=torch.zeros((), dtype=w.dtype, device=device),
        ),
        delta_prev=pt.ravel_vector(params)[1](torch.zeros_like(flat)),
        damping=torch.tensor(cfg.init_damping, dtype=torch.float32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
        last_cg_iters=torch.zeros((), dtype=torch.int32, device=device),
    )


def softmax_xent_hvp(logits: torch.Tensor, tangent: torch.Tensor) -> torch.Tensor:
    """Gauss-Newton Hessian of mean softmax cross-entropy wrt logits,
    ``(diag(p) − p pᵀ)/N`` applied to a tangent, in f32 as the reference."""
    p = torch.softmax(logits.to(torch.float32), dim=-1)
    tf = tangent.to(torch.float32)
    inner = torch.sum(p * tf, dim=-1, keepdim=True)
    n = logits.numel() // logits.shape[-1]
    return (p * (tf - inner) / n).to(tangent.dtype)


def squared_loss_hvp(outputs: torch.Tensor, tangent: torch.Tensor) -> torch.Tensor:
    return 2.0 * tangent / outputs.numel()


def hf_step(
    params: Any,
    state: HFState,
    batch: Any,
    *,
    model_fn: Optional[Callable[[Any, Any], torch.Tensor]] = None,
    loss_fn: Optional[Callable[[torch.Tensor, Any], torch.Tensor]] = None,
    loss_hvp: Callable = softmax_xent_hvp,
    residual_fn: Optional[Callable[[Any, Any], torch.Tensor]] = None,
    cfg: HFConfig = HFConfig(),
) -> Tuple[Any, HFState, dict]:
    """One Hessian-free step.  ``model_fn(params, batch) -> outputs`` and
    ``loss_fn(outputs, batch) -> scalar`` for ``cfg.solver == "ggn"``;
    ``residual_fn(params, batch) -> residuals`` (loss ``½‖r‖²``) for
    ``"gauss_newton"``.  Returns ``(params, state, metrics)``; metrics are
    0-d tensors on the parameters' device."""
    p_flat, unravel = pt.ravel_vector(params)
    x0 = pt.ravel(state.delta_prev)
    if cfg.solver == "gauss_newton":
        if residual_fn is None:
            raise ValueError("HFConfig(solver='gauss_newton') needs hf_step(residual_fn=...)")
        gn = GaussNewtonOperator(residual_fn=lambda p: residual_fn(p, batch), params=params)

        def total_loss(p):
            rr = pt.ravel(residual_fn(p, batch))
            return 0.5 * torch.dot(rr, rr)

        r = gn.residuals()
        loss = 0.5 * torch.dot(r, r)
        grads = gn.rmatvec(r)
        # Fold the damping into the operator: LSMR on (J/√λ, −r/√λ) with
        # unit shift minimizes λ⁻¹(‖Jδ + r‖² + λ‖δ‖²), the same δ.
        s = torch.rsqrt(state.damping.to(r.dtype))
        op = LinearOperator(
            matvec=lambda v: s * gn.matvec(v),
            rmatvec=lambda u: s * gn.rmatvec(u),
        )
        res = solve(op, -s * r, cfg.solve_spec(),
                    state.recycle if cfg.recycle else None, x0=x0)
        delta, info = res.x, res.info
        recycle_next = res.state if cfg.recycle else state.recycle
        jdelta = gn.matvec(delta)
        curvature = torch.dot(jdelta, jdelta) + state.damping * torch.dot(delta, delta)
    else:
        if model_fn is None or loss_fn is None:
            raise ValueError("HFConfig(solver='ggn') needs hf_step(model_fn=..., loss_fn=...)")

        def total_loss(p):
            return loss_fn(model_fn(p, batch), batch)

        grads_tree, loss = torch.func.grad_and_value(total_loss)(params)
        grads = pt.ravel(grads_tree)
        op = GGNOperator(
            model_fn=lambda p: model_fn(p, batch),
            loss_hvp=loss_hvp,
            params=params,
            damping=state.damping,
        )
        if cfg.recycle:
            res = solve(op, -1.0 * grads, cfg.solve_spec(), state.recycle, x0=x0)
            delta, info, recycle_next = res.x, res.info, res.state
        else:
            result = defcg(op, -1.0 * grads, x0, ell=0, tol=cfg.cg_tol, maxiter=cfg.cg_maxiter)
            delta, info, recycle_next = result.x, result.info, state.recycle
        curvature = torch.dot(delta, op.matvec(delta))

    new_flat = p_flat + cfg.lr * delta
    new_loss = total_loss(unravel(new_flat))
    # Levenberg-Marquardt damping from the reduction ratio ρ.
    quad_decrease = -(torch.dot(grads, delta) + 0.5 * curvature)
    rho = (loss - new_loss) / torch.clamp(quad_decrease, min=1e-30)
    damping = torch.where(rho > 0.75, state.damping * (2.0 / 3.0), state.damping)
    damping = torch.where(rho < 0.25, damping * 1.5, damping)
    damping = torch.clamp(damping, cfg.min_damping, cfg.max_damping)

    # Reject steps that increase the loss (keep params, keep basis).
    accept = new_loss < loss
    new_params = unravel(torch.where(accept, new_flat, p_flat))
    new_state = HFState(
        recycle=recycle_next,
        delta_prev=unravel(torch.where(accept, delta, 0.0)),
        damping=damping,
        step=state.step + 1,
        last_cg_iters=info.iterations,
    )
    metrics = {
        "loss": loss,
        "new_loss": new_loss,
        "rho": rho,
        "damping": damping,
        "cg_iterations": info.iterations,
        "cg_matvecs": info.matvecs,
        "cg_residual": info.residual_norm,
        "accepted": accept,
    }
    return new_params, new_state, metrics
