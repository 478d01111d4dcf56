"""Preconditioners and a-priori low-rank subspaces.

The counterpart of ``repro.core.preconditioners`` on flat tensors:

* :func:`jacobi` — diagonal preconditioning (given the diagonal);
* :func:`randomized_nystrom` — a randomized Nyström eigensketch of an SPD
  operator (sketch → Gram–Schmidt → Rayleigh–Ritz), usable as the
  preconditioner of :func:`nystrom_preconditioner`, or, sketched on the
  kernel ``K`` of the GP Newton family, rebound to each system's ``H½`` by
  :func:`kernel_nystrom_preconditioner`.

Every preconditioner is a plain object with ``__call__(r) -> M⁻¹ r``; the
reference's pytree registration has no counterpart the port needs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import engine
from repro_torch.core import operators as ops_mod
from repro_torch.core import pytree as pt


@dataclasses.dataclass(eq=False)
class JacobiPreconditioner:
    """``M⁻¹ r = r / diag`` (elementwise)."""

    diag: torch.Tensor

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return r / self.diag


@dataclasses.dataclass(eq=False)
class NystromPreconditioner:
    """``M⁻¹`` from a rank-r Nyström eigensketch ``(U, Λ)`` of ``A``:

        M⁻¹ r = r + Uᵀ ((λ_min+σ)/(Λ+σ) − 1) U r

    (Frangella et al. form; the unsketched bulk is treated as
    ≈ (λ_min+σ) I).  ``U`` is ``(rank, n)`` in descending eigenvalue order,
    as :func:`randomized_nystrom` returns it.
    """

    U: torch.Tensor
    lam: torch.Tensor
    sigma: torch.Tensor

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        lam_min = self.lam[-1]
        c = pt.basis_dot(self.U, r)
        scale = (lam_min + self.sigma) / (self.lam + self.sigma) - 1.0
        return r + pt.basis_combine(self.U, scale * c)


@dataclasses.dataclass(eq=False)
class WoodburyKernelPreconditioner:
    """``M⁻¹`` for the Newton-system family ``A_i = I + H½ᵢ K H½ᵢ``.

    With a sketch ``K ≈ Uᵀ Λ U`` of the invariant kernel (made once), each
    system takes ``M = I + H½ Uᵀ Λ U H½`` and, by Woodbury,

        M⁻¹ r = r − H½ Uᵀ C⁻¹ U H½ r,      C = Λ⁻¹ + U H Uᵀ,

    so the preconditioner tracks the drifting ``H`` at the cost of one
    r × r Cholesky per system and no operator products.  Built by
    :func:`kernel_nystrom_preconditioner`.
    """

    sqrt_h: torch.Tensor  # (n,)
    U: torch.Tensor  # (rank, n) sketch basis of K
    chol_c: torch.Tensor  # lower Cholesky factor of C

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        t = self.U @ (self.sqrt_h * r)
        s = torch.cholesky_solve(t[:, None], self.chol_c)[:, 0]
        return r - self.sqrt_h * (s @ self.U)


def kernel_nystrom_preconditioner(
    U: torch.Tensor, lam: torch.Tensor, sqrt_h: torch.Tensor
) -> WoodburyKernelPreconditioner:
    """Bind a Nyström sketch ``(U, lam)`` of ``K`` (not of ``A``) to one
    system's ``H½``.  Non-positive Ritz values are clipped to a floor:
    their ``Λ⁻¹`` diverges, which Woodbury turns into a no-op for that
    direction."""
    lam_floor = 1e-12 * torch.clamp(torch.max(lam), min=1.0)
    lam_safe = torch.maximum(lam, lam_floor)
    uhu = (U * (sqrt_h * sqrt_h)[None, :]) @ U.T
    C = torch.diag(1.0 / lam_safe) + uhu
    C = 0.5 * (C + C.T)
    return WoodburyKernelPreconditioner(sqrt_h, U, torch.linalg.cholesky(C))


def jacobi(diag: torch.Tensor) -> JacobiPreconditioner:
    """``M⁻¹ r = r / diag`` (elementwise)."""
    return JacobiPreconditioner(diag)


def randomized_nystrom(
    A,
    template: torch.Tensor,
    rank: int,
    generator: Optional[torch.Generator] = None,
    *,
    oversample: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Randomized Nyström/Rayleigh–Ritz eigensketch of an SPD operator.

    Sketch ``Y = A Ω`` with ``rank + oversample`` Gaussian probes drawn
    from ``generator`` (on the generator's device, then moved to
    ``template``'s: a CPU generator gives the same probes on every
    device), orthonormalize by modified Gram–Schmidt, Rayleigh–Ritz on
    ``QᵀAQ``, and keep the top ``rank`` pairs.  ``A`` is applied to all
    probes, and then to ``Q``, as one multi-RHS application each where
    the operator offers it; the cost charged, as in the reference, is
    ``rank + oversample`` matvecs.

    Returns ``(U, lam)``: ``(rank, n)`` approximate eigenvectors in
    descending eigenvalue order and their Ritz values.
    """
    m = rank + oversample
    n = template.shape[0]
    gen_device = generator.device if generator is not None else "cpu"
    probes = torch.randn(
        (m, n), generator=generator, dtype=template.dtype, device=gen_device
    ).to(template.device)

    ys = ops_mod.apply_to_basis(A, probes)
    qs = []
    for y in ys:
        for q in qs:
            y = y - pt.tree_dot(q, y) * q
        y = y / torch.clamp(pt.tree_norm(y), min=1e-30)
        qs.append(y)
    Q = torch.stack(qs)

    AQ = ops_mod.apply_to_basis(A, Q)
    T = pt.gram(Q, AQ)
    T = 0.5 * (T + T.T)
    lam, V = torch.linalg.eigh(T)  # ascending
    order = torch.argsort(lam).flip(0)[:rank]
    U = V[:, order].T.to(Q.dtype) @ Q
    return U, lam[order]


def nystrom_preconditioner(
    U: torch.Tensor, lam: torch.Tensor, sigma: float
) -> NystromPreconditioner:
    """``M⁻¹`` from a Nyström sketch, for ``A ≈ Uᵀ Λ U + σ-bulk``
    (see :class:`NystromPreconditioner`)."""
    return NystromPreconditioner(
        U, lam, torch.as_tensor(sigma, dtype=lam.dtype, device=lam.device)
    )


class LanePreconditioner:
    """B tenants' preconditioners on ``(B, n)`` stacks, tenant by tenant."""

    def __init__(self, applies):
        self.applies = list(applies)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return torch.stack([m(r[i]) for i, m in enumerate(self.applies)])


def lane_preconditioner(applies):
    """The batched apply of B tenants' ``M`` applies: one elementwise
    division for Jacobi tenants, tenant by tenant otherwise."""
    if all(isinstance(m, JacobiPreconditioner) for m in applies):
        return JacobiPreconditioner(torch.stack([m.diag for m in applies]))
    return LanePreconditioner(applies)


# The preconditioners as loop inputs of a compiled program: every field a
# child (engine.register_node; see repro_torch.core.operators).
engine.register_node(JacobiPreconditioner, lambda m: ((m.diag,), ()),
                     lambda _, ch: JacobiPreconditioner(*ch))
engine.register_node(NystromPreconditioner, lambda m: ((m.U, m.lam, m.sigma), ()),
                     lambda _, ch: NystromPreconditioner(*ch))
engine.register_node(WoodburyKernelPreconditioner, lambda m: ((m.sqrt_h, m.U, m.chol_c), ()),
                     lambda _, ch: WoodburyKernelPreconditioner(*ch))
engine.register_node(LanePreconditioner, lambda m: ((m.applies,), ()),
                     lambda _, ch: LanePreconditioner(*ch))
