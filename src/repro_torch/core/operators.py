"""Symmetric positive-definite linear operators on flat tensors.

The solvers touch ``A`` only through ``A @ v``.  This slice ports a
callable wrapper, a dense matrix, and the paper's Newton-system operator
``A = I + H½ K H½``, both over any ``K`` product and over the matrix-free
RBF Gram kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.kernels import ops as kops

Matvec = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class LinearOperator:
    """A symmetric linear operator ``v ↦ A v``.

    Attributes:
      matvec: the matvec closure on ``(n,)`` tensors.
      matvec_cost_flops: optional estimate of flops per matvec.
      matmat: optional multi-RHS closure ``V ↦ A V`` over column-stacked
        ``(n, r)`` tensors; :func:`apply_to_basis` then refreshes a whole
        basis in one operator application.
    """

    matvec: Matvec
    matvec_cost_flops: Optional[float] = None
    matmat: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.matvec(v)

    def __matmul__(self, v: torch.Tensor) -> torch.Tensor:
        return self.matvec(v)

    def basis_matvec(self, basis: torch.Tensor) -> torch.Tensor:
        """``A`` on every row of an ``(m, n)`` basis."""
        if self.matmat is not None:
            return self.matmat(basis.T).T
        return torch.stack([self.matvec(v) for v in basis])


class DenseMatrixOperator(LinearOperator):
    """An explicit ``(n, n)`` matrix as an operator."""

    def __init__(self, mat: torch.Tensor):
        self.mat = mat
        n = mat.shape[-1]

        def mv(v):
            return mat @ v

        super().__init__(mv, matvec_cost_flops=2.0 * n * n, matmat=mv)


def from_matrix(mat: torch.Tensor) -> DenseMatrixOperator:
    """Explicit dense SPD matrix as an operator over flat ``(n,)`` vectors."""
    return DenseMatrixOperator(mat)


def from_callable(fn: Matvec, cost: Optional[float] = None) -> LinearOperator:
    return LinearOperator(fn, cost)


def apply_to_basis(op, basis: torch.Tensor) -> torch.Tensor:
    """``A`` on an ``(m, n)`` basis as ONE multi-RHS application where the
    operator offers ``basis_matvec``; a row-by-row sweep otherwise."""
    bm = getattr(op, "basis_matvec", None)
    if bm is not None:
        return bm(basis)
    return torch.stack([op(v) for v in basis])


@dataclasses.dataclass
class KernelSystemOperator:
    """``A v = v + H½ · K (H½ · v)`` — the Kuss–Rasmussen Newton system.

    ``kernel_matvec`` computes ``K u`` for ``(n,)`` and column-stacked
    ``(n, r)`` inputs (a dense ``K @ V`` does both); ``sqrt_h`` is the
    diagonal of ``H½``.
    """

    kernel_matvec: Matvec
    sqrt_h: torch.Tensor
    matvec_cost_flops: Optional[float] = None

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        return v + self.sqrt_h * self.kernel_matvec(self.sqrt_h * v)

    def basis_matvec(self, basis: torch.Tensor) -> torch.Tensor:
        """``A`` on an ``(m, n)`` basis — one multi-RHS kernel product."""
        v = (basis * self.sqrt_h[None, :]).T  # (n, m) column-stacked
        return basis + self.sqrt_h[None, :] * self.kernel_matvec(v).T

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.matvec(v)

    def __matmul__(self, v: torch.Tensor) -> torch.Tensor:
        return self.matvec(v)


class RBFKernelSystemOperator(KernelSystemOperator):
    """``A v = v + H½ · K(X, X) (H½ · v)`` with ``K`` never formed.

    :class:`KernelSystemOperator` over the RBF Gram kernel, holding its
    data (``x``, ``sqrt_h``) and hyperparameters as attributes: every
    product is one call of the fused Gram matvec
    (:func:`repro_torch.kernels.ops.rbf_matvec`, the K3 kernel on the
    card), so :meth:`basis_matvec` refreshes a whole ``(m, n)`` basis in
    one multi-RHS call.
    """

    def __init__(
        self,
        x: torch.Tensor,  # (n, d) training inputs
        sqrt_h: torch.Tensor,  # (n,) H½ diagonal
        theta: float = 1.0,
        lengthscale: float = 1.0,
        block: int = 1024,
        backend: str = "auto",
    ):
        self.x, self.theta, self.lengthscale = x, theta, lengthscale
        self.block, self.backend = block, backend
        super().__init__(self._rbf_matvec, sqrt_h)

    def _rbf_matvec(self, u: torch.Tensor) -> torch.Tensor:
        """``K(X, X) @ u`` — (n,) or column-stacked (n, r)."""
        return kops.rbf_matvec(
            self.x, u, self.theta, self.lengthscale,
            backend=self.backend, block=self.block,
        )
