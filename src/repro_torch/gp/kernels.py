"""GP kernel functions and the matrix-free Gram operator (the counterpart
of ``repro.gp.kernels``)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


@dataclasses.dataclass(frozen=True)
class RBFKernel:
    """Gaussian/RBF kernel  k(x, x') = θ² exp(−‖x−x'‖² / 2λ²)  (paper §3)."""

    theta: float = 1.0
    lengthscale: float = 1.0

    def gram(self, x: torch.Tensor) -> torch.Tensor:
        """Materialized K(X, X), built where ``x`` lives."""
        return kref.rbf_gram(x, self.theta, self.lengthscale)

    def cross(self, xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
        d2 = (
            torch.sum(xa * xa, 1)[:, None]
            + torch.sum(xb * xb, 1)[None, :]
            - 2.0 * (xa @ xb.T)
        )
        return (self.theta**2) * torch.exp(
            -0.5 * torch.clamp(d2, min=0.0) / self.lengthscale**2
        )

    def matvec_fn(
        self, x: torch.Tensor, *, backend: str = "auto", block: int = 1024
    ) -> Callable[[torch.Tensor], torch.Tensor]:
        """Matrix-free ``v ↦ K v`` over the fused kernel (K never built);
        ``v`` may be (n,) or column-stacked (n, r)."""

        def mv(v: torch.Tensor) -> torch.Tensor:
            return kops.rbf_matvec(
                x, v, self.theta, self.lengthscale, backend=backend, block=block
            )

        return mv

    def matvec_cost_flops(self, n: int, d: int) -> float:
        """Flops of one fused Gram matvec (distance matmul dominates)."""
        return 2.0 * n * n * d + 6.0 * n * n
