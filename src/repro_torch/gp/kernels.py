"""GP kernel functions (the counterpart of ``repro.gp.kernels``)."""

from __future__ import annotations

import dataclasses

import torch

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

    def matvec_fn(self, x: torch.Tensor, **_):
        """The matrix-free Gram matvec comes with the next slice."""
        raise NotImplementedError("matrix-free RBF matvec: ROADMAP K3")

    def matvec_cost_flops(self, n: int, d: int) -> float:
        return 2.0 * n * n * d + 6.0 * n * n
