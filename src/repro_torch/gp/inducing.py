"""Inducing-point / subset-of-data baseline (paper §3.1; the counterpart of
``repro.gp.inducing``).

The a-priori low-rank route the paper sets the recycled solvers against:
pick m ≪ n representer points X_m, run the full Laplace optimization on
the m-point subproblem (O(m³), Cholesky), and induce the remaining latents
through the conditional mean

    E[f_{n−m} | f_m] = K_{(n−m)m} K_mm⁻¹ f_m .

log p(y | f) is then evaluated with the induced latents over the FULL set:
the accuracy axis of paper Fig. 4; the cost axis is the subset solve's
wall time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.gp.kernels import RBFKernel
from repro_torch.gp.laplace import LaplaceResult, laplace_gpc, logistic_quantities


@dataclasses.dataclass
class InducingResult:
    logp_full: float  # log p(y|f) with induced latents on the full set
    subset_result: LaplaceResult
    m: int
    seconds: float


def subset_gpc(
    x: torch.Tensor,
    y: torch.Tensor,
    kernel: RBFKernel,
    m: int,
    *,
    generator: Optional[torch.Generator] = None,
    newton_tol: float = 1.0,
    max_newton: int = 30,
    jitter: float = 1e-6,
) -> InducingResult:
    """Randomly selected subset-of-data GPC (the paper's Fig. 4 baseline).

    The subset is the first ``m`` entries of a random permutation drawn by
    ``generator`` (a CPU :class:`torch.Generator`; seeded 0 when None)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    idx = torch.randperm(x.shape[0], generator=gen)[:m]
    return _subset_gpc_at(x, y, kernel, idx, newton_tol=newton_tol,
                         max_newton=max_newton, jitter=jitter)


def _subset_gpc_at(
    x: torch.Tensor,
    y: torch.Tensor,
    kernel: RBFKernel,
    idx,
    *,
    newton_tol: float = 1.0,
    max_newton: int = 30,
    jitter: float = 1e-6,
) -> InducingResult:
    """:func:`subset_gpc` on the given subset indices ``idx`` (``(m,)``
    integers): Cholesky Laplace on the subset, the conditional mean with
    ``jitter`` on ``K_mm``'s diagonal, the subset's own latents kept at
    its points, and ``logp_full`` over the full set."""
    idx = torch.as_tensor(idx, dtype=torch.int64, device=x.device)
    m = idx.shape[0]
    xm, ym = x[idx], y[idx]

    t0 = time.perf_counter()
    sub = laplace_gpc(xm, ym, kernel, solver="cholesky", newton_tol=newton_tol,
                      max_newton=max_newton)
    # Induce the full latent vector through the conditional mean.
    kmm = kernel.gram(xm) + jitter * torch.eye(m, dtype=x.dtype, device=x.device)
    alpha = torch.linalg.solve(kmm, sub.f)
    f_full = kernel.cross(x, xm) @ alpha
    f_full[idx] = sub.f  # the subset's own (exact) latents at its points
    if f_full.is_cuda:
        torch.cuda.synchronize(f_full.device)
    seconds = time.perf_counter() - t0

    logp_full, _, _ = logistic_quantities(f_full, y)
    return InducingResult(logp_full=float(logp_full), subset_result=sub, m=m,
                          seconds=seconds)
