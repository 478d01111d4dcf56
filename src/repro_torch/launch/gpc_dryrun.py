"""The GPC (paper-workload) dry-run cell: one def-CG iteration at n = 2²⁰.

The paper's own system at scale: GP-classification Newton systems
``A = I + H½KH½`` with n = 1M data points, ``K = exp(−½‖xᵢ − xⱼ‖²)`` over
pre-scaled inputs (θ = λ = 1), never formed.  The Gram matvec is K3
(:func:`repro_torch.kernels.ops.rbf_matvec`, the whole product: every row,
with no row block left out); the deflation GEMVs and AXPYs are plain torch
ops, as in the reference.  On one card (``mesh=None``) X is whole
(1M × 784 f32 ≈ 3.29 GB).  Over a :class:`~repro_torch.launch.mesh.SolveMesh`
the vectors are row-sharded across the ranks and X stays whole on each
(the reference's replicated X, its §Perf choice; gathering X each matvec,
its baseline, is not ported): each rank computes its rows of ``K·v``
against the whole X (K8, ``rbf_matvec_rect``) after one ``all_gather`` of
v, and the iteration's inner products become two all-reduces (``pᵀAp``;
``rᵀr`` with ``AW·r`` in one) — the reference's ``shard_map`` pattern,
counted in ``launch.mesh.COLLECTIVES``.

def-CG's loop has a data-dependent trip count, so the cell is ONE
iteration (matvec + deflation GEMVs + AXPYs); the roofline scales it by the
measured iteration counts.  Invoked from :mod:`repro_torch.launch.dryrun`
as ``--arch gpc-mnist``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.gpc_mnist import GPCConfig
from repro_torch.kernels import ops as kops
from repro_torch.launch import trace_stats


def make_defcg_iteration(cfg: GPCConfig, mesh=None, backend: str = "auto"):
    """One def-CG(k) iteration: Ap, α, x / r updates, the μ-solve, the p
    update.  ``state = (x, r, p, rs, W, AW, waw_inv)``; with ``mesh`` every
    vector and basis is this rank's block of rows (columns of W and AW).
    ``backend`` is the kernels' (``kernels.ops``)."""

    def gram_matvec(x_data, v):
        if mesh is None:
            return kops.rbf_matvec(x_data, v, 1.0, 1.0, backend=backend, block=cfg.block)
        x_local = x_data[mesh.block(x_data.shape[0])]
        return kops.rbf_matvec_rect(x_local, x_data, mesh.all_gather(v), 1.0, 1.0,
                                    backend=backend, block=cfg.block)

    def summed(t):
        return t if mesh is None else mesh.all_reduce(t)

    def a_matvec(x_data, sqrt_h, v):
        return v + sqrt_h * gram_matvec(x_data, sqrt_h * v)

    def defcg_iteration(x_data, sqrt_h, state):
        xv, r, p, rs, W, AW, waw_inv = state
        ap = a_matvec(x_data, sqrt_h, p)
        d = summed(torch.dot(p, ap))
        alpha = rs / d
        xv = xv + alpha * p
        r = r - alpha * ap
        sums = summed(torch.cat([torch.dot(r, r)[None], AW @ r]))
        rs_new = sums[0]
        beta = rs_new / rs
        mu = waw_inv @ sums[1:]  # AW·r, the deflation GEMV, then the k × k solve
        p = beta * p + r - W.T @ mu
        return (xv, r, p, rs_new, W, AW, waw_inv)

    return defcg_iteration


def input_specs(cfg: GPCConfig, device="meta", ranks: int = 1):
    """``(x_data, sqrt_h, state)`` of one card, or of one of ``ranks``
    ranks (its rows of every vector and basis, X whole), as empty tensors
    on ``device``."""
    n, d, k = cfg.n // ranks, cfg.d, cfg.k
    dtype = torch.float32 if cfg.dtype == "float32" else torch.float64

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    state = (empty(n), empty(n), empty(n), empty(), empty(k, n), empty(k, n), empty(k, k))
    return empty(cfg.n, d), empty(n), state


def model_flops(cfg: GPCConfig) -> float:
    """Useful flops of one def-CG iteration: the Gram matvec."""
    return 2.0 * cfg.n * cfg.n * cfg.d + 6.0 * cfg.n * cfg.n


def trace_cell(cfg: GPCConfig, mesh=None) -> dict:
    """The counts of one iteration on one card, or on one rank of ``mesh``
    (a :class:`~repro_torch.launch.mesh.SolveMesh`, e.g. over a fake
    process group), traced on the meta device
    (:func:`repro_torch.launch.trace_stats.trace`), its inputs held."""
    ranks = 1 if mesh is None else mesh.size
    _, counts = trace_stats.trace(make_defcg_iteration(cfg, mesh),
                                  *input_specs(cfg, ranks=ranks))
    return counts
