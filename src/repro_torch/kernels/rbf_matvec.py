"""The matrix-free RBF Gram matvec on the H100: one hand-written CUDA kernel.

``rbf_matvec_cuda`` replaces ``rbf_matvec_pallas``
(``repro/kernels/rbf_matvec.py:77``): ``Y = θ² exp(−½‖xᵢ − xⱼ‖²/λ²) V`` for
``X`` (n, d) and ``V`` (n,) or (n, r), with the Gram tiles formed and
consumed on chip.  Its CUDA source is ``csrc/rbf_matvec.cu`` (f32 and f64
instantiations, plain C interface, built by
:mod:`repro_torch.kernels._build`), whose header says what bounds it
(operations: the kernel forms every tile, 2n²d flops for n·(d + 2r)
elements read, twice the n(n+1)·d that K's symmetry leaves the function)
and how its tiles are laid out.  ``1/λ`` and ``θ²`` go to the kernel as scalars, so no
scaled copy of ``X`` is made per call; the f64 kernel accumulates in f64,
the f32 kernel in f32.

The kernel walks the column tiles of each 64-row tile in ``splits``
ranges, each written once to a ``(splits, n, min(r, 32))`` scratch that a
second kernel sums in a fixed order; :func:`_split_grid` picks ``splits``
so that about :data:`TARGET_BLOCKS` blocks fill the card.

Beside the wrapper sits its plain PyTorch version, ``rbf_matvec_plain``:
the row-blocked product of ``repro/kernels/ops.py:_rbf_matvec_chunked``
(one ``(block, n)`` Gram slab at a time), the CPU path and the card's
yardstick.  The counters are those of :mod:`repro_torch.kernels._runtime`,
shared with :mod:`repro_torch.kernels.cg_fused`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _runtime

LAUNCHES = _runtime.LAUNCHES
PLAIN_ON_CUDA = _runtime.PLAIN_ON_CUDA

TILE = 64  # rows and columns of the kernel's Gram tile
MAX_R = 32  # right-hand sides per kernel pass; wider V runs in chunks
TARGET_BLOCKS = 2048  # ~15 waves of 256-thread blocks on 132 SMs

_P, _I, _L, _D = _runtime.PTR, _runtime.INT, _runtime.INT64, _runtime.DOUBLE
_SIGNATURE = (_P, _P, _P, _P, _L, _L, _I, _P, _I, _D, _D, _I, _L, _P, _P)


def _split_grid(m: int, n: int):
    """``(splits, columns per split)``: each of the ``ceil(m / 64)`` row
    tiles walks ``n`` columns in ``splits`` ranges of whole tiles."""
    cdiv = _runtime.cdiv
    col_tiles = cdiv(n, TILE)
    want = max(1, min(col_tiles, cdiv(TARGET_BLOCKS, cdiv(m, TILE))))
    cols = cdiv(col_tiles, want) * TILE
    return cdiv(n, cols), cols


def rbf_matvec_cuda(
    x: torch.Tensor, v: torch.Tensor, theta: float, lengthscale: float
) -> torch.Tensor:
    """``K(X, X) @ v`` on the card for ``v`` of shape (n,) or (n, r)."""
    squeeze = v.ndim == 1
    v2 = (v[:, None] if squeeze else v).contiguous()  # (n, r) row-major
    n, d = x.shape
    r = v2.shape[1]
    _runtime.check("rbf_matvec", x, x=(x, (n, d)), v=(v2, (n, r)))
    if n == 0 or d == 0 or r == 0:
        raise ValueError(f"rbf_matvec: need n, d, r >= 1, got n={n}, d={d}, r={r}")
    splits, cols = _split_grid(n, n)
    sq = torch.empty((n,), dtype=x.dtype, device=x.device)
    partials = torch.empty((splits, n, min(r, MAX_R)), dtype=x.dtype, device=x.device)
    y = torch.empty((n, r), dtype=x.dtype, device=x.device)
    p = _runtime.ptr
    _runtime.launch(
        "rbf_matvec", "rbf_matvec", _SIGNATURE, x,
        p(x), p(x), p(sq), p(sq), n, n, d, p(v2), r,
        1.0 / float(lengthscale), float(theta) ** 2, splits, cols,
        p(partials), p(y),
    )
    return y[:, 0] if squeeze else y


def rbf_matvec_plain(
    x: torch.Tensor,
    v: torch.Tensor,
    theta: float,
    lengthscale: float,
    block: int = 1024,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`rbf_matvec_cuda`, ``block`` rows of
    the Gram matrix at a time (O(block · n) memory)."""
    _runtime.note_plain("rbf_matvec", x)
    squeeze = v.ndim == 1
    vs = (theta**2) * (v[:, None] if squeeze else v)
    xs = x / lengthscale
    sq = torch.sum(xs * xs, 1)
    n = x.shape[0]
    y = torch.empty((n, vs.shape[1]), dtype=vs.dtype, device=vs.device)
    for i0 in range(0, n, max(1, block)):
        xi = xs[i0 : i0 + block]
        # (|x_i|² + |x_j|²) − 2 x_i·x_j in the reference's order (×−2 is exact).
        k = (xi @ xs.T).mul_(-2.0).add_(sq[i0 : i0 + block, None] + sq[None, :])
        k.clamp_(min=0.0).mul_(-0.5).exp_()
        y[i0 : i0 + block] = k @ vs
    return y[:, 0] if squeeze else y
