"""The matrix-free RBF Gram matvec on the H100: hand-written CUDA kernels.

``rbf_matvec_cuda`` replaces ``rbf_matvec_pallas``
(``repro/kernels/rbf_matvec.py:77``): ``Y = θ² exp(−½‖xᵢ − xⱼ‖²/λ²) V`` for
``X`` (n, d) and ``V`` (n,) or (n, r), with the Gram tiles formed and
consumed on chip.  ``rbf_matvec_rect_cuda`` replaces
``rbf_matvec_rect_pallas`` (``repro/kernels/rbf_matvec.py:134``), the
per-rank product of the sharded RBF operator: this rank's rows
``X_rows`` (m, d) against all columns ``X_cols`` (n, d).  As the Pallas
K8 is ``_rbf_matvec_kernel`` unchanged on another grid, K8 here is the
same CUDA kernel launched on (m rows × n columns) through its own entry
point, wrapper and launch counter.  The CUDA source is
``csrc/rbf_matvec.cu`` (f32 and f64 instantiations, plain C interface,
built by :mod:`repro_torch.kernels._build`), whose header says what bounds
it (operations: the kernel forms every tile, 2mn·d flops for
(m + n)·d + n·r elements read; the square product needs only the
n(n+1)·d that K's symmetry leaves, the rectangular block all of 2mn·d)
and how its tiles are laid out.  ``1/λ`` and ``θ²`` go to the kernel as
scalars, so no scaled copy of ``X`` is made per call; the f64 kernel
accumulates in f64, the f32 kernel in f32.

The kernel walks the column tiles of each 64-row tile in ``splits``
ranges, each written once to a ``(splits, m, min(r, 32))`` scratch that a
second kernel sums in a fixed order; :func:`_split_grid` picks ``splits``
so that about :data:`TARGET_BLOCKS` blocks fill the card, which matters
for K8, whose m is n over the number of ranks.

Beside each wrapper sits its plain PyTorch version, ``rbf_matvec_plain``
and ``rbf_matvec_rect_plain``: the row-blocked products of
``repro/kernels/ops.py:_rbf_matvec_chunked`` and
``_rbf_matvec_rect_chunked`` (one ``(block, n)`` Gram slab at a time), the
CPU path and the card's yardstick.  The counters are those of
:mod:`repro_torch.kernels._runtime`, shared with
:mod:`repro_torch.kernels.cg_fused`.
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


def _launch(
    name: str, x_rows: torch.Tensor, x_cols: torch.Tensor, v: torch.Tensor,
    theta: float, lengthscale: float,
) -> torch.Tensor:
    """``K(X_rows, X_cols) @ v`` through entry point ``name`` of
    ``csrc/rbf_matvec.cu``.  The square entry (K3) takes one norm buffer
    for both sides; K8's takes two, even when handed the same X."""
    squeeze = v.ndim == 1
    v2 = (v[:, None] if squeeze else v).contiguous()  # (n, r) row-major
    m, d = x_rows.shape
    n = x_cols.shape[0]
    r = v2.shape[1]
    _runtime.check(name, x_rows, x_rows=(x_rows, (m, d)), x_cols=(x_cols, (n, d)),
                   v=(v2, (n, r)))
    if m == 0 or n == 0 or d == 0 or r == 0:
        raise ValueError(f"{name}: need m, n, d, r >= 1, got m={m}, n={n}, d={d}, r={r}")
    splits, cols = _split_grid(m, n)
    sq_rows = torch.empty((m,), dtype=x_rows.dtype, device=x_rows.device)
    sq_cols = sq_rows if name == "rbf_matvec" else torch.empty(
        (n,), dtype=x_rows.dtype, device=x_rows.device)
    partials = torch.empty((splits, m, min(r, MAX_R)), dtype=x_rows.dtype,
                           device=x_rows.device)
    y = torch.empty((m, r), dtype=x_rows.dtype, device=x_rows.device)
    p = _runtime.ptr
    _runtime.launch(
        "rbf_matvec", name, _SIGNATURE, x_rows,
        p(x_rows), p(x_cols), p(sq_rows), p(sq_cols), m, n, d, p(v2), r,
        1.0 / float(lengthscale), float(theta) ** 2, splits, cols,
        p(partials), p(y),
    )
    return y[:, 0] if squeeze else y


def rbf_matvec_cuda(
    x: torch.Tensor, v: torch.Tensor, theta: float, lengthscale: float
) -> torch.Tensor:
    """``K(X, X) @ v`` on the card for ``v`` of shape (n,) or (n, r)."""
    return _launch("rbf_matvec", x, x, v, theta, lengthscale)


def rbf_matvec_rect_cuda(
    x_rows: torch.Tensor,
    x_cols: torch.Tensor,
    v: torch.Tensor,
    theta: float,
    lengthscale: float,
) -> torch.Tensor:
    """``K(X_rows, X_cols) @ v`` on the card: ``x_rows`` (m, d), ``x_cols``
    (n, d), ``v`` (n,) or (n, r); the result is (m,) or (m, r)."""
    return _launch("rbf_matvec_rect", x_rows, x_cols, v, theta, lengthscale)


def _gram_matvec_plain(xr, xc, v, theta, lengthscale, block):
    squeeze = v.ndim == 1
    vs = (theta**2) * (v[:, None] if squeeze else v)
    xrs = xr / lengthscale
    xcs = xrs if xc is xr else xc / lengthscale
    sq_r = torch.sum(xrs * xrs, 1)
    sq_c = sq_r if xc is xr else torch.sum(xcs * xcs, 1)
    m = xr.shape[0]
    y = torch.empty((m, vs.shape[1]), dtype=vs.dtype, device=vs.device)
    for i0 in range(0, m, max(1, block)):
        xi = xrs[i0 : i0 + block]
        # (|x_i|² + |x_j|²) − 2 x_i·x_j in the reference's order (×−2 is exact).
        k = (xi @ xcs.T).mul_(-2.0).add_(sq_r[i0 : i0 + block, None] + sq_c[None, :])
        k.clamp_(min=0.0).mul_(-0.5).exp_()
        y[i0 : i0 + block] = k @ vs
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
    return _gram_matvec_plain(x, x, v, theta, lengthscale, block)


def rbf_matvec_rect_plain(
    x_rows: torch.Tensor,
    x_cols: torch.Tensor,
    v: torch.Tensor,
    theta: float,
    lengthscale: float,
    block: int = 1024,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`rbf_matvec_rect_cuda`, ``block``
    rows of the (m, n) Gram block at a time (O(block · n) memory)."""
    _runtime.note_plain("rbf_matvec_rect", x_rows)
    return _gram_matvec_plain(x_rows, x_cols, v, theta, lengthscale, block)
