"""The matrix-free RBF Gram matvec on the H100: hand-written CUDA kernels.

``rbf_matvec_cuda`` replaces ``rbf_matvec_pallas``
(``repro/kernels/rbf_matvec.py:77``): ``Y = θ² exp(−½‖xᵢ − xⱼ‖²/λ²) V`` for
``X`` (n, d) and ``V`` (n,) or (n, r), with the Gram tiles formed and
consumed on chip.  ``rbf_matvec_rect_cuda`` replaces
``rbf_matvec_rect_pallas`` (``repro/kernels/rbf_matvec.py:134``), the
per-rank product of the sharded RBF operator: this rank's rows
``X_rows`` (m, d) against all columns ``X_cols`` (n, d).  As the Pallas
K8 is ``_rbf_matvec_kernel`` unchanged on another grid, K8 here is the
same CUDA tile kernel in its rectangular mode, through its own entry
point, wrapper and launch counter.  The CUDA source is
``csrc/rbf_matvec.cu`` (f32 and f64 instantiations, plain C interface,
built by :mod:`repro_torch.kernels._build`), whose header says what bounds
it (operations: the cross term ``X_I X_Jᵀ`` of 128 × 128 tiles, on the
FP64 tensor cores in f64 and by FMAs in f32) and how its tiles and
stages are laid out.  ``1/λ²`` folds into the epilogue and ``θ²`` into
the staged ``V``, so no scaled copy of ``X`` is made per call; the f64
kernel accumulates in f64, the f32 kernel in f32.

The square product uses K's symmetry: with ``T`` row tiles, row tile I
forms the tiles ``(I, (I + o) mod T)`` for ``o < L_I``
(:func:`sym_lengths`), so each unordered pair once; an off-diagonal tile
adds ``K_IJ V_J`` to ``Y_I`` and ``K_IJᵀ V_I`` to ``Y_J``.  Each row's list
is cut into ``nseg`` balanced segments, one block each; a block's ``Y_I``
goes to a ``(nseg, n, r_chunk)`` scratch and each transposed product to a
``(L − 1, n, r_chunk)`` scratch at ``Y_J``'s rows, and a second kernel
sums both in a fixed order (row parts by segment, then column parts by
offset).  ``r_chunk = min(r, MAX_R)``, so the column scratch grows as
``n² r_chunk / 256`` elements: :func:`_symmetric` keeps the symmetric
mode while it fits :data:`SCRATCH_BYTES` and otherwise runs the square
product on the full grid, the rectangular mode, which needs none.
:func:`_split_grid` picks ``nseg`` (the rectangular mode's splits of the
column tiles) for the fewest waves of equal blocks on the card's SMs.

Both run as ``torch.library`` custom ops (:func:`rbf_matvec_op`,
:func:`rbf_matvec_rect_op`), whose fakes on meta tensors give the output's
shape and the count of :mod:`repro_torch.kernels.work`, with the scratch
:func:`plan` gives the wrapper (for one H100's SMs off the card): what the
dry-run's GP cell reads.

Beside each wrapper sits its plain PyTorch version, ``rbf_matvec_plain``
and ``rbf_matvec_rect_plain``: the row-blocked products of
``repro/kernels/ops.py:_rbf_matvec_chunked`` and
``_rbf_matvec_rect_chunked`` (one ``(block, n)`` Gram slab at a time), the
CPU path and the card's yardstick.  The counters are those of
:mod:`repro_torch.kernels._runtime`, shared with
:mod:`repro_torch.kernels.cg_fused`.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _runtime, work

LAUNCHES = _runtime.LAUNCHES
PLAIN_ON_CUDA = _runtime.PLAIN_ON_CUDA

TILE = 128  # rows and columns of the kernel's Gram tile
ROW_GROUP = 16  # row tiles of consecutive blocks
MAX_R = 16  # right-hand sides per kernel pass (kMaxR); wider V runs in chunks
SCRATCH_BYTES = 10**9  # the symmetric mode's column scratch, at most
H100_SMS = 132  # the SMs a plan assumes off the card (the dry-run's card)
BLOCK_OVERHEAD = 0.25  # a block's fixed cost, in tiles, for _split_grid

_P, _I, _L, _D = _runtime.PTR, _runtime.INT, _runtime.INT64, _runtime.DOUBLE
_SIGNATURES = {
    "rbf_matvec": (_P, _P, _L, _I, _P, _I, _D, _D, _I, _I, _P, _P, _P, _P, _I, _L),
    "rbf_matvec_rect": (_P, _P, _P, _P, _L, _L, _I, _P, _I, _D, _D, _I, _P, _P, _P, _I, _L),
}


def sym_lengths(t: int) -> list:
    """``L_I``, the tiles row tile I forms in the symmetric schedule over
    ``t`` row tiles: ``(t + 1) // 2`` each when ``t`` is odd; when even,
    ``t // 2 + 1`` for the first half and ``t // 2`` for the rest."""
    if t % 2:
        return [(t + 1) // 2] * t
    return [t // 2 + 1 if i < t // 2 else t // 2 for i in range(t)]


def _split_grid(row_tiles: int, lengths: list, sms: int) -> int:
    """Segments per row tile: the count (at most the shortest row) whose
    blocks fill the card in the fewest waves of the longest segment."""
    def cost(s):
        waves = _runtime.cdiv(row_tiles * s, sms)
        return waves * (_runtime.cdiv(max(lengths), s) + BLOCK_OVERHEAD)

    return min(range(1, min(lengths) + 1), key=lambda s: (cost(s), s))


def _symmetric(n: int, lengths: list, r: int, itemsize: int) -> bool:
    """Whether the square product of ``n`` rows and ``r`` right-hand sides
    runs in the symmetric mode: while its column scratch ``(L − 1, n,
    min(r, MAX_R))`` fits :data:`SCRATCH_BYTES` (at 1 GB, in f64, up to n ≈
    44 700 for r ≥ 16 and n ≈ 178 800 for r = 1)."""
    return (max(lengths) - 1) * n * min(r, MAX_R) * itemsize <= SCRATCH_BYTES


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _gate_args(gate: Optional[torch.Tensor], like: torch.Tensor):
    """``(pointer, lanes, stride)`` of a product's gate: a bool device
    vector (or 0-d flag) of any stride, None for an ungated product."""
    if gate is None:
        return None, 0, 0
    if gate.dtype != torch.bool or gate.device != like.device or gate.ndim > 1:
        raise ValueError(f"rbf_matvec: gate must be a 0-d or 1-d bool tensor on {like.device}, "
                         f"got {gate.dtype} {tuple(gate.shape)} on {gate.device}")
    lanes = 1 if gate.ndim == 0 else gate.shape[0]
    if lanes < 1:
        raise ValueError("rbf_matvec: the gate needs at least one flag")
    return gate.data_ptr(), lanes, (gate.stride(0) if gate.ndim else 0)


def plan(square: bool, m: int, n: int, r: int, itemsize: int, sms: int) -> dict:
    """How one product of ``m`` rows against ``n`` columns and ``r``
    right-hand sides runs on a card of ``sms`` SMs: the symmetric schedule
    or the full grid (``sym``; the square entry only), the segments per row
    tile (``nseg``) and the shapes of the scratch the wrapper allocates (row
    norms, the row parts, and the column parts of the symmetric mode or the
    column norms of the rectangular)."""
    cdiv = _runtime.cdiv
    row_tiles, col_tiles = cdiv(m, TILE), cdiv(n, TILE)
    lengths = sym_lengths(col_tiles)
    sym = square and _symmetric(n, lengths, r, itemsize)
    if not sym:
        lengths = [col_tiles]
    nseg = _split_grid(row_tiles, lengths, sms)
    rc = min(r, MAX_R)
    scratch = {"sq_rows": (m,), "rowpart": (nseg, m, rc)}
    if not square:
        scratch["sq_cols"] = (n,)
    elif sym and max(lengths) > 1:
        scratch["colpart"] = (max(lengths) - 1, n, rc)
    return {"sym": sym, "nseg": nseg, "scratch": scratch}


def _launch(
    name: str, x_rows: torch.Tensor, x_cols: torch.Tensor, v: torch.Tensor,
    theta: float, lengthscale: float, gate: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``K(X_rows, X_cols) @ v`` through entry point ``name`` of
    ``csrc/rbf_matvec.cu``.  The square entry (K3) runs the symmetric
    schedule where its scratch fits (:func:`_symmetric`), else the full
    grid, with one norm buffer; K8's the full grid with two, even when
    handed the same X (:func:`plan`).  ``gate`` (bool device flags) zeroes
    the product on the card, without a host read, when no flag is set."""
    squeeze = v.ndim == 1
    v2 = (v[:, None] if squeeze else v).contiguous()  # (n, r) row-major
    m, d = x_rows.shape
    n = x_cols.shape[0]
    r = v2.shape[1]
    _runtime.check(name, x_rows, x_rows=(x_rows, (m, d)), x_cols=(x_cols, (n, d)),
                   v=(v2, (n, r)))
    if m == 0 or n == 0 or d == 0 or r == 0:
        raise ValueError(f"{name}: need m, n, d, r >= 1, got m={m}, n={n}, d={d}, r={r}")
    square = name == "rbf_matvec"
    pl = plan(square, m, n, r, x_rows.element_size(), _sms(x_rows.device.index or 0))
    new = functools.partial(torch.empty, dtype=x_rows.dtype, device=x_rows.device)
    scr = {key: new(shape) for key, shape in pl["scratch"].items()}
    y = new((m, r))
    p = _runtime.ptr
    scalars = (1.0 / float(lengthscale), float(theta) ** 2)
    gated = _gate_args(gate, x_rows)
    if square:
        args = (p(x_rows), p(scr["sq_rows"]), n, d, p(v2), r, *scalars, int(pl["sym"]),
                pl["nseg"], p(scr["rowpart"]), p(scr.get("colpart")), p(y), *gated)
    else:
        args = (p(x_rows), p(x_cols), p(scr["sq_rows"]), p(scr["sq_cols"]), m, n, d, p(v2), r,
                *scalars, pl["nseg"], p(scr["rowpart"]), p(y), *gated)
    _runtime.launch("rbf_matvec", name, _SIGNATURES[name], x_rows, *args)
    return y[:, 0] if squeeze else y


def rbf_matvec_cuda(
    x: torch.Tensor, v: torch.Tensor, theta: float, lengthscale: float,
    gate: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``K(X, X) @ v`` on the card for ``v`` of shape (n,) or (n, r);
    zeros when ``gate`` (bool device flags) is given and no flag is set."""
    return _launch("rbf_matvec", x, x, v, theta, lengthscale, gate)


def rbf_matvec_rect_cuda(
    x_rows: torch.Tensor,
    x_cols: torch.Tensor,
    v: torch.Tensor,
    theta: float,
    lengthscale: float,
    gate: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``K(X_rows, X_cols) @ v`` on the card: ``x_rows`` (m, d), ``x_cols``
    (n, d), ``v`` (n,) or (n, r); the result is (m,) or (m, r).  ``gate``
    as in :func:`rbf_matvec_cuda`."""
    return _launch("rbf_matvec_rect", x_rows, x_cols, v, theta, lengthscale, gate)


def _gated_plain(y: torch.Tensor, gate: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain versions' gate: ``y`` where any flag is set, else zeros."""
    if gate is None:
        return y
    return torch.where(torch.any(gate), y, torch.zeros((), dtype=y.dtype, device=y.device))


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
    gate: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`rbf_matvec_cuda`, ``block`` rows of
    the Gram matrix at a time (O(block · n) memory)."""
    _runtime.note_plain("rbf_matvec", x)
    return _gated_plain(_gram_matvec_plain(x, x, v, theta, lengthscale, block), gate)


def rbf_matvec_rect_plain(
    x_rows: torch.Tensor,
    x_cols: torch.Tensor,
    v: torch.Tensor,
    theta: float,
    lengthscale: float,
    block: int = 1024,
    gate: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`rbf_matvec_rect_cuda`, ``block``
    rows of the (m, n) Gram block at a time (O(block · n) memory)."""
    _runtime.note_plain("rbf_matvec_rect", x_rows)
    return _gated_plain(_gram_matvec_plain(x_rows, x_cols, v, theta, lengthscale, block), gate)


# K3 and K8 as custom ops, so that the dry-run's trace on the meta device
# records them as calls (a kernel launched through raw pointers is invisible
# to a tracer): the CUDA implementation launches the kernel, the fake gives
# the output's shape on the meta device and ``work`` the kernel's count, and
# on any other device the plain version runs.


@torch.library.custom_op("repro_torch::rbf_matvec", mutates_args=())
def _square_op(x: torch.Tensor, v: torch.Tensor, theta: float, lengthscale: float,
               gate: Optional[torch.Tensor]) -> torch.Tensor:
    return rbf_matvec_plain(x, v, theta, lengthscale, gate=gate)


@_square_op.register_kernel("cuda")
def _square_cuda(x, v, theta, lengthscale, gate):
    return rbf_matvec_cuda(x, v, theta, lengthscale, gate)


@_square_op.register_fake
def _square_fake(x, v, theta, lengthscale, gate):
    return x.new_empty(x.shape[:1] + v.shape[1:])


@torch.library.custom_op("repro_torch::rbf_matvec_rect", mutates_args=())
def _rect_op(x_rows: torch.Tensor, x_cols: torch.Tensor, v: torch.Tensor, theta: float,
             lengthscale: float, gate: Optional[torch.Tensor]) -> torch.Tensor:
    return rbf_matvec_rect_plain(x_rows, x_cols, v, theta, lengthscale, gate=gate)


@_rect_op.register_kernel("cuda")
def _rect_cuda(x_rows, x_cols, v, theta, lengthscale, gate):
    return rbf_matvec_rect_cuda(x_rows, x_cols, v, theta, lengthscale, gate)


@_rect_op.register_fake
def _rect_fake(x_rows, x_cols, v, theta, lengthscale, gate):
    return x_rows.new_empty(x_rows.shape[:1] + v.shape[1:])


def rbf_matvec_op(x, v, theta, lengthscale, gate=None):
    """K3 through its op ``repro_torch::rbf_matvec``: :func:`rbf_matvec_cuda`
    on CUDA tensors, the fake on meta tensors."""
    return _square_op(x, v, float(theta), float(lengthscale), gate)


def rbf_matvec_rect_op(x_rows, x_cols, v, theta, lengthscale, gate=None):
    """K8 through its op ``repro_torch::rbf_matvec_rect``."""
    return _rect_op(x_rows, x_cols, v, float(theta), float(lengthscale), gate)


def _count(square, x_rows, x_cols, v):
    m, d = x_rows.shape
    n = x_cols.shape[0]
    r = 1 if v.ndim == 1 else v.shape[1]
    sms = _sms(x_rows.device.index or 0) if x_rows.device.type == "cuda" else H100_SMS
    pl = plan(square, m, n, r, x_rows.element_size(), sms)
    scratch = sum(x_rows.element_size() * math.prod(s) for s in pl["scratch"].values())
    if square:
        nbytes, ops = work.rbf_work(n, d, r, x_rows.element_size())
    else:
        nbytes, ops = work.rect_work(m, n, d, r, x_rows.element_size())
    return ops, nbytes, scratch + work.copies(v)


work.count_op(torch.ops.repro_torch.rbf_matvec,
              lambda x, v, *_: _count(True, x, x, v))
work.count_op(torch.ops.repro_torch.rbf_matvec_rect,
              lambda x_rows, x_cols, v, *_: _count(False, x_rows, x_cols, v))
