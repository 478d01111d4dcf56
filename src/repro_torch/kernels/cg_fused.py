"""The def-CG and LSMR hot paths on the H100: six hand-written CUDA kernels.

Each kernel replaces one Pallas TPU kernel of ``repro/kernels/cg_fused.py``;
its CUDA source is ``csrc/cg_fused.cu`` (f32 and f64 instantiations, plain
C interface, built by :mod:`repro_torch.kernels._build`):

* ``fused_cg_update`` replaces ``fused_cg_update_pallas`` (cg_fused.py:122):
  ``x + αp``, ``r − α·ap``, ``‖r_new‖²`` and ``(AW)·r_new`` in one pass.
  Bound on the H100 by bytes: (6 + k)·n elements for ~(6 + 2k)·n flops.
  One grid-stride pass reads each element once and keeps the k + 1 sums in
  registers; per-block partials go to a ``(blocks, k + 1)`` scratch that a
  second one-block-per-column kernel sums in a fixed order.
* ``fused_rz_reduce`` replaces ``fused_rz_reduce_pallas`` (cg_fused.py:252):
  ``(rᵀz, (AW)·z)`` in one pass, the preconditioned iteration's second
  sweep (``z = M⁻¹r`` exists only after the residual update).
  Bytes-bound, (2 + k)·n elements for 2(1 + k)·n flops; the same
  grid-stride pass and fixed-order two-stage reduction as the ``(AW)·r``
  arm of ``fused_cg_update``.
* ``fused_deflate_direction`` replaces ``fused_deflate_direction_pallas``
  (cg_fused.py:426), both arms: ``p ← βp + r − μᵀW`` and, when buffers are
  given, the incoming ``(p, ap)`` written into row ``idx`` of the
  ``(rows, n)`` recording buffers in place.  Bytes-bound, (3 + k)·n
  elements (+3n recording); μ sits in shared memory, ``β`` and ``idx`` are
  read from device memory so the loop never waits on the host.
* ``self_gram`` replaces ``self_gram_pallas`` (cg_fused.py:558): ``S Sᵀ``
  of the stacked window ``S = [Z; AZ]`` (2m ≤ 128 rows).  Bytes-bound: it
  reads 2m·n elements for m(2m+1)·2n flops.  One block per SM streams its
  column range through shared memory (cp.async, three stages) and adds
  its share of each 8 × 8 tile of the upper triangle in registers: on the
  FP64 tensor cores (DMMA) in f64, by 4 × 4 FMA micro-tiles in f32; a
  second kernel sums the per-block tiles in a fixed order, coalesced, and
  writes both halves from one value.
* ``recombine_blocks`` replaces ``recombine_blocks_pallas``
  (cg_fused.py:639): ``[uᵀZ; uᵀAZ]``.  Bytes-bound, 2(m + k)·n elements.
  As many blocks as fit on each SM (one at 112 rows, three at 40) stream
  their 32-column chunks of ``S`` through shared memory (cp.async, six
  stages); in f64 ``uᵀ`` stays in registers as the A fragments of FP64
  tensor-core products (DMMA), in f32 FMAs.  A column belongs to one
  block, so nothing is reduced across blocks.
* ``lsmr_update`` replaces ``lsmr_update_pallas`` (cg_fused.py:336): one
  LSMR iteration's ``h̄' = h − c0·h̄``, ``x' = x + c1·h̄'``, ``h' = v − c2·h``.
  Bytes-bound, 7n elements for 6n flops: one grid-stride pass reads
  ``x, h̄, h, v`` once and writes the three outputs once; ``c0, c1, c2``
  are 0-d device tensors read through pointers.  Nothing is reduced, so
  its grid fills every SM.

All reductions are deterministic (no float atomics) and accumulate in the
working dtype: f64 kernels in f64, f32 kernels in f32.  Ragged tails are
masked in the kernels, not padded.

Beside each kernel wrapper (``*_cuda``) sits its plain PyTorch version
(``*_plain``): the CPU path and the card's yardstick.  It is the oracle of
:mod:`repro_torch.kernels.ref` plus the counter below, and writes the
recording buffers in place as the kernel does.  The wrapper launches
only on CUDA tensors and raises on anything it does not take; dispatch by
device lives in :mod:`repro_torch.kernels.ops`.  The counters
``LAUNCHES`` and ``PLAIN_ON_CUDA`` are those of
:mod:`repro_torch.kernels._runtime`, shared with ``rbf_matvec``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _runtime, ref

LAUNCHES = _runtime.LAUNCHES
PLAIN_ON_CUDA = _runtime.PLAIN_ON_CUDA

THREADS = 256
GRID_CAP = 264  # two resident blocks per SM on a 132-SM H100
MAX_K = 16
MAX_GRAM_ROWS = 128
GRAM_COLS = 32  # columns of S a shared-memory stage of self_gram holds
GRAM_GRID = 132  # self_gram's partial pass: one block per SM
REC_COLS = 32  # columns of S a shared-memory stage of recombine_blocks holds
LSMR_GRID_CAP = 132 * 8  # eight resident 256-thread blocks per SM

_P, _I, _L = _runtime.PTR, _runtime.INT, _runtime.INT64
_SIGNATURES = {
    "fused_cg_update": (_P, _P, _P, _P, _P, _P, _I, _L, _P, _P, _P, _I, _P, _P),
    "fused_rz_reduce": (_P, _P, _P, _I, _L, _P, _I, _P, _P),
    "fused_deflate_direction": (_P, _P, _P, _P, _P, _I, _L, _P, _P, _P, _P, _P, _I),
    "self_gram": (_P, _I, _L, _L, _I, _P, _P),
    "recombine_blocks": (_P, _P, _I, _I, _L, _P, _I),
    "lsmr_update": (_P, _P, _P, _P, _P, _P, _P, _L, _P, _P, _P, _I),
}
_cdiv = _runtime.cdiv
_ptr = _runtime.ptr
_check = _runtime.check
_scalar = _runtime.scalar
_note_plain = _runtime.note_plain


def _launch(name: str, like: torch.Tensor, *args) -> None:
    _runtime.launch("cg_fused", name, _SIGNATURES[name], like, *args)


def _grid(n: int) -> int:
    return min(_cdiv(n, THREADS), GRID_CAP)


def _gram_grid(n: int):
    """``(blocks, columns per block)`` of the self-gram partial pass."""
    blocks = min(_cdiv(n, GRAM_COLS), GRAM_GRID)
    cols = _cdiv(_cdiv(n, blocks), GRAM_COLS) * GRAM_COLS
    return _cdiv(n, cols), cols


# ---------------------------------------------------------------------------
# fused_cg_update
# ---------------------------------------------------------------------------


def fused_cg_update_cuda(x, r, p, ap, alpha, aw=None):
    """``(x + α p, r − α ap, ‖r_new‖², AW @ r_new | None)`` on the card.

    ``alpha`` is a 0-d tensor on the device (a Python number is copied
    there).  ``rr`` and ``awr`` stay on the device.
    """
    n = x.shape[0]
    k = 0 if aw is None else aw.shape[0]
    alpha = _scalar(alpha, x)
    shapes = {"x": (x, (n,)), "r": (r, (n,)), "p": (p, (n,)), "ap": (ap, (n,)),
              "alpha": (alpha, ())}
    if aw is not None:
        shapes["aw"] = (aw, (k, n))
    _check("fused_cg_update", x, **shapes)
    if n == 0 or k > MAX_K:
        raise ValueError(f"fused_cg_update: need n >= 1 and k <= {MAX_K}, got n={n}, k={k}")
    blocks = _grid(n)
    xo = torch.empty_like(x)
    ro = torch.empty_like(r)
    partials = torch.empty((blocks, k + 1), dtype=x.dtype, device=x.device)
    rr = torch.empty((), dtype=x.dtype, device=x.device)
    awr = torch.empty((k,), dtype=x.dtype, device=x.device) if k else None
    _launch("fused_cg_update", x,
            _ptr(x), _ptr(r), _ptr(p), _ptr(ap), _ptr(alpha), _ptr(aw), k, n,
            _ptr(xo), _ptr(ro), _ptr(partials), blocks, _ptr(rr), _ptr(awr))
    return xo, ro, rr, awr


def fused_cg_update_plain(x, r, p, ap, alpha, aw=None):
    """Plain PyTorch version of :func:`fused_cg_update_cuda`."""
    _note_plain("fused_cg_update", x)
    return ref.fused_cg_update(x, r, p, ap, alpha, aw)


# ---------------------------------------------------------------------------
# fused_rz_reduce
# ---------------------------------------------------------------------------


def fused_rz_reduce_cuda(r, z, aw=None):
    """``(rᵀz, AW @ z | None)`` on the card, both on the device."""
    n = r.shape[0]
    k = 0 if aw is None else aw.shape[0]
    shapes = {"r": (r, (n,)), "z": (z, (n,))}
    if aw is not None:
        shapes["aw"] = (aw, (k, n))
    _check("fused_rz_reduce", r, **shapes)
    if n == 0 or k > MAX_K:
        raise ValueError(f"fused_rz_reduce: need n >= 1 and k <= {MAX_K}, got n={n}, k={k}")
    blocks = _grid(n)
    partials = torch.empty((blocks, k + 1), dtype=r.dtype, device=r.device)
    rz = torch.empty((), dtype=r.dtype, device=r.device)
    awz = torch.empty((k,), dtype=r.dtype, device=r.device) if k else None
    _launch("fused_rz_reduce", r,
            _ptr(r), _ptr(z), _ptr(aw), k, n, _ptr(partials), blocks, _ptr(rz), _ptr(awz))
    return rz, awz


def fused_rz_reduce_plain(r, z, aw=None):
    """Plain PyTorch version of :func:`fused_rz_reduce_cuda`."""
    _note_plain("fused_rz_reduce", r)
    return ref.fused_rz_reduce(r, z, aw)


# ---------------------------------------------------------------------------
# fused_deflate_direction
# ---------------------------------------------------------------------------


def fused_deflate_direction_cuda(
    r, p, beta, w=None, mu=None, ap=None, idx=None, p_buf=None, ap_buf=None
):
    """``p_new = β p + r − μᵀ W`` on the card, optionally recording.

    With ``p_buf``/``ap_buf`` the incoming ``p`` and ``ap`` are written into
    row ``idx`` (a 0-d int64 device tensor; a Python int is copied there)
    of both buffers IN PLACE.  Returns ``(p_new, p_buf, ap_buf)``.
    ``w=None`` is the plain-CG direction update (k = 0).
    """
    n = r.shape[0]
    k = 0 if w is None else w.shape[0]
    beta = _scalar(beta, r)
    shapes = {"r": (r, (n,)), "p": (p, (n,)), "beta": (beta, ())}
    if w is not None:
        shapes.update(w=(w, (k, n)), mu=(mu, (k,)))
    record = p_buf is not None
    if record:
        rows = p_buf.shape[0]
        shapes.update(ap=(ap, (n,)), p_buf=(p_buf, (rows, n)), ap_buf=(ap_buf, (rows, n)))
        idx = torch.as_tensor(idx, dtype=torch.int64, device=r.device).reshape(())
    _check("fused_deflate_direction", r, **shapes)
    if n == 0 or k > MAX_K:
        raise ValueError(
            f"fused_deflate_direction: need n >= 1 and k <= {MAX_K}, got n={n}, k={k}"
        )
    po = torch.empty_like(p)
    _launch("fused_deflate_direction", r,
            _ptr(r), _ptr(p), _ptr(beta), _ptr(w), _ptr(mu), k, n, _ptr(po),
            _ptr(ap if record else None), _ptr(idx if record else None),
            _ptr(p_buf), _ptr(ap_buf), _grid(n))
    return po, p_buf, ap_buf


def fused_deflate_direction_plain(
    r, p, beta, w=None, mu=None, ap=None, idx=None, p_buf=None, ap_buf=None
):
    """Plain PyTorch version of :func:`fused_deflate_direction_cuda`
    (buffers written in place, like the kernel)."""
    _note_plain("fused_deflate_direction", r)
    p_new, _, _ = ref.fused_deflate_direction(r, p, beta, w, mu)
    if p_buf is not None:
        row = torch.as_tensor(idx, dtype=torch.int64, device=r.device).reshape(1)
        p_buf.index_copy_(0, row, p[None])
        ap_buf.index_copy_(0, row, ap[None])
    return p_new, p_buf, ap_buf


# ---------------------------------------------------------------------------
# self_gram
# ---------------------------------------------------------------------------


def self_gram_cuda(s: torch.Tensor) -> torch.Tensor:
    """``S Sᵀ`` for ``S`` of shape ``(m2, n)``, m2 ≤ 128, on the card."""
    m2, n = s.shape
    _check("self_gram", s, s=(s, (m2, n)))
    if n == 0 or not 1 <= m2 <= MAX_GRAM_ROWS:
        raise ValueError(f"self_gram: need n >= 1 and 1 <= rows <= {MAX_GRAM_ROWS}, got {m2}")
    blocks, cols = _gram_grid(n)
    r8 = _cdiv(m2, 8)  # 8 x 8 tiles of the upper triangle, 64 values each
    partials = torch.empty((blocks, r8 * (r8 + 1) // 2 * 64), dtype=s.dtype, device=s.device)
    out = torch.empty((m2, m2), dtype=s.dtype, device=s.device)
    _launch("self_gram", s,
            _ptr(s), m2, n, cols, blocks, _ptr(partials), _ptr(out))
    return out


def self_gram_plain(s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`self_gram_cuda`."""
    _note_plain("self_gram", s)
    return ref.self_gram(s)


# ---------------------------------------------------------------------------
# recombine_blocks
# ---------------------------------------------------------------------------


def recombine_blocks_cuda(s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``[uᵀ S_top; uᵀ S_bot]`` for ``S`` (2m, n), ``u`` (m, k), on the card."""
    m2, n = s.shape
    m, k = u.shape
    u = u.to(s.dtype).contiguous()
    _check("recombine_blocks", s, s=(s, (2 * m, n)), u=(u, (m, k)))
    if n == 0 or 2 * m > MAX_GRAM_ROWS or not 1 <= k <= MAX_K:
        raise ValueError(
            f"recombine_blocks: need n >= 1, 2m <= {MAX_GRAM_ROWS}, 1 <= k <= {MAX_K}; "
            f"got n={n}, m={m}, k={k}"
        )
    out = torch.empty((2 * k, n), dtype=s.dtype, device=s.device)
    _launch("recombine_blocks", s,
            _ptr(s), _ptr(u), m, k, n, _ptr(out), _cdiv(n, REC_COLS))
    return out


def recombine_blocks_plain(s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`recombine_blocks_cuda`."""
    _note_plain("recombine_blocks", s)
    return ref.recombine_blocks(s, u)


# ---------------------------------------------------------------------------
# lsmr_update
# ---------------------------------------------------------------------------


def lsmr_update_cuda(x, hbar, h, v, c0, c1, c2):
    """``(x + c1·h̄', h̄' = h − c0·h̄, v − c2·h)`` on the card.

    ``c0, c1, c2`` are 0-d tensors on the device (Python numbers are
    copied there).  Returns ``(x_new, hbar_new, h_new)``.
    """
    n = x.shape[0]
    c0, c1, c2 = (_scalar(c, x) for c in (c0, c1, c2))
    _check("lsmr_update", x, x=(x, (n,)), hbar=(hbar, (n,)), h=(h, (n,)),
           v=(v, (n,)), c0=(c0, ()), c1=(c1, ()), c2=(c2, ()))
    if n == 0:
        raise ValueError("lsmr_update: need n >= 1")
    xo, hbo, ho = (torch.empty_like(x) for _ in range(3))
    _launch("lsmr_update", x,
            _ptr(x), _ptr(hbar), _ptr(h), _ptr(v), _ptr(c0), _ptr(c1), _ptr(c2), n,
            _ptr(xo), _ptr(hbo), _ptr(ho), min(_cdiv(n, THREADS), LSMR_GRID_CAP))
    return xo, hbo, ho


def lsmr_update_plain(x, hbar, h, v, c0, c1, c2):
    """Plain PyTorch version of :func:`lsmr_update_cuda`."""
    _note_plain("lsmr_update", x)
    return ref.lsmr_update(x, hbar, h, v, c0, c1, c2)
