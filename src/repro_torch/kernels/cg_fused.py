"""The def-CG hot path on the H100: four hand-written CUDA kernels.

Each kernel replaces one Pallas TPU kernel of ``repro/kernels/cg_fused.py``;
its CUDA source is ``csrc/cg_fused.cu`` (f32 and f64 instantiations, plain
C interface, built by :mod:`repro_torch.kernels._build`):

* ``fused_cg_update`` replaces ``fused_cg_update_pallas`` (cg_fused.py:122):
  ``x + αp``, ``r − α·ap``, ``‖r_new‖²`` and ``(AW)·r_new`` in one pass.
  Bound on the H100 by bytes: (6 + k)·n elements for ~(6 + 2k)·n flops.
  One grid-stride pass reads each element once and keeps the k + 1 sums in
  registers; per-block partials go to a ``(blocks, k + 1)`` scratch that a
  second one-block-per-column kernel sums in a fixed order.
* ``fused_deflate_direction`` replaces ``fused_deflate_direction_pallas``
  (cg_fused.py:426), both arms: ``p ← βp + r − μᵀW`` and, when buffers are
  given, the incoming ``(p, ap)`` written into row ``idx`` of the
  ``(rows, n)`` recording buffers in place.  Bytes-bound, (3 + k)·n
  elements (+3n recording); μ sits in shared memory, ``β`` and ``idx`` are
  read from device memory so the loop never waits on the host.
* ``self_gram`` replaces ``self_gram_pallas`` (cg_fused.py:558): ``S Sᵀ``
  of the stacked window ``S = [Z; AZ]`` (2m ≤ 64 rows).  Bytes-bound: it
  reads 2m·n elements for m(2m+1)·2n flops.  Each block stages a
  (2m, 32)-column tile in shared memory and accumulates its share of the
  upper triangle in registers; a second kernel sums the per-block
  partials in block order and mirrors them.
* ``recombine_blocks`` replaces ``recombine_blocks_pallas``
  (cg_fused.py:639): ``[uᵀZ; uᵀAZ]``.  Bytes-bound, 2(m + k)·n elements;
  ``u`` sits in shared memory and each thread owns output columns, so the
  output tiles are disjoint and nothing is reduced across blocks.

All reductions are deterministic (no float atomics) and accumulate in the
working dtype: f64 kernels in f64, f32 kernels in f32.  Ragged tails are
masked in the kernels, not padded.

Beside each kernel wrapper (``*_cuda``) sits its plain PyTorch version
(``*_plain``): the CPU path and the card's yardstick.  It is the oracle of
:mod:`repro_torch.kernels.ref` plus the counter below, and writes the
recording buffers in place as the kernel does.  The wrapper launches
only on CUDA tensors and raises on anything it does not take; dispatch by
device lives in :mod:`repro_torch.kernels.ops`.  ``LAUNCHES`` counts kernel
launches per wrapper; ``PLAIN_ON_CUDA`` counts plain versions run on CUDA
tensors, so a run can show which path the card took.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {
    "fused_cg_update": 0,
    "fused_deflate_direction": 0,
    "self_gram": 0,
    "recombine_blocks": 0,
}
PLAIN_ON_CUDA = dict.fromkeys(LAUNCHES, 0)

THREADS = 256
GRID_CAP = 264  # two resident blocks per SM on a 132-SM H100
MAX_K = 16
MAX_GRAM_ROWS = 64
GRAM_TILE = 32

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "fused_cg_update": [_P, _P, _P, _P, _P, _P, _I, _L, _P, _P, _P, _I, _P, _P, _P],
    "fused_deflate_direction": [_P, _P, _P, _P, _P, _I, _L, _P, _P, _P, _P, _P, _I, _P],
    "self_gram": [_P, _I, _L, _L, _I, _P, _P, _P],
    "recombine_blocks": [_P, _P, _I, _I, _L, _P, _I, _P],
}


@functools.lru_cache(maxsize=None)
def _entry(name: str, dtype: torch.dtype):
    lib = _build.load("cg_fused")
    fn = getattr(lib, f"{name}_{_SUFFIX[dtype]}")
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _grid(n: int) -> int:
    return min(_cdiv(n, THREADS), GRID_CAP)


def _gram_grid(n: int):
    """``(blocks, columns per block)`` of the self-gram partial pass."""
    blocks = min(_cdiv(n, GRAM_TILE), GRID_CAP)
    cols = _cdiv(_cdiv(n, blocks), GRAM_TILE) * GRAM_TILE
    return _cdiv(n, cols), cols


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(name: str, like: torch.Tensor, **tensors) -> None:
    """Device, dtype, shape and layout checks shared by the wrappers."""
    if like.device.type != "cuda":
        raise ValueError(f"{name}: CUDA kernel called on a {like.device} tensor")
    if like.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {like.dtype} not supported (f32, f64)")
    for key, (t, shape) in tensors.items():
        if t.device != like.device:
            raise ValueError(f"{name}: {key} on {t.device}, expected {like.device}")
        if t.dtype != like.dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {like.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device).reshape(())


def _launch(name: str, dtype: torch.dtype, device: torch.device, *args) -> None:
    fn = _entry(name, dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _note_plain(name: str, t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        PLAIN_ON_CUDA[name] += 1


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
    _launch("fused_cg_update", x.dtype, x.device,
            _ptr(x), _ptr(r), _ptr(p), _ptr(ap), _ptr(alpha), _ptr(aw), k, n,
            _ptr(xo), _ptr(ro), _ptr(partials), blocks, _ptr(rr), _ptr(awr))
    return xo, ro, rr, awr


def fused_cg_update_plain(x, r, p, ap, alpha, aw=None):
    """Plain PyTorch version of :func:`fused_cg_update_cuda`."""
    _note_plain("fused_cg_update", x)
    return ref.fused_cg_update(x, r, p, ap, alpha, aw)


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
    _launch("fused_deflate_direction", r.dtype, r.device,
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
    """``S Sᵀ`` for ``S`` of shape ``(m2, n)``, m2 ≤ 64, on the card."""
    m2, n = s.shape
    _check("self_gram", s, s=(s, (m2, n)))
    if n == 0 or not 1 <= m2 <= MAX_GRAM_ROWS:
        raise ValueError(f"self_gram: need n >= 1 and 1 <= rows <= {MAX_GRAM_ROWS}, got {m2}")
    blocks, cols = _gram_grid(n)
    partials = torch.empty((blocks, m2 * (m2 + 1) // 2), dtype=s.dtype, device=s.device)
    out = torch.empty((m2, m2), dtype=s.dtype, device=s.device)
    _launch("self_gram", s.dtype, s.device,
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
    _launch("recombine_blocks", s.dtype, s.device,
            _ptr(s), _ptr(u), m, k, n, _ptr(out), _grid(n))
    return out


def recombine_blocks_plain(s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`recombine_blocks_cuda`."""
    _note_plain("recombine_blocks", s)
    return ref.recombine_blocks(s, u)
