"""The Mamba2 SSD chunked scan on the H100: hand-written CUDA kernels (K10).

``ssd_scan_cuda`` replaces ``ssd_scan_pallas``
(``repro/kernels/ssd_scan.py:92``, body ``_ssd_kernel`` :41).  For each
(batch, head) and chunk of ``c`` rows, with ``cs = cumsum(a·dt)`` inside
the chunk (f32, a fixed order)::

    G  = C Bᵀ                                   (c × c)
    M  = exp(cs_t − cs_s)·dt_s  for s ≤ t, else 0 (masked before the exp)
    Y  = (M ⊙ G) X + exp(cs)·(C H_kᵀ)
    H_{k+1} = exp(cs_c)·H_k + Xᵀ(exp(cs_c − cs)·dt ⊙ B)

with the (p × n) state in f32.  Beyond the Pallas kernel it takes an
optional f32 initial state (b, h, p, n) and can return the final one: the
function ``repro/kernels/ops.py:_ssd_chunked`` computes for
``initial_state=``/``return_state=True``, which the serving path's prefill
needs.  The padded tail of the last chunk has ``dt = 0``, so the final
state is exact.  B and C are read by group ``h // (h / g)``, never repeated
in memory.

The card runs the SSD decomposition (arXiv 2405.21060, §6) in three
launches of ``csrc/ssd_scan.cu``, whose header gives the design and the
bound: chunk states ``S_k`` for every (batch, head, chunk) at once, the
state passed through the chunks in order in f32 (``S_k`` replaced in place
by the state entering chunk ``k``), then every chunk's output.  The wrapper
allocates that scratch and launches on the grids :func:`plan` gives, and
counts one launch per call.  bf16 runs on the tensor cores, each non-bf16 factor as a bf16
hi + lo pair; f32 on the CUDA cores.  c ≤ 128, p ≤ 64, n ≤ 128.

``x``, ``bmat`` and ``cmat`` are read where they lie: any view whose last
dimension is contiguous with its heads (or groups) packed, whatever its
batch and row strides (:func:`row_strides`) — the ``torch.split`` of the
Mamba mixer's convolution output — so nothing is copied.  Any other layout
raises.

The D skip is added outside the kernel, as the reference adds it:
``y + x·d`` with ``y`` in ``x.dtype`` and ``d`` in f32, which promotes to
f32; the Mamba block casts back to its dtype afterwards.  The wrapper
computes it as one ``torch.addcmul`` (the same dtypes in one pass over y
and x, where ``_skip`` takes two; ``PERF.md`` §6 has both times).  addcmul
rounds once where ``_skip`` rounds the product and then the sum, so the two
differ in the last f32 bits (by up to 3.8e-6 at mamba2-1.3b's prefill on an
H100, ``tools/kernel_times.py --only k10``).

Beside it sits its plain PyTorch version, ``ssd_plain``: ``_ssd_chunked``
in torch (one chunk at a time, the state carried in f32) with the Pallas
kernel's arithmetic, all of it in f32 on inputs widened from their dtype
(the reference's chunked scan forms ``C Bᵀ`` in the inputs' dtype
instead): the CPU path and the card's yardstick.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _runtime

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128
DTYPES = (torch.float32, torch.bfloat16)
# Heads one block of the bf16 chunk passes takes (all of one group): it
# forms G = C Bᵀ once for them.  8 keeps mamba2's prefill at 1 024 blocks of
# the output pass, about 8 waves of one block per SM.
HEADS_PER_BLOCK = 8
THREADS = 256
MAX_GRID_X, MAX_GRID_YZ = 2**31 - 1, 65535

_P, _I, _L = _runtime.PTR, _runtime.INT, _runtime.INT64
_SIGNATURE = (_P,) * 11 + (_L,) * 6 + (_I,) * 14


def _chunk(chunk: int, l: int) -> int:
    """The Pallas kernel's chunk length: ``chunk``, or ``l`` rounded up to
    8 when the sequence is shorter."""
    return min(chunk, -(-l // 8) * 8)


def _skip(y: torch.Tensor, x: torch.Tensor, d: Optional[torch.Tensor]) -> torch.Tensor:
    return y if d is None else y + x * d[None, None, :, None]


def plan(b: int, l: int, h: int, p: int, g: int, n: int, chunk: int,
         dtype: torch.dtype) -> dict:
    """How one call runs on the card, as the wrapper launches it: the chunk
    length and count, the heads a block of the two chunk passes takes (bf16:
    the largest divisor of the heads per group up to ``HEADS_PER_BLOCK``;
    f32: one), the grids of the chunk passes (heads / per block, chunks,
    batch) and of the state pass ((batch, head) pairs on x, blocks of
    state elements on y), and the shapes of the f32 scratch (chunk states, ``cs``,
    ``exp(cs_c)``).  Raises past the kernels' limits."""
    if l < 1 or g < 1 or h % g:
        raise ValueError(f"ssd_scan: need l >= 1 and {h} heads over {g} groups")
    c = _chunk(chunk, l)
    if c > MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(
            f"ssd_scan: chunk {c}, head dim {p}, state {n} exceed "
            f"{MAX_CHUNK}, {MAX_HEAD_DIM}, {MAX_STATE}")
    chunks = _runtime.cdiv(l, c)
    if chunks > MAX_GRID_YZ or b > MAX_GRID_YZ or b * h > MAX_GRID_X:
        raise ValueError(f"ssd_scan: {chunks} chunks, batch {b} or {b * h} (batch, head) pairs "
                         f"exceed the grid's {MAX_GRID_YZ}, {MAX_GRID_YZ}, {MAX_GRID_X}")
    hpb = 1
    if dtype == torch.bfloat16:
        hpb = max(k for k in range(1, HEADS_PER_BLOCK + 1) if (h // g) % k == 0)
    return {
        "chunk": c, "chunks": chunks, "heads_per_block": hpb,
        "grid_chunks": (h // hpb, chunks, b),
        "grid_states": (b * h, _runtime.cdiv(p * n, THREADS)),
        "scratch": {"states": (b, h, chunks, p, n), "cs": (b, h, chunks, c),
                    "decay": (b, h, chunks)},
    }


def row_strides(name: str, t: torch.Tensor, shape: Tuple[int, int, int, int]) -> Tuple[int, int]:
    """``t``'s (batch, row) strides in elements if it is a (b, l, k, w)
    view the kernels read in place — ``shape``, last dimension contiguous,
    its ``k`` heads packed (``stride(2) == w``) — else raises.  Strides of
    dimensions of size 1 are never used and read as 0."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ssd_scan: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    b, l, k, w = shape
    if (w > 1 and t.stride(3) != 1) or (k > 1 and t.stride(2) != w):
        raise ValueError(
            f"ssd_scan: {name} must have a contiguous last dimension with its {k} heads packed "
            f"(strides {tuple(t.stride())})")
    return (t.stride(0) if b > 1 else 0), (t.stride(1) if l > 1 else 0)


def vectorized(views) -> bool:
    """Whether every ``(tensor, (batch, row) strides)`` of bf16 ``views``
    can be copied 16 bytes at a time: pointer, row width and strides
    multiples of 8 elements."""
    return all(t.dtype == torch.bfloat16 and t.data_ptr() % 16 == 0 and t.shape[3] % 8 == 0
               and all(s % 8 == 0 for s in strides) for t, strides in views)


def ssd_scan_cuda(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    bmat: torch.Tensor,
    cmat: torch.Tensor,
    d: Optional[torch.Tensor] = None,
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """The SSD scan on the card: ``x`` (b, l, h, p) and ``bmat``/``cmat``
    (b, l, g, n) in f32 or bf16 (views as :func:`row_strides` takes them),
    ``dt`` (b, l, h), ``a`` (h,) and ``initial_state`` (b, h, p, n) in f32.
    Returns ``y`` (plus the final f32 state when ``return_state``).
    Raises ``NotImplementedError`` when a derivative is being taken through
    an input: the kernel has no backward or forward-mode arm yet, and its
    output would carry none."""
    if _runtime.differentiated(x, dt, a, bmat, cmat, d, initial_state):
        raise NotImplementedError(
            "ssd_scan: the CUDA kernel has no backward or forward-mode arm yet (ROADMAP queue 1, "
            "mamba2 training); differentiate the plain version (backend='plain') instead")
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    _runtime.check("ssd_scan", x, DTYPES)
    pl = plan(b, l, h, p, g, n, chunk, x.dtype)
    views = []
    for name, t, shape in (("x", x, (b, l, h, p)), ("bmat", bmat, (b, l, g, n)),
                           ("cmat", cmat, (b, l, g, n))):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} on {t.device}, expected {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"ssd_scan: {name} is {t.dtype}, expected {x.dtype}")
        views.append((t, row_strides(name, t, shape)))
    dt, a = dt.contiguous(), a.contiguous()
    h0 = None if initial_state is None else initial_state.contiguous()
    f32 = {"dt": (dt, (b, l, h)), "a": (a, (h,))}
    if h0 is not None:
        f32["initial_state"] = (h0, (b, h, p, n))
    _runtime.check("ssd_scan", dt, (torch.float32,), **f32)
    if dt.device != x.device:
        raise ValueError(f"ssd_scan: dt on {dt.device}, x on {x.device}")
    f32_on = dict(dtype=torch.float32, device=x.device)
    states, cs, decay = (torch.empty(pl["scratch"][k], **f32_on) for k in ("states", "cs", "decay"))
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=x.device)
    h1 = torch.empty((b, h, p, n), **f32_on) if return_state else None
    ptr = _runtime.ptr
    _runtime.launch(
        "ssd_scan", "ssd_scan", _SIGNATURE, x,
        ptr(x), ptr(dt), ptr(a), ptr(bmat), ptr(cmat), ptr(h0), ptr(y), ptr(h1),
        ptr(states), ptr(cs), ptr(decay), *views[0][1], *views[1][1], *views[2][1],
        b, l, h, p, g, n, pl["chunk"], pl["heads_per_block"], int(vectorized(views)),
        *pl["grid_chunks"], *pl["grid_states"],
    )
    if d is not None:  # y + x·d in one pass over y and x, rounded once (module docstring)
        y = torch.addcmul(y, x, d[None, None, :, None])
    return (y, h1) if return_state else y


def ssd_plain(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    bmat: torch.Tensor,
    cmat: torch.Tensor,
    d: Optional[torch.Tensor] = None,
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """Plain PyTorch version of :func:`ssd_scan_cuda`: the reference's
    ``_ssd_chunked`` with chunks of ``min(chunk, l)``."""
    _runtime.note_plain("ssd_scan", x)
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hpg = h // g
    c = min(chunk, l)
    f32 = torch.float32
    hstate = (initial_state.to(f32) if initial_state is not None
              else torch.zeros((b, h, p, n), dtype=f32, device=x.device))
    tri = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    y = torch.empty_like(x)
    for t0 in range(0, l, c):
        xi, dti = x[:, t0 : t0 + c], dt[:, t0 : t0 + c]
        bi = bmat[:, t0 : t0 + c].repeat_interleave(hpg, dim=2)  # (b, c', h, n)
        ci = cmat[:, t0 : t0 + c].repeat_interleave(hpg, dim=2)
        cc = xi.shape[1]
        mask = tri[:cc, :cc, None]
        cs = torch.cumsum(dti * a[None, None, :], dim=1)  # (b, c', h)
        cs_tot = cs[:, -1:, :]
        xf, cf, bf = xi.float(), ci.float(), bi.float()
        gmat = torch.einsum("bthn,bshn->bhts", cf, bf)
        delta = cs[:, :, None, :] - cs[:, None, :, :]  # (b, t, s, h)
        m = torch.where(mask, torch.exp(torch.where(mask, delta, 0.0)) * dti[:, None, :, :],
                        0.0).permute(0, 3, 1, 2)  # (b, h, t, s)
        yi = torch.einsum("bhts,bshp->bthp", m * gmat, xf)
        yi = yi + torch.exp(cs)[..., None] * torch.einsum(
            "bthn,bhpn->bhtp", cf, hstate).permute(0, 2, 1, 3)
        bw = bf * (torch.exp(cs_tot - cs) * dti)[..., None]
        hstate = torch.exp(cs_tot[:, 0, :])[:, :, None, None] * hstate + torch.einsum(
            "bshp,bshn->bhpn", xf, bw)
        y[:, t0 : t0 + c] = yi.to(x.dtype)
    y = _skip(y, x, d)
    return (y, hstate) if return_state else y
