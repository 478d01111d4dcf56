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

The serving arm and the training arms (:class:`SSDScan`) run as
``torch.library`` custom ops (:func:`ssd_scan_op` for the serving arm), so
a trace records each call; on meta tensors the fakes give the outputs'
shapes and the counts of :mod:`repro_torch.kernels.work` (with the scratch
:func:`plan` and :func:`grad_plan` allocate), what the dry-run reads.

Beside it sits its plain PyTorch version, ``ssd_plain``: ``_ssd_chunked``
in torch (one chunk at a time, the state carried in f32) with the Pallas
kernel's arithmetic, all of it in f32 on inputs widened from their dtype
(the reference's chunked scan forms ``C Bᵀ`` in the inputs' dtype
instead): the CPU path and the card's yardstick.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _runtime, work

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
# The backward's and the tangent map's entry points: pointers, the (batch,
# row) strides of the strided views, the sizes, heads per block, whether
# the views take 16-byte copies, and the grids.
_SIGNATURE_BWD = (_P,) * 22 + (_L,) * 6 + (_I,) * 14
_SIGNATURE_JVP = (_P,) * 18 + (_L,) * 12 + (_I,) * 14


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


def grad_plan(b: int, l: int, h: int, p: int, g: int, n: int, chunk: int,
              dtype: torch.dtype = torch.float32) -> dict:
    """How the backward and the tangent map run on the card.  f32 (CUDA
    cores): one block per (batch, head, chunk) item on ``grid_items``
    (heads, chunks, batch).  bf16 (tensor cores): one block per (batch,
    chunk, heads of one group) as :func:`plan` forms them
    (``heads_per_block``), ``grid_items`` (heads / per block, chunks,
    batch).  Both run the state passes on :func:`plan`'s ``grid_states``.
    The f32 scratch each allocates — the backward: the state gradients
    ``U_k``/``Γ_{k+1}`` (``grads``), the state pass's per-warp partial sums
    of ``⟨Γ_{k+1}, H_k⟩`` (``dots``), the ``dB``/``dC`` partials (f32: one
    a head; bf16: one a block, its heads summed in order) and the per-item
    ``da`` partials, all summed in a fixed order; f32 also keeps each
    item's ``M∘G`` and ``dG`` (``scores``) and its row vectors (``rows``:
    the row and column sums of ``dM∘M``, the column sums of ``dM∘E``, ω),
    which the bf16 kernel keeps on chip; the tangent map: the tangent
    states, ``ċs`` and ``exp(cs_c)``.  Raises past the kernels' limits."""
    pl = plan(b, l, h, p, g, n, chunk, dtype)
    c, k, hpb = pl["chunk"], pl["chunks"], pl["heads_per_block"]
    warps = pl["grid_states"][1] * (THREADS // 32)
    if dtype == torch.bfloat16:
        bwd = {"grads": (b, h, k, p, n), "dots": (b * h, k, warps),
               "db": (b, h // hpb, k, c, n), "dc": (b, h // hpb, k, c, n), "da": (b, h, k)}
    else:
        bwd = {"grads": (b, h, k, p, n), "scores": (b, h, k, 2, c, c),
               "rows": (b, h, k, 4, c), "dots": (b * h, k, warps),
               "db": (b, h, k, c, n), "dc": (b, h, k, c, n), "da": (b, h, k)}
    return {
        "chunk": c, "chunks": k, "heads_per_block": hpb, "grid_items": (h // hpb, k, b),
        "grid_states": pl["grid_states"], "bwd_scratch": bwd,
        "jvp_scratch": {"states": (b, h, k, p, n), "dcs": (b, h, k, c), "decay": (b, h, k)},
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


def _views(x, bmat, cmat, **tangents):
    """The (batch, row) strides of ``x``, ``bmat``, ``cmat`` (and of the
    named tangents of the same shapes), checked as :func:`row_strides`
    takes them, on x's device and in its dtype."""
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    views = []
    named = [("x", x, (b, l, h, p)), ("bmat", bmat, (b, l, g, n)), ("cmat", cmat, (b, l, g, n))]
    for name, t in tangents.items():
        named.append((name, t, (b, l, h, p) if name == "tx" else (b, l, g, n)))
    for name, t, shape in named:
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} on {t.device}, expected {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"ssd_scan: {name} is {t.dtype}, expected {x.dtype}")
        views.append((t, row_strides(name, t, shape)))
    return views


def _f32(x, **tensors):
    """The f32 inputs (dt, a, states, …) made contiguous and checked:
    ``{name: (tensor, shape)}`` with None entries passed through."""
    out = {k: (None if t is None else t.contiguous()) for k, (t, _) in tensors.items()}
    present = {k: (out[k], shape) for k, (t, shape) in tensors.items() if t is not None}
    name, (first, _) = next(iter(present.items()))
    _runtime.check("ssd_scan", first, (torch.float32,), **present)
    if first.device != x.device:
        raise ValueError(f"ssd_scan: {name} on {first.device}, x on {x.device}")
    return out


def _forward(x, dt, a, bmat, cmat, initial_state, chunk, return_state, arm):
    """The three launches of the forward: ``(y, final state or None, H,
    cs)`` with ``H`` the states scratch after the state pass (the f32
    state entering each chunk) and ``cs`` the chunks' cumulative ``a·dt``."""
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    _runtime.check("ssd_scan", x, DTYPES)
    pl = plan(b, l, h, p, g, n, chunk, x.dtype)
    views = _views(x, bmat, cmat)
    f = _f32(x, dt=(dt, (b, l, h)), a=(a, (h,)), initial_state=(initial_state, (b, h, p, n)))
    dt, a, h0 = f["dt"], f["a"], f["initial_state"]
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
        *pl["grid_chunks"], *pl["grid_states"], arm=arm,
    )
    return y, h1, states, cs


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
    an input: this serving arm's output would carry none
    (:func:`repro_torch.kernels.ops.ssd` routes such a call through
    :class:`SSDScan`, whose arms carry it)."""
    if _runtime.differentiated(x, dt, a, bmat, cmat, d, initial_state):
        raise NotImplementedError(
            "ssd_scan: the serving arm drops derivatives; call repro_torch.kernels.ops.ssd, "
            "which differentiates through SSDScan's backward and forward-mode arms")
    y, h1, _, _ = _forward(x, dt, a, bmat, cmat, initial_state, chunk, return_state, None)
    if d is not None:  # y + x·d in one pass over y and x, rounded once (module docstring)
        y = torch.addcmul(y, x, d[None, None, :, None])
    return (y, h1) if return_state else y


def ssd_scan_fwd_cuda(x, dt, a, bmat, cmat, initial_state=None, *, chunk=128):
    """The forward of a differentiated call on the card (the arm
    ``ssd_scan:fwd``): the serving arm's three launches, returning ``(y,
    final state, H, cs)`` — ``y`` without the D skip, the f32 states
    entering each chunk (b, h, chunks, p, n) that the state pass leaves in
    its scratch and ``cs`` (b, h, chunks, c), which the backward and the
    tangent map read."""
    return _forward(x, dt, a, bmat, cmat, initial_state, chunk, True, "fwd")


def _check_saved(x, hs, cs, gp):
    b, h, k, p, n = gp["bwd_scratch"]["grads"]
    f = _f32(x, hs=(hs, (b, h, k, p, n)), cs=(cs, (b, h, k, gp["chunk"])))
    return f["hs"], f["cs"]


def ssd_scan_bwd_cuda(dy, x, dt, a, bmat, cmat, initial_state, hs, cs, dh_last=None, *,
                      chunk=128):
    """``(dx, ddt, da, dB, dC, dh0)`` on the card from the forward's ``hs``
    and ``cs`` (the arm ``ssd_scan:bwd``, one count: four launches on the
    tensor cores in bf16, eight on the CUDA cores in f32): dx, dB and dC in
    the inputs' dtype, the rest f32.  ``dh_last`` is the final state's
    gradient (or None); ``initial_state`` is not read (``hs`` holds it), as
    in the plain version."""
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    dy = dy.contiguous()
    _runtime.check("ssd_scan", x, DTYPES, dy=(dy, (b, l, h, p)))
    gp = grad_plan(b, l, h, p, g, n, chunk, x.dtype)
    views = _views(x, bmat, cmat)
    f = _f32(x, dt=(dt, (b, l, h)), a=(a, (h,)), dh_last=(dh_last, (b, h, p, n)))
    hs, cs = _check_saved(x, hs, cs, gp)
    f32_on = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((b, l, h, p), dtype=x.dtype, device=x.device)
    db = torch.empty((b, l, g, n), dtype=x.dtype, device=x.device)
    dc = torch.empty_like(db)
    ddt = torch.empty((b, l, h), **f32_on)
    da = torch.empty((h,), **f32_on)
    dh0 = torch.empty((b, h, p, n), **f32_on)
    scr = {k: torch.empty(shape, **f32_on) for k, shape in gp["bwd_scratch"].items()}
    ptr = _runtime.ptr
    _runtime.launch(
        "ssd_scan", "ssd_scan_bwd", _SIGNATURE_BWD, x,
        ptr(x), ptr(f["dt"]), ptr(f["a"]), ptr(bmat), ptr(cmat), ptr(dy), ptr(hs), ptr(cs),
        ptr(f["dh_last"]), ptr(dx), ptr(ddt), ptr(da), ptr(db), ptr(dc), ptr(dh0),
        *(ptr(scr.get(k)) for k in ("grads", "scores", "rows", "dots", "db", "dc", "da")),
        *views[0][1], *views[1][1], *views[2][1],
        b, l, h, p, g, n, gp["chunk"], gp["heads_per_block"],
        int(vectorized(views + [(dy, (l * h * p, h * p))])), *gp["grid_items"],
        *gp["grid_states"], key="ssd_scan", arm="bwd",
    )
    return dx, ddt, da, db, dc, dh0


def ssd_scan_jvp_cuda(x, dt, a, bmat, cmat, initial_state, hs, cs, tx, tdt, ta, tb, tc,
                      th0=None, *, chunk=128):
    """The tangents ``(ẏ, ḣ_last)`` on the card for input tangents ``tx,
    tdt, ta, tb, tc`` (and ``th0`` or None), from the forward's ``hs`` and
    ``cs`` (the arm ``ssd_scan:jvp``: three launches, one count; bf16 on
    the tensor cores): ẏ without the D skip in x's dtype, the final state's
    tangent f32.  ``initial_state`` is not read (``hs`` holds it)."""
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    _runtime.check("ssd_scan", x, DTYPES)
    gp = grad_plan(b, l, h, p, g, n, chunk, x.dtype)
    views = _views(x, bmat, cmat, tx=tx.contiguous(), tb=tb.contiguous(), tc=tc.contiguous())
    f = _f32(x, dt=(dt, (b, l, h)), a=(a, (h,)), tdt=(tdt, (b, l, h)), ta=(ta, (h,)),
             th0=(th0, (b, h, p, n)))
    hs, cs = _check_saved(x, hs, cs, gp)
    f32_on = dict(dtype=torch.float32, device=x.device)
    ty = torch.empty((b, l, h, p), dtype=x.dtype, device=x.device)
    th1 = torch.empty((b, h, p, n), **f32_on)
    scr = {k: torch.empty(shape, **f32_on) for k, shape in gp["jvp_scratch"].items()}
    ptr = _runtime.ptr
    _runtime.launch(
        "ssd_scan", "ssd_scan_jvp", _SIGNATURE_JVP, x,
        ptr(x), ptr(f["dt"]), ptr(f["a"]), ptr(bmat), ptr(cmat), ptr(hs), ptr(cs),
        ptr(views[3][0]), ptr(f["tdt"]), ptr(f["ta"]), ptr(views[4][0]), ptr(views[5][0]),
        ptr(f["th0"]), ptr(ty), ptr(th1), *(ptr(scr[k]) for k in ("states", "dcs", "decay")),
        *(s for _, strides in views for s in strides),
        b, l, h, p, g, n, gp["chunk"], gp["heads_per_block"], int(vectorized(views)),
        *gp["grid_items"], *gp["grid_states"], key="ssd_scan", arm="jvp",
    )
    return ty, th1


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
    y, hstate, _, _ = _plain_forward(x, dt, a, bmat, cmat, chunk, initial_state, record=False)
    y = _skip(y, x, d)
    return (y, hstate) if return_state else y


def _plain_forward(x, dt, a, bmat, cmat, chunk, initial_state, record):
    """The chunk loop of :func:`ssd_plain` (no D skip): ``(y, final state,
    H, cs)``; with ``record``, ``H`` (b, h, chunks, p, n) holds the f32 state
    entering each chunk and ``cs`` (b, h, chunks, c) each chunk's cumulative
    ``a·dt`` in the kernels' layout (``c = _chunk(chunk, l)``, rows past the
    sequence's end holding its last value), else both are None."""
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hpg = h // g
    c = min(chunk, l)
    f32 = torch.float32
    hstate = (initial_state.to(f32) if initial_state is not None
              else torch.zeros((b, h, p, n), dtype=f32, device=x.device))
    tri = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    y = torch.empty_like(x)
    chunks = _runtime.cdiv(l, c)
    hs = css = None
    if record:
        hs = torch.empty((b, h, chunks, p, n), dtype=f32, device=x.device)
        css = torch.empty((b, h, chunks, _chunk(chunk, l)), dtype=f32, device=x.device)
    for k, t0 in enumerate(range(0, l, c)):
        xi, dti = x[:, t0 : t0 + c], dt[:, t0 : t0 + c]
        bi = bmat[:, t0 : t0 + c].repeat_interleave(hpg, dim=2)  # (b, c', h, n)
        ci = cmat[:, t0 : t0 + c].repeat_interleave(hpg, dim=2)
        cc = xi.shape[1]
        mask = tri[:cc, :cc, None]
        cs = torch.cumsum(dti * a[None, None, :], dim=1)  # (b, c', h)
        cs_tot = cs[:, -1:, :]
        if record:
            hs[:, :, k] = hstate
            css[:, :, k, :cc] = cs.transpose(1, 2)
            css[:, :, k, cc:] = cs_tot.transpose(1, 2)
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
    return y, hstate, hs, css


# ---------------------------------------------------------------------------
# The differentiated arms: training forward, backward, forward mode (JVP)
# ---------------------------------------------------------------------------
#
# Per (batch, head) and chunk k, with w_s = exp(cs_c − cs_s)·dt_s,
# G = C Bᵀ, E[t,s] = exp(cs_t − cs_s)[s ≤ t], M = E·dt_s and Γ the gradient
# reaching the state that leaves the chunk, the backward is
#
#   dX  = (M∘G)ᵀ dY + diag(w) B Γᵀ        dG = (dY Xᵀ)∘M
#   dB  = dGᵀ C + diag(w) X Γ             dC = dG B + diag(e^cs) dY H_kᵀ... (H_k: p × n)
#   dcs = rowsum(dM∘M) − colsum(dM∘M) + e^cs·ψ − w·ω
#         (+ Σ w·ω + e^{cs_c}⟨Γ, H_k⟩ on the chunk's last row)
#   ddt = colsum(dM∘E) + ω·e^{cs_c − cs} + a·dadt,  dadt = reverse cumsum of dcs
#   da  = Σ dt·dadt
#
# with dM = G∘(dY Xᵀ), ω_s = X_s Γ B_sᵀ and ψ_t = C_t H_kᵀ dY_tᵀ; the
# gradient reaching the state that enters the chunk is
# Γ' = e^{cs_c} Γ + dYᵀ diag(e^cs) C, and the last Γ' is the gradient of
# the initial state.  The tangent map is the same passes carrying pairs:
# ċs = cumsum(ȧ·dt + a·ḋt), Ġ = Ċ Bᵀ + C Ḃᵀ,
# Ṁ = M∘(ċs_t − ċs_s) + E·ḋt_s and
#
#   Ẏ = (Ṁ∘G + M∘Ġ) X + (M∘G) Ẋ + diag(e^cs)((ċs∘C + Ċ) H_kᵀ + C Ḣ_kᵀ)
#   Ḣ_{k+1} = e^{cs_c}(ċs_c H_k + Ḣ_k) + Ẋᵀ diag(w) B + Xᵀ diag(ẇ) B + Xᵀ diag(w) Ḃ
#
# from ḣ0 (or 0).


def ssd_fwd_plain(x, dt, a, bmat, cmat, initial_state=None, *, chunk=128):
    """Plain version of :func:`ssd_scan_fwd_cuda`: ``(y, final state, H,
    cs)`` — ``y`` without the D skip, the f32 states entering each chunk
    (b, h, chunks, p, n) and ``cs`` (b, h, chunks, c) as the kernels lay
    them out (``c = _chunk(chunk, l)``)."""
    _runtime.note_plain("ssd_scan", x)
    return _plain_forward(x, dt, a, bmat, cmat, chunk, initial_state, record=True)


def _group_sum(t, g):
    """(b, rows, h, w) per head → (b, rows, g, w) summed over each group."""
    b, r, h, w = t.shape
    return t.reshape(b, r, g, h // g, w).sum(dim=3)


def ssd_bwd_plain(dy, x, dt, a, bmat, cmat, initial_state, hs, cs, dh_last=None, *,
                  chunk=128):
    """Plain version of :func:`ssd_scan_bwd_cuda`: one chunk at a time in
    reverse order, in f32 on widened inputs, with the state's gradient
    carried explicitly (the formulas above).  ``hs`` and ``cs`` are
    :func:`ssd_fwd_plain`'s; ``dh_last`` the final state's gradient (or
    None).  Returns ``(dx, ddt, da, dB, dC, dh0)``, each rounded once to its
    input's dtype (``dh0`` f32)."""
    _runtime.note_plain("ssd_scan", x)
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hpg = h // g
    c = min(chunk, l)
    f32 = torch.float32
    gam = (dh_last.to(f32) if dh_last is not None
           else torch.zeros((b, h, p, n), dtype=f32, device=x.device))
    tri = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    dx = torch.empty((b, l, h, p), dtype=f32, device=x.device)
    ddt = torch.empty((b, l, h), dtype=f32, device=x.device)
    db = torch.empty((b, l, g, n), dtype=f32, device=x.device)
    dc = torch.empty_like(db)
    da = torch.zeros((h,), dtype=f32, device=x.device)
    starts = list(range(0, l, c))
    for k in reversed(range(len(starts))):
        t0 = starts[k]
        xf, dyf = x[:, t0 : t0 + c].float(), dy[:, t0 : t0 + c].float()
        dti = dt[:, t0 : t0 + c].float()
        bf = bmat[:, t0 : t0 + c].float().repeat_interleave(hpg, dim=2)  # (b, c', h, n)
        cf = cmat[:, t0 : t0 + c].float().repeat_interleave(hpg, dim=2)
        cc = xf.shape[1]
        csk = cs[:, :, k, :cc].transpose(1, 2)  # (b, c', h)
        cs_c = csk[:, -1:, :]
        hk = hs[:, :, k]  # (b, h, p, n)
        mask = tri[:cc, :cc]
        delta = (csk[:, :, None, :] - csk[:, None, :, :]).permute(0, 3, 1, 2)  # (b, h, t, s)
        e = torch.where(mask, torch.exp(torch.where(mask, delta, 0.0)), 0.0)
        m = e * dti.transpose(1, 2)[:, :, None, :]
        gmat = torch.einsum("bthn,bshn->bhts", cf, bf)
        q = torch.einsum("bthp,bshp->bhts", dyf, xf)
        dg, dm = m * q, gmat * q
        w = torch.exp(cs_c - csk) * dti  # (b, c', h)
        ecs = torch.exp(csk)
        xg = torch.einsum("bshp,bhpn->bshn", xf, gam)
        z = torch.einsum("bthp,bhpn->bthn", dyf, hk)
        dx[:, t0 : t0 + c] = (torch.einsum("bhts,bthp->bshp", m * gmat, dyf)
                              + w[..., None] * torch.einsum("bshn,bhpn->bshp", bf, gam))
        db[:, t0 : t0 + c] = _group_sum(torch.einsum("bhts,bthn->bshn", dg, cf)
                                        + w[..., None] * xg, g)
        dc[:, t0 : t0 + c] = _group_sum(torch.einsum("bhts,bshn->bthn", dg, bf)
                                        + ecs[..., None] * z, g)
        omega = (xg * bf).sum(dim=-1)  # (b, s, h)
        psi = (z * cf).sum(dim=-1)  # (b, t, h)
        dmm = dm * m
        dcs = (dmm.sum(dim=3) - dmm.sum(dim=2)).transpose(1, 2) + ecs * psi - w * omega
        dcs[:, -1] += (w * omega).sum(dim=1) + torch.exp(cs_c[:, 0]) * (gam * hk).sum(dim=(2, 3))
        dadt = torch.flip(torch.cumsum(torch.flip(dcs, (1,)), dim=1), (1,))
        ddt[:, t0 : t0 + c] = ((dm * e).sum(dim=2).transpose(1, 2)
                               + omega * torch.exp(cs_c - csk) + a * dadt)
        da += (dti * dadt).sum(dim=(0, 1))
        gam = torch.exp(cs_c[:, 0])[:, :, None, None] * gam + torch.einsum(
            "bthp,bthn->bhpn", dyf * ecs[..., None], cf)
    return dx.to(x.dtype), ddt, da, db.to(bmat.dtype), dc.to(cmat.dtype), gam


def ssd_jvp_plain(x, dt, a, bmat, cmat, initial_state, hs, cs, tx, tdt, ta, tb, tc,
                  th0=None, *, chunk=128):
    """Plain version of :func:`ssd_scan_jvp_cuda`: the tangents of ``y``
    (without the D skip, in x's dtype) and of the final state (f32) for
    input tangents ``tx, tdt, ta, tb, tc`` and ``th0`` (or None), one chunk
    at a time in f32 with the tangent state carried explicitly."""
    _runtime.note_plain("ssd_scan", x)
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hpg = h // g
    c = min(chunk, l)
    f32 = torch.float32
    hdot = (th0.to(f32) if th0 is not None
            else torch.zeros((b, h, p, n), dtype=f32, device=x.device))
    tri = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    ty = torch.empty_like(x)
    for k, t0 in enumerate(range(0, l, c)):
        xf, txf = x[:, t0 : t0 + c].float(), tx[:, t0 : t0 + c].float()
        dti, tdti = dt[:, t0 : t0 + c].float(), tdt[:, t0 : t0 + c].float()
        rep = lambda t: t[:, t0 : t0 + c].float().repeat_interleave(hpg, dim=2)  # noqa: E731
        bf, cf, tbf, tcf = rep(bmat), rep(cmat), rep(tb), rep(tc)
        cc = xf.shape[1]
        csk = cs[:, :, k, :cc].transpose(1, 2)  # (b, c', h)
        cs_c = csk[:, -1:, :]
        tcs = torch.cumsum(ta * dti + a * tdti, dim=1)
        tcs_c = tcs[:, -1:, :]
        hk = hs[:, :, k]
        mask = tri[:cc, :cc]
        perm = lambda t: t.transpose(1, 2)  # noqa: E731  (b, c', h) -> (b, h, c')
        delta = perm(csk)[:, :, :, None] - perm(csk)[:, :, None, :]
        e = torch.where(mask, torch.exp(torch.where(mask, delta, 0.0)), 0.0)
        m = e * perm(dti)[:, :, None, :]
        tm = m * (perm(tcs)[:, :, :, None] - perm(tcs)[:, :, None, :]) + e * perm(tdti)[:, :, None, :]
        gmat = torch.einsum("bthn,bshn->bhts", cf, bf)
        tg = torch.einsum("bthn,bshn->bhts", tcf, bf) + torch.einsum("bthn,bshn->bhts", cf, tbf)
        ecs = torch.exp(csk)
        yi = (torch.einsum("bhts,bshp->bthp", tm * gmat + m * tg, xf)
              + torch.einsum("bhts,bshp->bthp", m * gmat, txf)
              + ecs[..., None] * (torch.einsum("bthn,bhpn->bthp", tcs[..., None] * cf + tcf, hk)
                                  + torch.einsum("bthn,bhpn->bthp", cf, hdot)))
        ty[:, t0 : t0 + c] = yi.to(x.dtype)
        ew = torch.exp(cs_c - csk)
        w = ew * dti
        tw = w * (tcs_c - tcs) + ew * tdti
        dec = torch.exp(cs_c[:, 0])[:, :, None, None]
        hdot = dec * (tcs_c[:, 0][:, :, None, None] * hk + hdot) + torch.einsum(
            "bshp,bshn->bhpn", txf * w[..., None] + xf * tw[..., None], bf) + torch.einsum(
            "bshp,bshn->bhpn", xf * w[..., None], tbf)
    return ty, hdot


# The serving arm and the three training arms as custom ops, so that
# autograd, torch.func, make_fx (``torch.func.linearize``) and the dry-run's
# trace on the meta device record them as calls: a kernel launched through
# raw pointers is invisible to a tracer.  The CUDA implementation launches
# the kernels (or, with ``plain``, runs the plain versions on the card, the
# yardstick ``backend="plain"`` asks for); on the meta device the fake gives
# the outputs' shapes and ``work`` the kernels' count; on any other device
# the plain versions run.


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def _serve_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
              cmat: torch.Tensor, d: Optional[torch.Tensor], h0: Optional[torch.Tensor],
              chunk: int, return_state: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    return _with_state(ssd_plain, x, dt, a, bmat, cmat, d, h0, chunk, return_state)


@_serve_op.register_kernel("cuda")
def _serve_cuda(x, dt, a, bmat, cmat, d, h0, chunk, return_state):
    return _with_state(ssd_scan_cuda, x, dt, a, bmat, cmat, d, h0, chunk, return_state)


def _with_state(fn, x, dt, a, bmat, cmat, d, h0, chunk, return_state):
    """``(y, final state)``, the state empty unless ``return_state``."""
    out = fn(x, dt, a, bmat, cmat, d, chunk=chunk, initial_state=h0, return_state=return_state)
    return out if return_state else (out, x.new_empty((0,), dtype=torch.float32))


@_serve_op.register_fake
def _serve_fake(x, dt, a, bmat, cmat, d, h0, chunk, return_state):
    b, l, h, p = x.shape
    n = bmat.shape[3]
    plan(b, l, h, p, bmat.shape[2], n, chunk, x.dtype)
    y = x.new_empty(x.shape, dtype=x.dtype if d is None else torch.promote_types(x.dtype, d.dtype))
    return y, x.new_empty((b, h, p, n) if return_state else (0,), dtype=torch.float32)


def ssd_scan_op(x, dt, a, bmat, cmat, d=None, *, chunk=128, initial_state=None,
                return_state=False):
    """The serving arm through its op ``repro_torch::ssd_scan``:
    :func:`ssd_scan_cuda` on CUDA tensors, the fake on meta tensors."""
    y, h1 = _serve_op(x, dt, a, bmat, cmat, d, initial_state, int(chunk), bool(return_state))
    return (y, h1) if return_state else y


@torch.library.custom_op("repro_torch::ssd_scan_fwd", mutates_args=())
def _fwd_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
            cmat: torch.Tensor, h0: Optional[torch.Tensor], chunk: int,
            plain: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    return ssd_fwd_plain(x, dt, a, bmat, cmat, h0, chunk=chunk)


@_fwd_op.register_kernel("cuda")
def _fwd_cuda(x, dt, a, bmat, cmat, h0, chunk, plain):
    fn = ssd_fwd_plain if plain else ssd_scan_fwd_cuda
    return fn(x, dt, a, bmat, cmat, h0, chunk=chunk)


@_fwd_op.register_fake
def _fwd_fake(x, dt, a, bmat, cmat, h0, chunk, plain):
    b, l, h, p = x.shape
    n = bmat.shape[3]
    c = _chunk(chunk, l)
    f32 = dict(dtype=torch.float32)
    return (x.new_empty(x.shape), x.new_empty((b, h, p, n), **f32),
            x.new_empty((b, h, _runtime.cdiv(l, c), p, n), **f32),
            x.new_empty((b, h, _runtime.cdiv(l, c), c), **f32))


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=())
def _bwd_op(dy: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            bmat: torch.Tensor, cmat: torch.Tensor, h0: Optional[torch.Tensor],
            hs: torch.Tensor, cs: torch.Tensor, dh_last: Optional[torch.Tensor], chunk: int,
            plain: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor, torch.Tensor]:
    return ssd_bwd_plain(dy, x, dt, a, bmat, cmat, h0, hs, cs, dh_last, chunk=chunk)


@_bwd_op.register_kernel("cuda")
def _bwd_cuda(dy, x, dt, a, bmat, cmat, h0, hs, cs, dh_last, chunk, plain):
    fn = ssd_bwd_plain if plain else ssd_scan_bwd_cuda
    return fn(dy, x, dt, a, bmat, cmat, h0, hs, cs, dh_last, chunk=chunk)


@_bwd_op.register_fake
def _bwd_fake(dy, x, dt, a, bmat, cmat, h0, hs, cs, dh_last, chunk, plain):
    b, _, h, p = x.shape
    f32 = dict(dtype=torch.float32)
    return (x.new_empty(x.shape), dt.new_empty(dt.shape), a.new_empty(a.shape),
            bmat.new_empty(bmat.shape), cmat.new_empty(cmat.shape),
            x.new_empty((b, h, p, bmat.shape[3]), **f32))


@torch.library.custom_op("repro_torch::ssd_scan_jvp", mutates_args=())
def _jvp_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
            cmat: torch.Tensor, h0: Optional[torch.Tensor], hs: torch.Tensor, cs: torch.Tensor,
            tx: torch.Tensor, tdt: torch.Tensor, ta: torch.Tensor, tb: torch.Tensor,
            tc: torch.Tensor, th0: Optional[torch.Tensor], chunk: int,
            plain: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    return ssd_jvp_plain(x, dt, a, bmat, cmat, h0, hs, cs, tx, tdt, ta, tb, tc, th0, chunk=chunk)


@_jvp_op.register_kernel("cuda")
def _jvp_cuda(x, dt, a, bmat, cmat, h0, hs, cs, tx, tdt, ta, tb, tc, th0, chunk, plain):
    fn = ssd_jvp_plain if plain else ssd_scan_jvp_cuda
    return fn(x, dt, a, bmat, cmat, h0, hs, cs, tx, tdt, ta, tb, tc, th0, chunk=chunk)


@_jvp_op.register_fake
def _jvp_fake(x, dt, a, bmat, cmat, h0, hs, cs, tx, tdt, ta, tb, tc, th0, chunk, plain):
    b, _, h, p = x.shape
    return x.new_empty(x.shape), x.new_empty((b, h, p, bmat.shape[3]), dtype=torch.float32)


class SSDScan(torch.autograd.Function):
    """The SSD scan whose forward saves the chunk-entry states and ``cs``,
    whose backward is the ``bwd`` arm and whose forward-mode derivative is
    the ``jvp`` arm (``torch.func.grad``, ``vjp``, ``jvp`` and ``linearize``
    all go through the arms).  ``apply(x, dt, a, bmat, cmat, h0, chunk,
    plain)`` returns ``(y, final state, H, cs)``: ``y`` without the D skip,
    differentiable in every input and ``h0`` (None for a zero state); ``H``
    and ``cs`` are not differentiable."""

    @staticmethod
    def forward(x, dt, a, bmat, cmat, h0, chunk, plain):
        return _fwd_op(x, dt, a, bmat, cmat, h0, chunk, plain)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, a, bmat, cmat, h0, chunk, plain = inputs
        _, _, hs, cs = output
        ctx.mark_non_differentiable(hs, cs)
        ctx.save_for_backward(x, dt, a, bmat, cmat, h0, hs, cs)
        ctx.save_for_forward(x, dt, a, bmat, cmat, h0, hs, cs)
        ctx.args = (chunk, plain)

    @staticmethod
    def backward(ctx, dy, dh_last, _dhs, _dcs):
        x, dt, a, bmat, cmat, h0, hs, cs = ctx.saved_tensors
        # Under torch.func.grad a custom op called here must not be
        # recorded again (no double backward is offered).
        with torch.no_grad():
            dx, ddt, da, db, dc, dh0 = _bwd_op(dy.to(x.dtype), x, dt, a, bmat, cmat, h0, hs, cs,
                                               dh_last, *ctx.args)
        return dx, ddt, da, db, dc, (dh0 if h0 is not None else None), None, None

    @staticmethod
    def jvp(ctx, tx, tdt, ta, tb, tc, th0, *_):
        x, dt, a, bmat, cmat, h0, hs, cs = ctx.saved_tensors
        tx, tdt, ta, tb, tc = (torch.zeros_like(v) if t is None else t
                               for v, t in ((x, tx), (dt, tdt), (a, ta), (bmat, tb), (cmat, tc)))
        ty, th1 = _jvp_op(x, dt, a, bmat, cmat, h0, hs, cs, tx, tdt, ta, tb, tc, th0, *ctx.args)
        return ty, th1, None, None


def ssd_differentiable(x, dt, a, bmat, cmat, *, chunk=128, initial_state=None, plain=False):
    """The scan through :class:`SSDScan`: the kernels on CUDA tensors (their
    plain versions with ``plain``, or off the card).  Returns ``(y, final
    state)``, ``y`` without the D skip."""
    y, h1, _, _ = SSDScan.apply(x, dt, a, bmat, cmat, initial_state, int(chunk), bool(plain))
    return y, h1


def _scratch(shapes: dict) -> int:
    """Bytes of the f32 scratch ``shapes`` (a plan's) name."""
    return sum(4 * math.prod(shape) for shape in shapes.values())


def _count(x, bmat, chunk, arm, scratch):
    """``(operations, bytes, scratch bytes)`` of one call of ``arm`` (None:
    the forward) on ``x`` and ``bmat``'s shapes, ``scratch(plan, grad
    plan)`` the bytes the wrapper allocates around the launch."""
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    pl, gp = plan(b, l, h, p, g, n, chunk, x.dtype), grad_plan(b, l, h, p, g, n, chunk, x.dtype)
    if arm is None:
        nbytes, ops = work.ssd_work(b, l, h, p, g, n, pl["chunk"], x.element_size())
    else:
        nbytes, ops = work.ssd_grad_work(b, l, h, p, g, n, pl["chunk"], x.element_size(), arm)
    return ops, nbytes, scratch(pl, gp)


work.count_op(torch.ops.repro_torch.ssd_scan,
              lambda x, dt, a, bmat, cmat, d, h0, chunk, rs: _count(
                  x, bmat, chunk, None, lambda pl, gp: _scratch(pl["scratch"])
                  + (0 if d is None else work.nbytes(x)) + work.copies(dt, a, h0)))
work.count_op(torch.ops.repro_torch.ssd_scan_fwd,
              lambda x, dt, a, bmat, cmat, h0, chunk, plain: _count(
                  x, bmat, chunk, None, lambda pl, gp: 4 * math.prod(pl["scratch"]["decay"])
                  + work.copies(dt, a, h0)))
work.count_op(torch.ops.repro_torch.ssd_scan_bwd,
              lambda dy, x, dt, a, bmat, cmat, h0, hs, cs, dh_last, chunk, plain: _count(
                  x, bmat, chunk, "bwd", lambda pl, gp: _scratch(gp["bwd_scratch"])
                  + work.copies(dy, dt, a, dh_last)))
work.count_op(torch.ops.repro_torch.ssd_scan_jvp,
              lambda x, dt, a, bmat, cmat, h0, hs, cs, tx, tdt, ta, tb, tc, th0, chunk, plain:
              _count(x, bmat, chunk, "jvp", lambda pl, gp: _scratch(gp["jvp_scratch"])
                     + work.copies(tx, tb, tc, dt, a, tdt, ta, th0)))
