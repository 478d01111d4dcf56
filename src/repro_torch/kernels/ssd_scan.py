"""The Mamba2 SSD chunked scan on the H100: a hand-written CUDA kernel (K10).

``ssd_scan_cuda`` replaces ``ssd_scan_pallas``
(``repro/kernels/ssd_scan.py:92``, body ``_ssd_kernel`` :41).  For each
(batch, head), chunk by chunk in order, with ``cs = cumsum(a·dt)`` inside
the chunk (f32, a fixed order)::

    G  = C Bᵀ                                   (c × c)
    M  = exp(cs_t − cs_s)·dt_s  for s ≤ t, else 0 (masked before the exp)
    Y  = (M ⊙ G) X + exp(cs)·(C H₀ᵀ)
    H₁ = exp(cs_c)·H₀ + Xᵀ(exp(cs_c − cs)·dt ⊙ B)

with the (p × n) f32 state carried across chunks.  Beyond the Pallas
kernel it takes an optional f32 initial state (b, h, p, n) and can return
the final one: the function ``repro/kernels/ops.py:_ssd_chunked`` computes
for ``initial_state=``/``return_state=True``, which the serving path's
prefill needs.  The padded tail of the last chunk has ``dt = 0``, so the
final state is exact.  B and C are read by group ``h // (h / g)``, never
repeated in memory.  The CUDA source is ``csrc/ssd_scan.cu`` (f32 and
bf16 inputs, f32 arithmetic; c ≤ 128, p ≤ 64, n ≤ 128), whose header says
what bounds it and how shared memory is laid out.

The D skip is added outside the kernel, as the reference adds it:
``y + x·d`` with ``y`` in ``x.dtype`` and ``d`` in f32, which promotes to
f32; the Mamba block casts back to its dtype afterwards.

Beside it sits its plain PyTorch version, ``ssd_plain``: ``_ssd_chunked``
in torch (one chunk at a time, the state carried in f32) with the Pallas
kernel's arithmetic, all of it in f32 on inputs widened from their dtype
(the reference's chunked scan forms ``C Bᵀ`` in the inputs' dtype
instead): the CPU path and the card's yardstick.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _runtime

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128
DTYPES = (torch.float32, torch.bfloat16)

_P, _I = _runtime.PTR, _runtime.INT
_SIGNATURE = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I)


def _chunk(chunk: int, l: int) -> int:
    """The Pallas kernel's chunk length: ``chunk``, or ``l`` rounded up to
    8 when the sequence is shorter."""
    return min(chunk, -(-l // 8) * 8)


def _skip(y: torch.Tensor, x: torch.Tensor, d: Optional[torch.Tensor]) -> torch.Tensor:
    return y if d is None else y + x * d[None, None, :, None]


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
    (b, l, g, n) in f32 or bf16, ``dt`` (b, l, h), ``a`` (h,) and
    ``initial_state`` (b, h, p, n) in f32.  Returns ``y`` (plus the final
    f32 state when ``return_state``)."""
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    c = _chunk(chunk, l)
    if l == 0 or g == 0 or h % g:
        raise ValueError(f"ssd_scan: need l >= 1 and {h} heads over {g} groups")
    if c > MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(
            f"ssd_scan: chunk {c}, head dim {p}, state {n} exceed "
            f"{MAX_CHUNK}, {MAX_HEAD_DIM}, {MAX_STATE}")
    x, bmat, cmat = x.contiguous(), bmat.contiguous(), cmat.contiguous()
    dt, a = dt.contiguous(), a.contiguous()
    _runtime.check("ssd_scan", x, DTYPES, x=(x, (b, l, h, p)), bmat=(bmat, (b, l, g, n)),
                   cmat=(cmat, (b, l, g, n)))
    h0 = None if initial_state is None else initial_state.contiguous()
    f32 = {"dt": (dt, (b, l, h)), "a": (a, (h,))}
    if h0 is not None:
        f32["initial_state"] = (h0, (b, h, p, n))
    _runtime.check("ssd_scan", dt, (torch.float32,), **f32)
    if dt.device != x.device:
        raise ValueError(f"ssd_scan: dt on {dt.device}, x on {x.device}")
    y = torch.empty_like(x)
    h1 = (torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
          if return_state else None)
    ptr = _runtime.ptr
    _runtime.launch(
        "ssd_scan", "ssd_scan", _SIGNATURE, x,
        ptr(x), ptr(dt), ptr(a), ptr(bmat), ptr(cmat), ptr(h0), ptr(y), ptr(h1),
        b, l, h, p, g, n, c,
    )
    y = _skip(y, x, d)
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
