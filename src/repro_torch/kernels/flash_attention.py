"""GQA softmax attention on the H100: a hand-written CUDA kernel (K9).

``flash_attention_cuda`` replaces ``flash_attention_pallas``
(``repro/kernels/flash_attention.py:116``, body ``_flash_kernel`` :33):
online-softmax attention of ``q`` (b, h, sq, dh) against ``k``/``v``
(b, hkv, sk, dh), query head ``i`` reading KV head ``i // (h / hkv)``,
keys past ``sk`` masked and, under ``causal``, keys above ``q_offset + i``
masked and whole key tiles above a query tile's last row skipped.  The
running max starts at the reference's finite sentinel ``-1e30``, the max,
normaliser and accumulator are f32, a row whose normaliser ends at 0
gives zeros, and the output is in ``q.dtype``.  The CUDA source is
``csrc/flash_attention.cu`` (f32 and bf16, ``dh`` in {16, 32, 64, 128,
160}, 160 being stablelm-12b's 5120 / 32, a native instantiation),
whose header says what bounds it and how its tiles are laid out; the
kernel masks ragged edges instead of padding copies, and each output tile
is written by one block, so two launches agree bit for bit.

bf16 inputs run on the tensor cores (``mma.sync`` m16n8k16, f32
accumulators); f32 inputs run the Pallas body's f32 arithmetic on the
CUDA cores (no TF32).  The two arithmetics differ in one place: in bf16
the probabilities ``p`` are rounded to bf16 before ``p @ v``, as every
tensor-core flash kernel does, while the Pallas body keeps ``p`` in f32.

Beside it sits its plain PyTorch version, ``flash_attention_plain``: the
blocked online-softmax loop of ``repro/kernels/ops.py:_attention_chunked``
(score memory ``block_q × block_k``, linear in ``sk``) with the kernel's
arithmetic: every product and sum in f32 on inputs widened from
``q.dtype``, and ``p`` rounded to ``q.dtype`` before ``p @ v`` (a no-op
in f32), so that the two differ by summation order alone: the CPU path
and the card's yardstick.  (The reference's chunked loop rounds the
scores and ``p @ v`` to ``q.dtype``, since its einsums return that dtype.)

Training differentiates attention, which the TPU kernel leaves to JAX's
autodiff of the reference's chunked lowering.  Three more arms, each a
kernel of ``csrc/flash_attention.cu`` beside its plain version
(``q_offset`` 0, f32 and bf16, the same head dims):

* ``lse`` — the forward also writes the f32 row log-sum-exp (natural log);
* ``bwd`` — ``(dq, dk, dv)`` from ``dO``, ``O`` and the lse, recomputing
  ``P`` (FA2's deterministic two-kernel layout, no float atomics);
* ``jvp`` — the output tangent for input tangents, in one pass.

As the forward, bf16 arms run on the tensor cores and f32 arms on the CUDA
cores.  The bf16 arms round to bf16 only where a product takes an operand
(P for dV, dS for dQ and dK, P and T = P ∘ Ṡ for the tangent's two
products); the plain versions round at the same points (no-ops in f32).

They run as ``torch.library`` custom ops inside :class:`FlashAttention`,
an ``autograd.Function`` with a backward and a forward-mode rule, so that
autograd and every ``torch.func`` transform (``linearize`` included, which
traces the tangent map) record them as calls.  :func:`kernels.ops.attention`
takes that route whenever a derivative is being taken through its inputs,
and the serving arm's op (:func:`flash_attention_op`) otherwise.  On meta
tensors each op's fake gives the outputs' shapes and its count (the
operations and bytes of :mod:`repro_torch.kernels.work`, the wrapper's
scratch), so a dry-run traced on the meta device sees the kernel's work,
not its plain version's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _runtime, work

NEG_INF = -1e30  # the reference's finite mask sentinel
HEAD_DIMS = (16, 32, 64, 128, 160)
DTYPES = (torch.float32, torch.bfloat16)

_P, _I, _L, _D = _runtime.PTR, _runtime.INT, _runtime.INT64, _runtime.DOUBLE
_SIGNATURE = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _D, _I, _L)
_SIGNATURE_LSE = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _D, _I, _L)
_SIGNATURE_BWD = (_P,) * 10 + (_I,) * 6 + (_D, _I)
_SIGNATURE_JVP = (_P,) * 9 + (_I,) * 6 + (_D, _I)


def _shapes(q, k):
    """``(b, h, hkv, sq, sk, dh)``, refusing what the kernels do not take."""
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: {h} query heads over {hkv} KV heads")
    if sq == 0 or sk == 0 or b * h > 65535:
        raise ValueError(f"flash_attention: need sq, sk >= 1 and b*h <= 65535, got {q.shape}, {k.shape}")
    return b, h, hkv, sq, sk, dh


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention on the card; ``q`` (b, h, sq, dh), ``k``/``v`` (b, hkv,
    sk, dh) in f32 or bf16.  Non-contiguous inputs are copied first."""
    b, h, hkv, sq, sk, dh = _shapes(q, k)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _runtime.check("flash_attention", q, DTYPES, q=(q, (b, h, sq, dh)),
                   k=(k, (b, hkv, sk, dh)), v=(v, (b, hkv, sk, dh)))
    out = torch.empty_like(q)
    scale = dh**-0.5 if scale is None else float(scale)
    p = _runtime.ptr
    _runtime.launch(
        "flash_attention", "flash_attention", _SIGNATURE, q,
        p(q), p(k), p(v), p(out), b, h, hkv, sq, sk, dh, scale, int(causal), int(q_offset),
    )
    return out


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    block_q: int = 512,
    block_k: int = 1024,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention_cuda`: query blocks
    of ``block_q`` rows against key blocks of ``block_k``, carrying the
    ``(m, l, acc)`` online-softmax state; all arithmetic in f32, as the
    kernel's, with ``p`` rounded to ``q.dtype`` before ``p @ v``."""
    return _flash_plain(q, k, v, causal, scale, q_offset, block_q, block_k, want_lse=False)


def flash_attention_lse_plain(q, k, v, *, causal=False, scale=None, block_q=512, block_k=1024):
    """Plain version of :func:`flash_attention_lse_cuda`: the output of
    :func:`flash_attention_plain` (the same arithmetic) and the f32 row
    log-sum-exp ``m + log l`` (natural log; ``+inf`` where ``l`` is 0)."""
    return _flash_plain(q, k, v, causal, scale, 0, block_q, block_k, want_lse=True)


def _flash_plain(q, k, v, causal, scale, q_offset, block_q, block_k, want_lse):
    _runtime.note_plain("flash_attention", q)
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = dh**-0.5 if scale is None else scale
    bq, bk = min(block_q, sq), min(block_k, sk)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if want_lse else None
    dev = q.device
    for q0 in range(0, sq, bq):
        qi = q[:, :, q0 : q0 + bq].float()
        rows = qi.shape[2]
        qpos = q_offset + q0 + torch.arange(rows, device=dev)[:, None]
        m = torch.full((b, h, rows, 1), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, rows, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, rows, dh), dtype=torch.float32, device=dev)
        for k0 in range(0, sk, bk):
            kj = k[:, :, k0 : k0 + bk].float().repeat_interleave(group, dim=1)
            vj = v[:, :, k0 : k0 + bk].float().repeat_interleave(group, dim=1)
            s = torch.einsum("bhqd,bhkd->bhqk", qi, kj) * scale
            kpos = k0 + torch.arange(kj.shape[2], device=dev)[None, :]
            mask = kpos < sk
            if causal:
                mask = mask & (kpos <= qpos)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            # P rounds to the inputs' dtype before P V, as the kernel's
            # tensor-core product takes it (a no-op in f32).
            pv = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), vj)
            acc = acc * corr + pv
            m = m_new
        if want_lse:
            lse[:, :, q0 : q0 + bq] = torch.where(l == 0.0, torch.inf, m + torch.log(l))[..., 0]
        l = torch.where(l == 0.0, 1.0, l)
        out[:, :, q0 : q0 + bq] = (acc / l).to(q.dtype)
    return (out, lse) if want_lse else out


# ---------------------------------------------------------------------------
# The differentiated arms: forward with LSE, backward, forward mode (JVP)
# ---------------------------------------------------------------------------


def _check_lse(lse, b, h, sq, like):
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq) or lse.device != like.device:
        raise ValueError(f"flash_attention: lse must be ({b}, {h}, {sq}) float32 on {like.device}")
    return lse.contiguous()


def flash_attention_lse_cuda(q, k, v, *, causal=False, scale=None):
    """The forward of a differentiated call on the card: ``(out, lse)``,
    ``lse`` the f32 (b, h, sq) row log-sum-exp of the scaled scores in
    natural-log units (the arm ``flash_attention:lse``; ``q_offset`` 0)."""
    b, h, hkv, sq, sk, dh = _shapes(q, k)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _runtime.check("flash_attention", q, DTYPES, q=(q, (b, h, sq, dh)),
                   k=(k, (b, hkv, sk, dh)), v=(v, (b, hkv, sk, dh)))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    scale = dh**-0.5 if scale is None else float(scale)
    p = _runtime.ptr
    _runtime.launch("flash_attention", "flash_attention_lse", _SIGNATURE_LSE, q,
                    p(q), p(k), p(v), p(out), p(lse), b, h, hkv, sq, sk, dh, scale, int(causal), 0,
                    key="flash_attention", arm="lse")
    return out, lse


def flash_attention_bwd_cuda(dout, q, k, v, out, lse, *, causal=False, scale=None):
    """``(dq, dk, dv)`` on the card from the forward's ``out`` and ``lse``
    (the arm ``flash_attention:bwd``: three launches, one count)."""
    b, h, hkv, sq, sk, dh = _shapes(q, k)
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    _runtime.check("flash_attention", q, DTYPES, q=(q, (b, h, sq, dh)),
                   k=(k, (b, hkv, sk, dh)), v=(v, (b, hkv, sk, dh)), out=(out, (b, h, sq, dh)),
                   dout=(dout, (b, h, sq, dh)))
    lse = _check_lse(lse, b, h, sq, q)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dvec = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    scale = dh**-0.5 if scale is None else float(scale)
    p = _runtime.ptr
    _runtime.launch("flash_attention", "flash_attention_bwd", _SIGNATURE_BWD, q,
                    p(q), p(k), p(v), p(out), p(lse), p(dout), p(dq), p(dk), p(dv), p(dvec),
                    b, h, hkv, sq, sk, dh, scale, int(causal), key="flash_attention", arm="bwd")
    return dq, dk, dv


def flash_attention_jvp_cuda(q, k, v, out, lse, tq, tk, tv, *, causal=False, scale=None):
    """The tangent of ``out`` for tangents ``(tq, tk, tv)`` of the inputs on
    the card (the arm ``flash_attention:jvp``)."""
    b, h, hkv, sq, sk, dh = _shapes(q, k)
    q, k, v, out, tq, tk, tv = (t.contiguous() for t in (q, k, v, out, tq, tk, tv))
    _runtime.check("flash_attention", q, DTYPES, q=(q, (b, h, sq, dh)),
                   k=(k, (b, hkv, sk, dh)), v=(v, (b, hkv, sk, dh)), out=(out, (b, h, sq, dh)),
                   tq=(tq, (b, h, sq, dh)), tk=(tk, (b, hkv, sk, dh)), tv=(tv, (b, hkv, sk, dh)))
    lse = _check_lse(lse, b, h, sq, q)
    tout = torch.empty_like(q)
    scale = dh**-0.5 if scale is None else float(scale)
    p = _runtime.ptr
    _runtime.launch("flash_attention", "flash_attention_jvp", _SIGNATURE_JVP, q,
                    p(q), p(k), p(v), p(out), p(lse), p(tq), p(tk), p(tv), p(tout),
                    b, h, hkv, sq, sk, dh, scale, int(causal), key="flash_attention", arm="jvp")
    return tout


def _score_blocks(q, k, v, lse, causal, scale, block_q, block_k):
    """The blocked loop the plain backward and JVP share: for every query
    block and every key block it sees, ``(q0, k0, rows, P, kj, vj)`` with
    ``P = exp(scale·q kᵀ − lse)`` (zero where masked) in f32 and ``kj``,
    ``vj`` the key block widened to f32 and repeated over each GQA group;
    under causal masking key blocks past a query block's last row are
    skipped (their P is zero)."""
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    bq, bk = min(block_q, sq), min(block_k, sk)
    dev = q.device
    for q0 in range(0, sq, bq):
        qi = q[:, :, q0 : q0 + bq].float()
        rows = qi.shape[2]
        qpos = q0 + torch.arange(rows, device=dev)[:, None]
        lse_i = lse[:, :, q0 : q0 + bq, None]
        for k0 in range(0, sk, bk):
            if causal and k0 > q0 + rows - 1:
                break
            kj = k[:, :, k0 : k0 + bk].float().repeat_interleave(group, dim=1)
            vj = v[:, :, k0 : k0 + bk].float().repeat_interleave(group, dim=1)
            kpos = k0 + torch.arange(kj.shape[2], device=dev)[None, :]
            mask = kpos < sk
            if causal:
                mask = mask & (kpos <= qpos)
            s = torch.einsum("bhqd,bhkd->bhqk", qi, kj) * scale
            p = torch.where(mask, torch.exp(s - lse_i), 0.0)
            yield q0, k0, rows, qi, p, kj, vj


def _group_sum(t, hkv):
    """(b, h, s, d) per query head → (b, hkv, s, d) summed over each group."""
    b, h, s, d = t.shape
    return t.view(b, hkv, h // hkv, s, d).sum(dim=2)


def flash_attention_bwd_plain(dout, q, k, v, out, lse, *, causal=False, scale=None,
                              block_q=512, block_k=1024):
    """Plain version of :func:`flash_attention_bwd_cuda`: the blocked loop
    of :func:`flash_attention_plain` recomputing ``P`` from ``lse``, in f32,
    with ``D = rowsum(dO ∘ O)``, ``dV += round(P)ᵀ dO``, ``dS = P ∘ (dO Vᵀ −
    D)·scale``, ``dQ = round(dS) K`` and ``dK = round(dS)ᵀ Q``; K and V's
    gradients summed over each GQA group.  ``round`` is the cast to
    ``q.dtype`` where the bf16 kernels' tensor-core products take an operand
    (a no-op in f32)."""
    _runtime.note_plain("flash_attention", q)
    dq, dk, dv = _bwd_sums(dout, q, k, v, out, lse, causal, scale, block_q, block_k)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_sums(dout, q, k, v, out, lse, causal, scale, block_q, block_k):
    """:func:`flash_attention_bwd_plain`'s f32 sums, before the cast to the
    inputs' dtypes."""
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = dh**-0.5 if scale is None else scale
    d = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    dq = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, h, sk, dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0, k0, rows, qi, p, kj, vj in _score_blocks(q, k, v, lse, causal, scale, block_q,
                                                     block_k):
        doi = dout[:, :, q0 : q0 + rows].float()
        cols = kj.shape[2]
        dv[:, :, k0 : k0 + cols] += torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).float(), doi)
        dp = torch.einsum("bhqd,bhkd->bhqk", doi, vj)
        ds = (p * (dp - d[:, :, q0 : q0 + rows]) * scale).to(q.dtype).float()
        dq[:, :, q0 : q0 + rows] += torch.einsum("bhqk,bhkd->bhqd", ds, kj)
        dk[:, :, k0 : k0 + cols] += torch.einsum("bhqk,bhqd->bhkd", ds, qi)
    return dq, _group_sum(dk, hkv), _group_sum(dv, hkv)


def flash_attention_jvp_plain(q, k, v, out, lse, tq, tk, tv, *, causal=False, scale=None,
                              block_q=512, block_k=1024):
    """Plain version of :func:`flash_attention_jvp_cuda`, in f32:
    ``Ȯ = Σⱼ (round(Tᵢⱼ) vⱼ + round(Pᵢⱼ) v̇ⱼ) − (Σⱼ Tᵢⱼ)·oᵢ`` with ``T = P ∘
    Ṡ``, ``Ṡ = scale·(q̇ kᵀ + q k̇ᵀ)`` and ``P`` recomputed from ``lse``;
    ``round`` is the cast to ``q.dtype`` (a no-op in f32) and ``r = Σⱼ T``
    sums the unrounded T."""
    _runtime.note_plain("flash_attention", q)
    return _jvp_sums(q, k, v, out, lse, tq, tk, tv, causal, scale, block_q, block_k).to(q.dtype)


def _jvp_sums(q, k, v, out, lse, tq, tk, tv, causal, scale, block_q, block_k):
    """:func:`flash_attention_jvp_plain`'s f32 result, before the cast to
    ``q.dtype``."""
    b, h, sq, dh = q.shape
    group = h // k.shape[1]
    scale = dh**-0.5 if scale is None else scale
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    r = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    for q0, k0, rows, qi, p, kj, vj in _score_blocks(q, k, v, lse, causal, scale, block_q,
                                                     block_k):
        cols = kj.shape[2]
        tqi = tq[:, :, q0 : q0 + rows].float()
        tkj = tk[:, :, k0 : k0 + cols].float().repeat_interleave(group, dim=1)
        tvj = tv[:, :, k0 : k0 + cols].float().repeat_interleave(group, dim=1)
        sdot = (torch.einsum("bhqd,bhkd->bhqk", tqi, kj)
                + torch.einsum("bhqd,bhkd->bhqk", qi, tkj)) * scale
        t = p * sdot
        r[:, :, q0 : q0 + rows] += t.sum(dim=-1, keepdim=True)
        acc[:, :, q0 : q0 + rows] += (
            torch.einsum("bhqk,bhkd->bhqd", t.to(q.dtype).float(), vj)
            + torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), tvj))
    return acc - r * out.float()


# The serving arm and the three differentiated arms as custom ops, so that
# autograd, torch.func, make_fx (``torch.func.linearize``) and the dry-run's
# trace on the meta device record them as calls: a kernel launched through
# raw pointers is invisible to a tracer.  The CUDA implementation launches
# the kernel (or, with ``plain``, runs the plain version on the card, the
# yardstick ``backend="plain"`` asks for); on the meta device the fake gives
# the output's shape and ``work`` the kernel's count; on any other device
# the plain version runs.


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _serve_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, scale: float,
              q_offset: int) -> torch.Tensor:
    return flash_attention_plain(q, k, v, causal=causal, scale=scale, q_offset=q_offset)


@_serve_op.register_kernel("cuda")
def _serve_cuda(q, k, v, causal, scale, q_offset):
    return flash_attention_cuda(q, k, v, causal=causal, scale=scale, q_offset=q_offset)


@_serve_op.register_fake
def _serve_fake(q, k, v, causal, scale, q_offset):
    _shapes(q, k)
    return q.new_empty(q.shape)


def flash_attention_op(q, k, v, *, causal=False, scale=None, q_offset=0):
    """The serving arm through its op ``repro_torch::flash_attention``:
    :func:`flash_attention_cuda` on CUDA tensors, the fake on meta
    tensors."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _serve_op(q, k, v, bool(causal), scale, int(q_offset))


def _lse_plain_contiguous(q, k, v, causal, scale):
    out, lse = flash_attention_lse_plain(q, k, v, causal=causal, scale=scale)
    return out.contiguous(), lse


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=())
def _lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, scale: float,
            plain: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    return _lse_plain_contiguous(q, k, v, causal, scale)


@_lse_op.register_kernel("cuda")
def _lse_cuda(q, k, v, causal, scale, plain):
    if plain:
        return _lse_plain_contiguous(q, k, v, causal, scale)
    return flash_attention_lse_cuda(q, k, v, causal=causal, scale=scale)


@_lse_op.register_fake
def _lse_fake(q, k, v, causal, scale, plain):
    return q.new_empty(q.shape), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _bwd_op(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, lse: torch.Tensor, causal: bool, scale: float,
            plain: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal, scale=scale)


@_bwd_op.register_kernel("cuda")
def _bwd_cuda(dout, q, k, v, out, lse, causal, scale, plain):
    if plain:
        return flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal, scale=scale)
    return flash_attention_bwd_cuda(dout, q, k, v, out, lse, causal=causal, scale=scale)


@_bwd_op.register_fake
def _bwd_fake(dout, q, k, v, out, lse, causal, scale, plain):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@torch.library.custom_op("repro_torch::flash_attention_jvp", mutates_args=())
def _jvp_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
            lse: torch.Tensor, tq: torch.Tensor, tk: torch.Tensor, tv: torch.Tensor,
            causal: bool, scale: float, plain: bool) -> torch.Tensor:
    return flash_attention_jvp_plain(q, k, v, out, lse, tq, tk, tv, causal=causal, scale=scale)


@_jvp_op.register_kernel("cuda")
def _jvp_cuda(q, k, v, out, lse, tq, tk, tv, causal, scale, plain):
    fn = flash_attention_jvp_plain if plain else flash_attention_jvp_cuda
    return fn(q, k, v, out, lse, tq, tk, tv, causal=causal, scale=scale)


@_jvp_op.register_fake
def _jvp_fake(q, k, v, out, lse, tq, tk, tv, causal, scale, plain):
    return q.new_empty(q.shape)


class FlashAttention(torch.autograd.Function):
    """Attention whose forward saves the row log-sum-exp, whose backward is
    the ``bwd`` arm and whose forward-mode derivative is the ``jvp`` arm
    (``torch.func.grad``, ``vjp``, ``jvp`` and ``linearize`` all go through
    the arms).  ``apply(q, k, v, causal, scale, plain)`` returns ``(out,
    lse)``; ``lse`` is not differentiable."""

    @staticmethod
    def forward(q, k, v, causal, scale, plain):
        return _lse_op(q, k, v, causal, scale, plain)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, scale, plain = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.save_for_forward(q, k, v, out, lse)
        ctx.args = (causal, scale, plain)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        # Under torch.func.grad a custom op called here must not be
        # recorded again (no double backward is offered).
        with torch.no_grad():
            dq, dk, dv = _bwd_op(dout.to(q.dtype), q, k, v, out, lse, *ctx.args)
        return dq, dk, dv, None, None, None

    @staticmethod
    def jvp(ctx, tq, tk, tv, *_):
        q, k, v, out, lse = ctx.saved_tensors
        tq, tk, tv = (torch.zeros_like(x) if t is None else t for x, t in ((q, tq), (k, tk), (v, tv)))
        return _jvp_op(q, k, v, out, lse, tq, tk, tv, *ctx.args), None


def flash_attention_differentiable(q, k, v, *, causal=False, scale=None, plain=False):
    """Attention through :class:`FlashAttention`: the kernels on CUDA
    tensors (their plain versions with ``plain``, or off the card), with
    ``q_offset`` 0."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return FlashAttention.apply(q, k, v, causal, scale, plain)[0]


def _count(q, k, causal, arm, *copied, scratch=0):
    b, h, hkv, sq, sk, dh = _shapes(q, k)
    if arm is None:
        nbytes, ops = work.attn_work(b, h, hkv, sq, sk, dh, causal, q.element_size())
    else:
        nbytes, ops = work.grad_work(b, h, hkv, sq, sk, dh, causal, q.element_size(), arm)
    return ops, nbytes, work.copies(*copied) + scratch


work.count_op(torch.ops.repro_torch.flash_attention,
              lambda q, k, v, causal, *_: _count(q, k, causal, None, q, k, v))
work.count_op(torch.ops.repro_torch.flash_attention_lse,
              lambda q, k, v, causal, *_: _count(q, k, causal, "lse", q, k, v))
work.count_op(torch.ops.repro_torch.flash_attention_bwd,
              lambda dout, q, k, v, out, lse, causal, *_: _count(
                  q, k, causal, "bwd", q, k, v, out, dout, scratch=4 * lse.numel()))
work.count_op(torch.ops.repro_torch.flash_attention_jvp,
              lambda q, k, v, out, lse, tq, tk, tv, causal, *_: _count(
                  q, k, causal, "jvp", q, k, v, out, tq, tk, tv))
