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
``csrc/flash_attention.cu`` (f32 and bf16, ``dh`` in {16, 32, 64, 128}),
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
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _runtime

NEG_INF = -1e30  # the reference's finite mask sentinel
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

_P, _I, _L, _D = _runtime.PTR, _runtime.INT, _runtime.INT64, _runtime.DOUBLE
_SIGNATURE = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _D, _I, _L)


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
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: {h} query heads over {hkv} KV heads")
    if sq == 0 or sk == 0 or b * h > 65535:
        raise ValueError(f"flash_attention: need sq, sk >= 1 and b*h <= 65535, got {q.shape}, {k.shape}")
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
    _runtime.note_plain("flash_attention", q)
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = dh**-0.5 if scale is None else scale
    bq, bk = min(block_q, sq), min(block_k, sk)
    out = torch.empty_like(q)
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
        l = torch.where(l == 0.0, 1.0, l)
        out[:, :, q0 : q0 + bq] = (acc / l).to(q.dtype)
    return out
