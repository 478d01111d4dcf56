"""K9's bf16 backward and forward-mode schedules, emulated in torch on the CPU.

The tensor-core kernels of ``csrc/flash_attention.cu`` (``namespace grad``:
``attn_bwd_dkdv_tc``, ``attn_bwd_dq_tc``, ``attn_jvp_tc``) split the work
as below; :func:`dkdv`, :func:`dq` and :func:`jvp` walk the same split:

* dK / dV: a block owns 64 keys of one KV head, a warp 16 of them.  It
  loops over the query heads of its GQA group, then over the query tiles
  from ``t_first`` (the first tile with a row at or past its first key
  under causal masking, else 0), ``step`` rows a tile.  Per tile
  ``Sᵀ = K Qᵀ``, ``dPᵀ = V dOᵀ``, ``Pᵀ = 2^(Sᵀ·scale·log2 e − lse·log2 e)``
  and ``dSᵀ = Pᵀ ∘ (dPᵀ − D)·scale``, masked by position only on the
  warp's tiles that reach the diagonal or an edge; ``dV += round(Pᵀ) dO``,
  ``dK += round(dSᵀ) Q``.
* dQ: a block owns 64 query rows, a warp 16; per key tile of ``step``
  keys (only those at or below the tile's last row under causal masking)
  ``S``, ``dP``, ``P`` and ``dS`` as above and ``dQ += round(dS) K``.
* JVP: the dQ kernel's loop with ``S``, ``Ṡ = Q̇ Kᵀ + Q K̇ᵀ``, ``P``,
  ``T = P ∘ Ṡ·scale``, ``r += Σ T`` and ``acc += round(T) V + round(P) V̇``;
  ``Ȯ = acc − r·O``.

``step`` is 64 rows, 32 at dh 128; at dh 160 dK / dV stream 16 query rows
a step and dQ / the JVP 32 keys (``TcTiles<DH>::kStepQ`` / ``kStepK``).
Tiles past
``sq`` / ``sk`` are zero-filled, as ``cp.async`` fills them; the lse and
D of rows past ``sq`` are zeros.  ``round`` is the cast to the inputs'
dtype.  These are checks of the design, mirrored in Python: the card tests
(``tests/test_torch_cuda.py``) hold the kernels themselves to the plain
versions.

The shared-memory swizzle ``tc::swz<DH>`` is compiled from the CUDA source
with the host's C++ compiler and checked for every head dim: a bijection of
each row's 16-byte chunks, and 8 distinct bank groups for every ldmatrix
phase (8 consecutive rows from a multiple of 8, one chunk each).
"""

import math
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402

LOG2E = math.log2(math.e)
BLOCK = 64  # rows a block owns (keys in dK / dV, queries in dQ and the JVP)
WARP = 16  # rows a warp owns
# b, h, hkv, sq, sk, dh, causal: ragged tiles, GQA groups 2, 4 and 8,
# sq != sk both ways under causal masking (key tiles past every query row
# under causal masking run no step), dh 128 on 32-row steps, dh 160
# (stablelm-12b: h 32 over hkv 8) on 16-row dK / dV and 32-key dQ / JVP
# steps, ragged and not; seamless-m4t-large-v2's non-causal dh 64: one query
# row against a ragged 333 keys, a rectangular sq < sk.
CASES = [
    (1, 4, 2, 96, 96, 64, True),
    (2, 4, 1, 130, 70, 16, True),
    (1, 2, 1, 40, 200, 32, True),
    (1, 4, 4, 70, 150, 128, False),
    (1, 16, 2, 100, 70, 128, True),
    (1, 8, 2, 150, 150, 64, False),
    (1, 32, 8, 70, 70, 160, True),
    (1, 4, 1, 100, 130, 160, False),
    (1, 4, 4, 1, 333, 64, False),
    (1, 4, 2, 100, 333, 64, False),
]
BAR = {torch.float32: 1e-6, torch.bfloat16: 1e-2}  # of the plain version's max abs


def step(dh, arm="dkdv"):
    """Rows a streamed step takes: ``TcTiles<DH>::kStepQ`` (dK / dV's query
    tiles) or ``kStepK`` (dQ's and the JVP's key tiles)."""
    if dh <= 64:
        return 64
    return 16 if dh > 128 and arm == "dkdv" else 32


def _rows(x, r0, n):
    """Rows [r0, r0 + n) of the last-but-one axis in f32, zeros past the end."""
    part = x[..., r0 : r0 + n, :].float()
    pad = n - part.shape[-2]
    return torch.nn.functional.pad(part, (0, 0, 0, pad)) if pad else part


def _vec(x, r0, n):
    part = x[..., r0 : r0 + n].float()
    return torch.nn.functional.pad(part, (0, n - part.shape[-1]))


def _warp_edges(first, n):
    """Each warp's first row among ``n`` rows starting at ``first``, per row."""
    return first + WARP * (torch.arange(n) // WARP)


def _p(s, lse2, scale):
    return torch.exp2(s * (scale * LOG2E) - lse2)


def dkdv(q, k, v, dout, lse, d, causal, scale, mask="edges"):
    """dK and dV; ``mask`` "edges" masks as the kernel does, "all" every
    tile, "none" no tile."""
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group, nq = h // hkv, step(dh)
    rnd = lambda t: t.to(q.dtype).float()  # noqa: E731
    qg, dog = (x.view(b, hkv, group, sq, dh) for x in (q, dout))
    lg, dg = (x.view(b, hkv, group, sq) for x in (lse, d))
    dk = torch.zeros(b, hkv, sk, dh)
    dv = torch.zeros_like(dk)
    n_qt = -(-sq // nq)
    for k0 in range(0, sk, BLOCK):
        kt, vt = _rows(k, k0, BLOCK), _rows(v, k0, BLOCK)
        kw = _warp_edges(k0, BLOCK)[:, None]
        kpos = k0 + torch.arange(BLOCK)[:, None]
        acc_k, acc_v = torch.zeros_like(kt), torch.zeros_like(vt)
        for gi in range(group):
            for t in range(k0 // nq if causal else 0, n_qt):
                q0 = t * nq
                qt, dot = _rows(qg[:, :, gi], q0, nq), _rows(dog[:, :, gi], q0, nq)
                lt, dt = (_vec(x[:, :, gi], q0, nq)[..., None, :] for x in (lg, dg))  # per column
                st = kt @ qt.transpose(-1, -2)
                dpt = vt @ dot.transpose(-1, -2)
                p = _p(st, lt * LOG2E, scale)
                qpos = q0 + torch.arange(nq)[None, :]
                edge = (q0 + nq > sq) | (k0 + BLOCK > sk) | (causal & (kw + WARP - 1 > q0))
                edge = {"edges": edge, "all": True, "none": False}[mask]
                masked = (qpos >= sq) | (kpos >= sk) | (causal & (kpos > qpos))
                p = torch.where(edge & masked, 0.0, p)
                ds = p * (dpt - dt) * scale
                acc_v += rnd(p) @ dot
                acc_k += rnd(ds) @ qt
        n = min(BLOCK, sk - k0)
        dk[:, :, k0 : k0 + n], dv[:, :, k0 : k0 + n] = acc_k[:, :, :n], acc_v[:, :, :n]
    return dk, dv


def _key_tiles(q0, sq, sk, causal, bk):
    n = -(-sk // bk)
    if causal:
        n = min(n, (min(sq, q0 + BLOCK) - 1) // bk + 1)
    return n


def _query_loop(q, k, lse, causal, scale):
    """The dQ and JVP kernels' loop: for every 64-row query tile and every
    key tile it visits, ``(q0, k0, p, kv)`` with ``p`` masked as the kernels
    mask it and ``kv(x)`` the key tile of a (b, hkv, sk, dh) tensor, zeros
    past sk, repeated over the GQA group."""
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    bk = step(dh, "dq")
    for q0 in range(0, sq, BLOCK):
        qw = _warp_edges(q0, BLOCK)[:, None]
        qpos = q0 + torch.arange(BLOCK)[:, None]
        lt = _vec(lse, q0, BLOCK)[..., None] * LOG2E
        for t in range(_key_tiles(q0, sq, sk, causal, bk)):
            k0 = t * bk

            def kv(x, k0=k0):
                return _rows(x, k0, bk).repeat_interleave(h // hkv, dim=1)

            s = _rows(q, q0, BLOCK) @ kv(k).transpose(-1, -2)
            p = _p(s, lt, scale)
            kpos = k0 + torch.arange(bk)[None, :]
            edge = (k0 + bk > sk) | (causal & (k0 + bk - 1 > qw))
            masked = (kpos >= sk) | (causal & (kpos > qpos))
            yield q0, k0, torch.where(edge & masked, 0.0, p), kv


def dq(q, k, v, dout, lse, d, causal, scale):
    b, h, sq, dh = q.shape
    out = torch.zeros(b, h, sq, dh)
    acc = {}
    for q0, _, p, kv in _query_loop(q, k, lse, causal, scale):
        dp = _rows(dout, q0, BLOCK) @ kv(v).transpose(-1, -2)
        ds = p * (dp - _vec(d, q0, BLOCK)[..., None]) * scale
        acc[q0] = acc.get(q0, 0) + ds.to(q.dtype).float() @ kv(k)
    for q0, a in acc.items():
        n = min(BLOCK, sq - q0)
        out[:, :, q0 : q0 + n] = a[:, :, :n]
    return out


def jvp(q, k, v, o, lse, tq, tk, tv, causal, scale):
    b, h, sq, dh = q.shape
    rnd = lambda t: t.to(q.dtype).float()  # noqa: E731
    out = torch.zeros(b, h, sq, dh)
    acc, r = {}, {}
    for q0, _, p, kv in _query_loop(q, k, lse, causal, scale):
        sd = (_rows(tq, q0, BLOCK) @ kv(k).transpose(-1, -2)
              + _rows(q, q0, BLOCK) @ kv(tk).transpose(-1, -2))
        t = p * (sd * scale)
        r[q0] = r.get(q0, 0) + t.sum(dim=-1, keepdim=True)
        acc[q0] = acc.get(q0, 0) + rnd(t) @ kv(v) + rnd(p) @ kv(tv)
    for q0, a in acc.items():
        n = min(BLOCK, sq - q0)
        out[:, :, q0 : q0 + n] = (a - r[q0] * _rows(o, q0, BLOCK))[:, :, :n]
    return out


def _inputs(case, dtype):
    b, h, hkv, sq, sk, dh, causal = case
    rng = np.random.default_rng(sum(case[:6]))
    shapes = [(b, h, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh), (b, h, sq, dh),
              (b, h, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh)]
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32)).to(dtype) for s in shapes]


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_schedules_match_the_plain_versions(case, dtype):
    causal, scale = case[-1], case[5] ** -0.5
    q, k, v, dout, tq, tk, tv = _inputs(case, dtype)
    out, lse = fa.flash_attention_lse_plain(q, k, v, causal=causal, block_q=32, block_k=48)
    d = (dout.float() * out.float()).sum(dim=-1)
    want = fa.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal, block_q=32,
                                        block_k=48)
    dk, dv = dkdv(q, k, v, dout, lse, d, causal, scale)
    got = (dq(q, k, v, dout, lse, d, causal, scale), dk, dv)
    for g, w in zip(got, want):
        assert _rel(g.to(dtype), w) <= BAR[dtype]
    tan = jvp(q, k, v, out, lse, tq, tk, tv, causal, scale)
    want = fa.flash_attention_jvp_plain(q, k, v, out, lse, tq, tk, tv, causal=causal,
                                        block_q=32, block_k=48)
    assert _rel(tan.to(dtype), want) <= BAR[dtype]


def test_edge_masking_is_needed_where_the_schedule_applies_it():
    """Masking every tile changes nothing against the kernel's rule (the
    tiles it leaves unmasked need no mask), masking none changes dK and dV
    (the tiles it masks need it)."""
    case = CASES[0]
    causal, scale = case[-1], case[5] ** -0.5
    q, k, v, dout, *_ = _inputs(case, torch.float32)
    out, lse = fa.flash_attention_lse_plain(q, k, v, causal=causal)
    d = (dout.float() * out.float()).sum(dim=-1)
    base = dkdv(q, k, v, dout, lse, d, causal, scale)
    every = dkdv(q, k, v, dout, lse, d, causal, scale, mask="all")
    assert all(torch.equal(a, b_) for a, b_ in zip(base, every))
    none = dkdv(q, k, v, dout, lse, d, causal, scale, mask="none")
    assert all(_rel(a, b_) > 1e-2 for a, b_ in zip(none, base))


SOURCE = os.path.join(os.path.dirname(__file__), os.pardir, "src", "repro_torch", "csrc",
                      "flash_attention.cu")
SWZ_MAIN = r"""
#include <cstdio>
template <int DH>
void dump() {
  for (int row = 0; row < 64; ++row)
    for (int c = 0; c < DH / 8; ++c) std::printf("%d %d %d %d\n", DH, row, c, swz<DH>(row, c));
}
int main() { dump<16>(); dump<32>(); dump<64>(); dump<128>(); dump<160>(); }
"""


def test_swizzle_is_a_bank_conflict_free_bijection_per_row(tmp_path):
    """``tc::swz<DH>`` as the source has it, for the head dims the kernels
    take, over the 64 rows of the largest tile they load."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    text = open(SOURCE).read()
    m = re.search(r"template <int DH>\n__device__ __forceinline__ int swz\(.*?\n}\n", text,
                  re.S)
    assert m, "swz not found in the CUDA source"
    src = tmp_path / "swz.cpp"
    src.write_text("#define __device__\n#define __forceinline__ inline\n" + m.group(0)
                   + SWZ_MAIN)
    exe = tmp_path / "swz"
    subprocess.run([cxx, "-std=c++17", "-O1", "-o", str(exe), str(src)], check=True,
                   capture_output=True, timeout=120)
    rows = np.loadtxt(subprocess.run([str(exe)], check=True, capture_output=True,
                                     text=True, timeout=60).stdout.splitlines(), dtype=np.int64)
    assert set(rows[:, 0]) == set(fa.HEAD_DIMS)
    for dh in fa.HEAD_DIMS:
        part = rows[rows[:, 0] == dh]
        chunks = dh // 8
        off = part[:, 3].reshape(64, chunks)
        row = np.arange(64)[:, None]
        # a bijection of each row's chunks, 16-byte aligned
        assert (off % 8 == 0).all()
        assert (np.sort(off - row * dh, axis=1) == 8 * np.arange(chunks)).all(), dh
        # every ldmatrix phase: 8 rows from a multiple of 8, one chunk each,
        # on 8 distinct 16-byte bank groups (2-byte elements)
        group = (off * 2 // 16) % 8
        for r0 in range(0, 64, 8):
            for c in range(chunks):
                assert len(set(group[r0 : r0 + 8, c])) == 8, (dh, r0, c)
