"""K9's differentiated arms in the PyTorch port against autograd and the
JAX reference.

The forward with the row log-sum-exp, the backward and the forward-mode
(JVP) arm of ``repro_torch.kernels.flash_attention``, through their plain
versions (the CUDA kernels are held against these on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``):

* the plain backward and JVP against ``torch.autograd`` / ``torch.func``
  of ``flash_attention_plain`` (1e-6 of the output's max abs, f32);
* in bf16, the plain arms' f32 sums against the same sums rebuilt in f64
  from the plain pieces with dS (backward) and P and T (JVP) rounded to
  bf16 where the tensor-core kernels round them (1e-6 of the max abs), and
  in f32 the plain arms bit for bit the formulas they had before those
  rounding points were added (a cast to f32 is a no-op);
* both against ``jax.vjp`` / ``jax.jvp`` of the reference's
  ``ops.attention(impl="chunked")`` (the reference's training attention):
  2e-4 of the max abs in f32, 5e-2 in bf16, GQA, causal and not;
* :class:`FlashAttention` under ``loss.backward()``, ``torch.func.grad``,
  ``vjp``, ``jvp`` and ``linearize`` (whose replay must equal ``jvp``),
  and ``kernels.ops.attention``'s choice of it;
* the refusal of ``q_offset ≠ 0`` and K10's guard against a differentiated
  input (``_runtime.differentiated``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _runtime  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

# b, h, hkv, sq, sk, dh, causal: GQA with and without causal masking, a
# ragged causal block at dh = 128, a cross-attention shape; the encoder–
# decoder's (dh 64, non-causal): one query row against a ragged 333 keys,
# a rectangular cross call.
CASES = [
    (2, 4, 2, 64, 64, 32, False),
    (1, 8, 2, 96, 96, 64, True),
    (1, 4, 1, 33, 33, 128, True),
    (1, 2, 1, 40, 72, 16, False),
    (1, 4, 4, 1, 333, 64, False),
    (2, 4, 4, 30, 100, 64, False),
]
F32, BF16 = "float32", "bfloat16"
TDT = {F32: torch.float32, BF16: torch.bfloat16}
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}
BAR = {F32: 2e-4, BF16: 5e-2}
BLOCKS = dict(block_q=32, block_k=48)  # several blocks a case


def _arrays(case, seed):
    b, h, hkv, sq, sk, dh, _ = case
    rng = np.random.default_rng(seed)
    shapes = ((b, h, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(arrays, dtype):
    return [torch.as_tensor(a).to(TDT[dtype]) for a in arrays]


def _rel(got, want):
    got, want = (np.asarray(torch.as_tensor(x).float()) if isinstance(x, torch.Tensor)
                 else np.asarray(jnp.asarray(x, jnp.float32)) for x in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", CASES)
def test_plain_arms_match_autodiff_of_plain(case):
    causal = case[-1]
    q, k, v = _t(_arrays(case, 0), F32)
    tq, tk, tv = _t(_arrays(case, 2), F32)
    dout = torch.as_tensor(np.random.default_rng(3).standard_normal(q.shape).astype(np.float32))

    def f(a, b_, c):
        return fa.flash_attention_plain(a, b_, c, causal=causal, **BLOCKS)

    out, lse = fa.flash_attention_lse_plain(q, k, v, causal=causal, **BLOCKS)
    assert torch.equal(out, f(q, k, v))
    _, vjp_fn = torch.func.vjp(f, q, k, v)
    for got, want in zip(fa.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal,
                                                      **BLOCKS), vjp_fn(dout)):
        assert _rel(got, want) < 1e-6
    _, jv = torch.func.jvp(f, (q, k, v), (tq, tk, tv))
    got = fa.flash_attention_jvp_plain(q, k, v, out, lse, tq, tk, tv, causal=causal, **BLOCKS)
    assert _rel(got, jv) < 1e-6


def _rel64(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _pieces(case, dtype):
    q, k, v = _t(_arrays(case, 0), dtype)
    dout, tq = (torch.as_tensor(np.random.default_rng(s).standard_normal(q.shape)
                                .astype(np.float32)).to(TDT[dtype]) for s in (3, 5))
    tk, tv = _t(_arrays(case, 2), dtype)[1:]
    out, lse = fa.flash_attention_lse_plain(q, k, v, causal=case[-1], **BLOCKS)
    return q, k, v, dout, tq, tk, tv, out, lse


@pytest.mark.parametrize("case", [CASES[1], CASES[3]])
def test_plain_bwd_rounds_where_the_kernel_rounds(case):
    b, h, hkv, sq, sk, dh, causal = case
    q, k, v, dout, *_, out, lse = _pieces(case, BF16)
    scale = dh**-0.5
    dq, dk, dv = fa._bwd_sums(dout, q, k, v, out, lse, causal, scale, BLOCKS["block_q"],
                              BLOCKS["block_k"])
    want = fa.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal, **BLOCKS)
    assert all(torch.equal(w, g.to(torch.bfloat16)) for w, g in zip(want, (dq, dk, dv)))
    # Rebuilt in f64 from the plain pieces: P and dS as the plain arm forms
    # them in f32, rounded to bf16 where the kernels' products take them.
    d = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    ref = [torch.zeros(b, h, n, dh, dtype=torch.float64) for n in (sq, sk, sk)]
    unrounded = torch.zeros(b, h, sq, dh, dtype=torch.float64)
    for q0, k0, rows, qi, p, kj, vj in fa._score_blocks(q, k, v, lse, causal, scale,
                                                        BLOCKS["block_q"], BLOCKS["block_k"]):
        doi = dout[:, :, q0 : q0 + rows].float()
        cols = kj.shape[2]
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", doi, vj) - d[:, :, q0 : q0 + rows]) * scale
        ds_r, p_r = ds.to(torch.bfloat16).double(), p.to(torch.bfloat16).double()
        ref[0][:, :, q0 : q0 + rows] += torch.einsum("bhqk,bhkd->bhqd", ds_r, kj.double())
        ref[1][:, :, k0 : k0 + cols] += torch.einsum("bhqk,bhqd->bhkd", ds_r, qi.double())
        ref[2][:, :, k0 : k0 + cols] += torch.einsum("bhqk,bhqd->bhkd", p_r, doi.double())
        unrounded[:, :, q0 : q0 + rows] += torch.einsum("bhqk,bhkd->bhqd", ds.double(),
                                                        kj.double())
    ref[1], ref[2] = (r.view(b, hkv, h // hkv, sk, dh).sum(dim=2) for r in ref[1:])
    for got, r in zip((dq, dk, dv), ref):
        assert _rel64(got, r) < 1e-6
    assert _rel64(dq, unrounded) > 1e-5  # the rounding point shows


@pytest.mark.parametrize("case", [CASES[1], CASES[3]])
def test_plain_jvp_rounds_where_the_kernel_rounds(case):
    b, h, hkv, sq, sk, dh, causal = case
    q, k, v, _, tq, tk, tv, out, lse = _pieces(case, BF16)
    scale, group = dh**-0.5, h // hkv
    got = fa._jvp_sums(q, k, v, out, lse, tq, tk, tv, causal, scale, BLOCKS["block_q"],
                       BLOCKS["block_k"])
    assert torch.equal(fa.flash_attention_jvp_plain(q, k, v, out, lse, tq, tk, tv,
                                                    causal=causal, **BLOCKS),
                       got.to(torch.bfloat16))
    acc = torch.zeros(b, h, sq, dh, dtype=torch.float64)
    unrounded = torch.zeros_like(acc)
    r = torch.zeros(b, h, sq, 1, dtype=torch.float64)
    for q0, k0, rows, qi, p, kj, vj in fa._score_blocks(q, k, v, lse, causal, scale,
                                                        BLOCKS["block_q"], BLOCKS["block_k"]):
        cols = kj.shape[2]
        tqi = tq[:, :, q0 : q0 + rows].float()
        tkj, tvj = (x[:, :, k0 : k0 + cols].float().repeat_interleave(group, dim=1)
                    for x in (tk, tv))
        t = p * ((torch.einsum("bhqd,bhkd->bhqk", tqi, kj)
                  + torch.einsum("bhqd,bhkd->bhqk", qi, tkj)) * scale)
        r[:, :, q0 : q0 + rows] += t.double().sum(dim=-1, keepdim=True)
        for x, pp in ((acc, torch.bfloat16), (unrounded, torch.float32)):
            x[:, :, q0 : q0 + rows] += (
                torch.einsum("bhqk,bhkd->bhqd", t.to(pp).double(), vj.double())
                + torch.einsum("bhqk,bhkd->bhqd", p.to(pp).double(), tvj.double()))
    assert _rel64(got, acc - r * out.double()) < 1e-6
    assert _rel64(got, unrounded - r * out.double()) > 1e-5


def _bwd_before(dout, q, k, v, out, lse, causal, scale):
    """The plain backward's formulas before dS was rounded (f32)."""
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    d = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    dq = torch.zeros((b, h, sq, dh), dtype=torch.float32)
    dk = torch.zeros((b, h, sk, dh), dtype=torch.float32)
    dv = torch.zeros_like(dk)
    for q0, k0, rows, qi, p, kj, vj in fa._score_blocks(q, k, v, lse, causal, scale,
                                                        BLOCKS["block_q"], BLOCKS["block_k"]):
        doi = dout[:, :, q0 : q0 + rows].float()
        cols = kj.shape[2]
        dv[:, :, k0 : k0 + cols] += torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).float(), doi)
        dp = torch.einsum("bhqd,bhkd->bhqk", doi, vj)
        ds = p * (dp - d[:, :, q0 : q0 + rows]) * scale
        dq[:, :, q0 : q0 + rows] += torch.einsum("bhqk,bhkd->bhqd", ds, kj)
        dk[:, :, k0 : k0 + cols] += torch.einsum("bhqk,bhqd->bhkd", ds, qi)
    return (dq.to(q.dtype), fa._group_sum(dk, hkv).to(k.dtype),
            fa._group_sum(dv, hkv).to(v.dtype))


def _jvp_before(q, k, v, out, lse, tq, tk, tv, causal, scale):
    """The plain JVP's formulas before P and T were rounded (f32)."""
    b, h, sq, dh = q.shape
    group = h // k.shape[1]
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32)
    r = torch.zeros((b, h, sq, 1), dtype=torch.float32)
    for q0, k0, rows, qi, p, kj, vj in fa._score_blocks(q, k, v, lse, causal, scale,
                                                        BLOCKS["block_q"], BLOCKS["block_k"]):
        cols = kj.shape[2]
        tqi = tq[:, :, q0 : q0 + rows].float()
        tkj = tk[:, :, k0 : k0 + cols].float().repeat_interleave(group, dim=1)
        tvj = tv[:, :, k0 : k0 + cols].float().repeat_interleave(group, dim=1)
        sdot = (torch.einsum("bhqd,bhkd->bhqk", tqi, kj)
                + torch.einsum("bhqd,bhkd->bhqk", qi, tkj)) * scale
        t = p * sdot
        r[:, :, q0 : q0 + rows] += t.sum(dim=-1, keepdim=True)
        acc[:, :, q0 : q0 + rows] += (torch.einsum("bhqk,bhkd->bhqd", t, vj)
                                      + torch.einsum("bhqk,bhkd->bhqd", p, tvj))
    return (acc - r * out.float()).to(q.dtype)


@pytest.mark.parametrize("case", CASES)
def test_f32_plain_arms_unchanged(case):
    causal, scale = case[-1], case[5] ** -0.5
    q, k, v, dout, tq, tk, tv, out, lse = _pieces(case, F32)
    got = fa.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal, **BLOCKS)
    assert all(torch.equal(g, w) for g, w in zip(got, _bwd_before(dout, q, k, v, out, lse,
                                                                   causal, scale)))
    got = fa.flash_attention_jvp_plain(q, k, v, out, lse, tq, tk, tv, causal=causal, **BLOCKS)
    assert torch.equal(got, _jvp_before(q, k, v, out, lse, tq, tk, tv, causal, scale))


_REF = {}


def _reference(case, dtype):
    """jax.vjp and jax.jvp of the reference's chunked attention, jitted once
    per case and dtype: (out, (dq, dk, dv), tangent out)."""
    key = (case, dtype)
    if key not in _REF:
        causal = case[-1]

        def f(q, k, v):
            return jops.attention(q, k, v, causal=causal, impl="chunked", **BLOCKS)

        def both(q, k, v, dout, tq, tk, tv):
            out, vjp_fn = jax.vjp(f, q, k, v)
            return out, vjp_fn(dout), jax.jvp(f, (q, k, v), (tq, tk, tv))[1]

        _REF[key] = jax.jit(both)
    return _REF[key]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[3], CASES[4], CASES[5]])
def test_plain_arms_match_reference(case, dtype):
    causal = case[-1]
    arrays = _arrays(case, 0) + [np.random.default_rng(3).standard_normal(
        (case[0], case[1], case[3], case[5])).astype(np.float32)] + _arrays(case, 2)
    jx = [jnp.asarray(a, JDT[dtype]) for a in arrays]
    out_ref, grads_ref, tan_ref = _reference(case, dtype)(*jx)
    q, k, v, dout, tq, tk, tv = _t(arrays, dtype)
    out, lse = fa.flash_attention_lse_plain(q, k, v, causal=causal, **BLOCKS)
    assert _rel(out, out_ref) < BAR[dtype]
    grads = fa.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal, **BLOCKS)
    for got, want in zip(grads, grads_ref):
        assert got.dtype == TDT[dtype]
        assert _rel(got, want) < BAR[dtype]
    tan = fa.flash_attention_jvp_plain(q, k, v, out, lse, tq, tk, tv, causal=causal, **BLOCKS)
    assert _rel(tan, tan_ref) < BAR[dtype]


def test_function_under_every_transform():
    case = CASES[1]
    causal = case[-1]
    q, k, v = _t(_arrays(case, 0), F32)
    tq, tk, tv = _t(_arrays(case, 2), F32)
    dout = torch.as_tensor(np.random.default_rng(3).standard_normal(q.shape).astype(np.float32))
    out, lse = fa.flash_attention_lse_plain(q, k, v, causal=causal)
    want = fa.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal)

    def f(a, b_, c):
        return tops.attention(a, b_, c, causal=causal)

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = f(*leaves)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    (o * dout).sum().backward()
    assert all(torch.equal(x.grad, w) for x, w in zip(leaves, want))
    grads = torch.func.grad(lambda *a: (f(*a) * dout).sum(), argnums=(0, 1, 2))(q, k, v)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    _, vjp_fn = torch.func.vjp(f, q, k, v)
    assert all(torch.equal(g, w) for g, w in zip(vjp_fn(dout), want))
    _, jv = torch.func.jvp(f, (q, k, v), (tq, tk, tv))
    assert torch.equal(jv, fa.flash_attention_jvp_plain(q, k, v, out, lse, tq, tk, tv,
                                                         causal=causal))
    _, lin = torch.func.linearize(f, q, k, v)
    assert torch.equal(lin(tq, tk, tv), jv)
    other = _t(_arrays(case, 4), F32)
    assert torch.equal(lin(*other), torch.func.jvp(f, (q, k, v), tuple(other))[1])
    # Not differentiated: the serving arm, as before.
    with torch.no_grad():
        assert f(*leaves).grad_fn is None
        assert torch.equal(f(*leaves), fa.flash_attention_plain(q, k, v, causal=causal))


def test_differentiated_call_refuses_a_query_offset():
    q, k, v = _t(_arrays(CASES[1], 0), F32)
    with pytest.raises(ValueError, match="q_offset"):
        tops.attention(q.requires_grad_(True), k, v, causal=True, q_offset=4)
    tops.attention(q.detach(), k, v, causal=True, q_offset=4)  # serving: allowed


def test_ssd_kernel_refuses_a_differentiated_input():
    x = torch.zeros(1, 8, 2, 4)
    assert not _runtime.differentiated(x, None)
    assert _runtime.differentiated(x.clone().requires_grad_(True))
    with torch.no_grad():
        assert not _runtime.differentiated(x.clone().requires_grad_(True))
    seen = []
    torch.func.grad(lambda t: (seen.append(_runtime.differentiated(t)), t.sum())[1])(x)
    torch.func.jvp(lambda t: (seen.append(_runtime.differentiated(t)), t)[1], (x,), (x,))
    # linearize: the primal call, then the tangent map traced on dual tensors.
    torch.func.linearize(lambda t: (seen.append(_runtime.differentiated(t)), t * 2)[1], x)
    assert seen == [True, True, False, True]
    dt, a = torch.ones(1, 8, 2), -torch.ones(2)
    bm = cm = torch.zeros(1, 8, 1, 4)
    with pytest.raises(NotImplementedError, match="ops.ssd"):
        ss.ssd_scan_cuda(x.clone().requires_grad_(True), dt, a, bm, cm)
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu tensor"):
        ss.ssd_scan_cuda(x, dt, a, bm, cm)
