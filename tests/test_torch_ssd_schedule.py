"""K10's three-pass schedule, emulated in torch on the CPU.

The CUDA kernels (``csrc/ssd_scan.cu``) run the SSD decomposition of arXiv
2405.21060 §6: (a) every chunk's state ``S_k = Xᵀ(exp(cs_c − cs)·dt ⊙ B)``
at once, with ``cs`` from a warp scan (four rows a lane in order, then the
lane totals); (b) the states passed through the chunks in order in f32,
``S_k`` replaced by the state ``H_k`` that enters chunk k while
``H_{k+1} = exp(cs_c)·H_k + S_k`` runs from ``initial_state``; (c) every
chunk's ``Y = (M ⊙ G) X + exp(cs)·(C H_kᵀ)``.  For bf16 inputs each factor
that is not bf16 (X scaled by w in (a), ``M ⊙ G`` and ``H_k`` in (c)) goes
to the tensor cores as a two-term split ``hi = bf16(v)``, ``lo = bf16(v −
hi)``.  :func:`emulate` runs those passes, scratch layouts and splits, and
is held to ``ssd_plain`` at the card's bars (``tests/test_torch_cuda.py``)
and to the reference (``ops.ssd(impl="interpret")``, ``_ssd_chunked`` with
and without a state) at ``tests/test_torch_models.py``'s; the wrapper's
plan (chunks, heads per block, grids, scratch bytes) and the strided views
it reads in place or refuses are checked here too.  The training arms'
schedules are emulated the same way: the f32 backward on the CUDA cores
(:func:`backward_passes`), and the bf16 backward and tangent map on the
tensor cores with their splits, block-of-heads sums and block-order
reduction (:func:`backward_passes_tc`, :func:`jvp_passes_tc`), held to
``ssd_bwd_plain`` / ``ssd_jvp_plain`` at the card's bars.  These are checks
of the design, mirrored in Python: the card tests are what hold the kernels
themselves to the plain version.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = pytest.importorskip("torch.nn.functional")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

# b, l, h, p, g, n, chunk: tests/test_kernels.py's SSD_CASES, ...
SSD_CASES = [
    (1, 64, 2, 16, 1, 16, 32),
    (2, 100, 4, 8, 2, 24, 32),
    (1, 37, 2, 4, 2, 8, 16),
    (2, 128, 8, 32, 1, 64, 64),
]
# ... ragged l (37, 100, 300), l below the chunk (one chunk of l rounded up
# to 8, or of 16 rows in shared memory), g = 2 at the full head width.
MORE_CASES = [
    (1, 37, 2, 8, 1, 16, 16),
    (1, 100, 4, 16, 2, 32, 32),
    (1, 300, 2, 16, 1, 32, 64),
    (2, 20, 2, 8, 1, 16, 32),
    (1, 9, 4, 8, 2, 8, 128),
    (1, 70, 4, 64, 2, 16, 32),
]
CASES = SSD_CASES + MORE_CASES
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# The card's bars (tests/test_torch_cuda.py) and the reference's
# (tests/test_torch_models.py's _tol at twice its scale), relative to the
# output's scale.
CARD_TOL = {"float32": (2e-4, 5e-4), "bfloat16": (2e-2, 5e-2)}
REF_TOL = {"float32": (4e-4, 1e-3), "bfloat16": (4e-2, 1e-1)}
SSD_MAIN = (4, 4096, 64, 64, 1, 128, 128)  # mamba2-1.3b's prefill


def _inputs(case, dname):
    """numpy inputs from a seed, as ``tests/test_torch_models.py`` makes
    them: (jax arrays, torch tensors)."""
    b, l, h, p, g, n, _ = case
    rng = np.random.default_rng(sum(case))
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.4, (b, l, h)).astype(np.float32)
    a = (-rng.uniform(0.3, 2.0, (h,))).astype(np.float32)
    bm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    d = rng.standard_normal((h,)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    low = [jnp.asarray(t, JDT[dname]) for t in (x, bm, cm)]
    rest = [jnp.asarray(t) for t in (dt, a, d, h0)]
    tlow = [torch.as_tensor(t).to(DTYPES[dname]) for t in (x, bm, cm)]
    trest = [torch.as_tensor(t) for t in (dt, a, d, h0)]
    return ((low[0], rest[0], rest[1], low[1], low[2], rest[2], rest[3]),
            (tlow[0], trest[0], trest[1], tlow[1], tlow[2], trest[2], trest[3]))


def _bf(t):
    return t.to(torch.bfloat16).float()


def split(v):
    """The kernels' two-term bf16 split: ``v ≈ hi + lo``."""
    hi = _bf(v)
    return hi, _bf(v - hi)


def warp_cumsum(adt):
    """``cumsum`` over the last dimension (≤ 128 rows, zero-padded to 128)
    in ``chunk_weights``' order: each of 32 lanes sums its four rows in
    order, a Hillis–Steele scan over the lane totals, then the lane's
    exclusive prefix is added to its running sums."""
    rows = adt.shape[-1]
    v = F.pad(adt, (0, 128 - rows)).reshape(*adt.shape[:-1], 32, 4)
    run = v.clone()
    for i in range(1, 4):
        run[..., i] = run[..., i - 1] + v[..., i]
    incl = run[..., 3].clone()
    for o in (1, 2, 4, 8, 16):
        incl = torch.cat([incl[..., :o], incl[..., o:] + incl[..., :-o]], dim=-1)
    excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], dim=-1)
    return (run + excl[..., None]).reshape(*adt.shape[:-1], 128)[..., :rows]


def passes(x, dt, a, bm, cm, *, chunk, initial_state=None):
    """The three passes on the wrapper's plan: returns ``Y`` in f32 (before
    the cast to x's dtype) and the final state."""
    b, l, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    plan = ss.plan(b, l, h, p, g, n, chunk, x.dtype)
    c, nch = plan["chunk"], plan["chunks"]
    tc = x.dtype == torch.bfloat16
    def chunks(t):  # (b, l, k, w) -> (b, chunks, c, h, w), groups repeated to heads
        t = F.pad(t.float(), (0, 0, 0, 0, 0, nch * c - l)).reshape(b, nch, c, *t.shape[2:])
        return t.repeat_interleave(h // t.shape[3], dim=3)

    xs, bs, cs_ = chunks(x), chunks(bm), chunks(cm)
    dts = F.pad(dt, (0, 0, 0, nch * c - l)).reshape(b, nch, c, h)
    cs = warp_cumsum((dts * a).transpose(2, 3)).transpose(2, 3)  # (b, chunks, c, h)
    tot = cs[:, :, c - 1 : c]
    w = torch.exp(tot - cs) * dts

    # (a) chunk states, (b, h, chunks, p, n).
    if tc:
        hi, lo = split(xs * w[..., None])
        states = (torch.einsum("bkthp,bkthn->bhkpn", hi, bs)
                  + torch.einsum("bkthp,bkthn->bhkpn", lo, bs))
    else:
        states = torch.einsum("bkthp,bkthn->bhkpn", xs, bs * w[..., None])
    decay = torch.exp(tot[:, :, 0]).transpose(1, 2)  # (b, h, chunks)

    # (b) state passing in place, in chunk order.
    hcur = (initial_state.float() if initial_state is not None
            else torch.zeros(b, h, p, n))
    for k in range(nch):
        s_k = states[:, :, k].clone()
        states[:, :, k] = hcur
        hcur = decay[:, :, k, None, None] * hcur + s_k

    # (c) chunk outputs.
    gmat = torch.einsum("bkthn,bkshn->bkhts", cs_, bs)
    delta = cs.transpose(2, 3)[..., :, None] - cs.transpose(2, 3)[..., None, :]  # (b,k,h,t,s)
    mask = torch.ones(c, c, dtype=torch.bool).tril()
    m = torch.where(mask, torch.exp(torch.where(mask, delta, 0.0))
                    * dts.transpose(2, 3)[..., None, :], 0.0)
    wmat = gmat * m
    hk = states.permute(0, 2, 1, 3, 4)  # (b, chunks, h, p, n)
    if tc:
        (whi, wlo), (hhi, hlo) = split(wmat), split(hk)
        z = (torch.einsum("bkthn,bkhpn->bkthp", cs_, hhi)
             + torch.einsum("bkthn,bkhpn->bkthp", cs_, hlo))
        yw = (torch.einsum("bkhts,bkshp->bkthp", whi, xs)
              + torch.einsum("bkhts,bkshp->bkthp", wlo, xs))
    else:
        z = torch.einsum("bkthn,bkhpn->bkthp", cs_, hk)
        yw = torch.einsum("bkhts,bkshp->bkthp", wmat, xs)
    y = torch.exp(cs)[..., None] * z + yw
    return y.reshape(b, nch * c, h, p)[:, :l], hcur


def emulate(x, dt, a, bm, cm, d=None, *, chunk=128, initial_state=None, return_state=False):
    """:func:`ssd_scan_cuda`'s function by :func:`passes`: ``y`` in x's
    dtype plus the D skip as the wrapper adds it."""
    y, hcur = passes(x, dt, a, bm, cm, chunk=chunk, initial_state=initial_state)
    y = ss._skip(y.to(x.dtype), x, d)
    return (y, hcur) if return_state else y


def _scaled(got, want, tol):
    want = (want.float() if isinstance(want, torch.Tensor)
            else torch.tensor(np.asarray(want, dtype=np.float32)))
    scale = max(1.0, float(want.abs().max()))
    rtol, atol = tol
    torch.testing.assert_close(got.float() / scale, want / scale, rtol=rtol, atol=atol)


def test_warp_cumsum_is_a_cumsum():
    adt = torch.as_tensor(np.random.default_rng(0).uniform(-0.8, 0, (3, 100)), dtype=torch.float32)
    torch.testing.assert_close(warp_cumsum(adt), torch.cumsum(adt, dim=-1), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_schedule_matches_plain(case, state, dname):
    _, (x, dt, a, bm, cm, d, h0) = _inputs(case, dname)
    kw = dict(chunk=case[-1], initial_state=h0 if state else None, return_state=state)
    got, want = emulate(x, dt, a, bm, cm, d, **kw), ss.ssd_plain(x, dt, a, bm, cm, d, **kw)
    for gv, wv in zip(*((got, want) if state else ((got,), (want,)))):
        assert gv.shape == wv.shape and gv.dtype == wv.dtype
        _scaled(gv, wv, CARD_TOL[dname])


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_schedule_matches_reference(case, state, dname):
    (jx, jdt, ja, jb, jc, jd, jh0), (x, dt, a, bm, cm, d, h0) = _inputs(case, dname)
    chunk = case[-1]
    if state:
        want = jops._ssd_chunked(jx, jdt, ja, jb, jc, jd, chunk, initial_state=jh0,
                                 return_state=True)
        got = emulate(x, dt, a, bm, cm, d, chunk=chunk, initial_state=h0, return_state=True)
    else:
        impl = "interpret" if case in SSD_CASES else "chunked"
        want = (jops.ssd(jx, jdt, ja, jb, jc, jd, impl=impl, chunk=chunk),)
        got = (emulate(x, dt, a, bm, cm, d, chunk=chunk),)
    for gv, wv in zip(got, want):
        _scaled(gv, np.asarray(jnp.asarray(wv, jnp.float32)), REF_TOL[dname])


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("case", [SSD_CASES[3], MORE_CASES[2], MORE_CASES[5]])
def test_split_keeps_the_f32_bar(case, state):
    """With bf16 inputs the split products hold the f32 arithmetic on the
    same values to the f32 bar, before y is rounded to bf16 (about 3e-6 of
    the scale); single bf16 terms would not (about 2e-3)."""
    _, (x, dt, a, bm, cm, _, h0) = _inputs(case, "bfloat16")
    kw = dict(chunk=case[-1], initial_state=h0 if state else None)
    y16, h16 = passes(x, dt, a, bm, cm, **kw)
    y32, h32 = passes(x.float(), dt, a, bm.float(), cm.float(), **kw)
    _scaled(y16, y32, CARD_TOL["float32"])
    _scaled(h16, h32, CARD_TOL["float32"])


def _state_pass_back(grads, hs, csc, dh_last, warps):
    """(b') in place: slot k of ``grads`` (b, h, chunks, p, n) takes
    ``Γ_{k+1}``; returns ``dh0`` and the per-item sums of the per-warp
    partials of ``⟨Γ_{k+1}, H_k⟩`` (b, h, chunks), in warp order."""
    b, h, nch, p, n = grads.shape
    gam = dh_last.float() if dh_last is not None else torch.zeros(b, h, p, n)
    dots = torch.zeros(b, h, nch)
    for k in reversed(range(nch)):
        u = grads[:, :, k].clone()
        grads[:, :, k] = gam
        prod = F.pad((gam * hs[:, :, k]).reshape(b, h, p * n), (0, warps * 32 - p * n))
        dots[:, :, k] = prod.reshape(b, h, warps, 32).sum(-1).sum(-1)
        gam = torch.exp(csc[:, :, k, 0])[..., None, None] * gam + u
    return gam, dots


def _items(t, b, l, h, c, nch):
    """(b, l, k, w) → (b, h, chunks, c, w) in f32: rows past l zero, groups
    repeated to their heads."""
    t = F.pad(t.float(), (0, 0, 0, 0, 0, nch * c - l)).reshape(b, nch, c, *t.shape[2:])
    return t.repeat_interleave(h // t.shape[3], dim=3).permute(0, 3, 1, 2, 4)


def _rows_out(t, b, l, nch, c):
    """(b, k, chunks, c, w) → (b, l, k, w)."""
    return t.permute(0, 2, 3, 1, 4).reshape(b, nch * c, t.shape[1], -1)[:, :l]


def _causal(cs, c):
    """E[t, s] = exp(cs_t − cs_s) for s ≤ t, else 0 (masked before the exp)."""
    tri = torch.ones(c, c, dtype=torch.bool).tril()
    return torch.where(tri, torch.exp(torch.where(tri, cs[..., :, None] - cs[..., None, :], 0.0)),
                       0.0)


def _mm_split(a, b, eq):
    """``einsum(eq, a, b)`` with ``b`` (not bf16) fed as its two-term split,
    as the tensor-core kernels feed it: one product per term, summed."""
    hi, lo = split(b)
    return torch.einsum(eq, a, hi) + torch.einsum(eq, a, lo)


def _block_sum(t, hpb):
    """(b, h, …) → (b, h / hpb, …): the block's heads summed in head order."""
    t = t.reshape(t.shape[0], -1, hpb, *t.shape[2:])
    out = t[:, :, 0]
    for j in range(1, hpb):
        out = out + t[:, :, j]
    return out


def _group_blocks(t, g):
    """(b, blocks, …) → (b, g, …): each group's blocks summed in block order."""
    t = t.reshape(t.shape[0], g, -1, *t.shape[2:])
    out = t[:, :, 0]
    for j in range(1, t.shape[2]):
        out = out + t[:, :, j]
    return out


def backward_passes(dy, x, dt, a, bm, cm, hs, cs, dh_last, *, chunk):
    """The backward's schedule on :func:`ss.grad_plan`'s layout (``namespace
    grad`` of ``csrc/ssd_scan.cu``), in f32: (a') every item's ``U_k = dYᵀ
    diag(e^cs) C``; (b') the state pass backwards in place (slot k left
    holding ``Γ_{k+1}``), each warp's 32-element partial of ``⟨Γ_{k+1},
    H_k⟩`` written out and summed in warp order by the item; (c') per item
    ``M∘G`` and ``dG``, the row and column sums of ``dM∘M`` and of ``dM∘E``,
    ω, ψ, the per-head ``dX`` and ``dB`` / ``dC`` partials, ``dcs``, its
    reverse cumulative sum, ``ddt`` and the per-item ``da`` partial; (r)
    ``dB`` / ``dC`` summed over each group's heads in head order and ``da``
    over (batch, chunk) in order.  Returns the six gradients in f32 and,
    per head, the sum of the magnitudes of ``da``'s terms."""
    b, l, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    gp = ss.grad_plan(b, l, h, p, g, n, chunk)
    c, nch = gp["chunk"], gp["chunks"]
    hpg = h // g
    xs, dys, bs, cs_ = (_items(t, b, l, h, c, nch) for t in (x, dy, bm, cm))
    dts = F.pad(dt, (0, 0, 0, nch * c - l)).reshape(b, nch, c, h).permute(0, 3, 1, 2)
    csc = cs[..., c - 1 :]  # (b, h, chunks, 1)
    ecs = torch.exp(cs) * (dts != 0)  # the kernels' e^cs is 0 past the valid rows
    w = torch.exp(csc - cs) * dts
    # (a') and (b').
    grads = torch.einsum("bhktp,bhktn->bhkpn", dys * ecs[..., None], cs_)
    dh0, dots = _state_pass_back(grads, hs, csc, dh_last, gp["grid_states"][1] * 8)
    # (c').
    e = _causal(cs, c)
    m = e * dts[..., None, :]
    gmat = torch.einsum("bhktn,bhksn->bhkts", cs_, bs)
    q = torch.einsum("bhktp,bhksp->bhkts", dys, xs)
    pg, dg, dm = m * gmat, m * q, gmat * q
    rows = torch.stack([(dm * m).sum(-1), (dm * m).sum(-2), (dm * e).sum(-2)])
    bg = torch.einsum("bhksn,bhkpn->bhksp", bs, grads)
    omega = (xs * bg).sum(-1)
    dx = torch.einsum("bhkts,bhktp->bhksp", pg, dys) + w[..., None] * bg
    dbp = torch.einsum("bhkts,bhktn->bhksn", dg, cs_) + w[..., None] * torch.einsum(
        "bhksp,bhkpn->bhksn", xs, grads)
    z = torch.einsum("bhktp,bhkpn->bhktn", dys, hs)
    psi = (cs_ * z).sum(-1)
    dcp = torch.einsum("bhkts,bhksn->bhktn", dg, bs) + ecs[..., None] * z
    dcs = rows[0] - rows[1] + ecs * psi - w * omega
    dcs[..., c - 1] += (w * omega).sum(-1) + torch.exp(csc[..., 0]) * dots
    dadt = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,))
    ddt = rows[2] + omega * torch.exp(csc - cs) + a[None, :, None, None] * dadt
    dap = (dts * dadt).sum(-1)  # (b, h, chunks)
    # (r): group sums in head order; da over (batch, chunk) in order.
    def rows_out(t):  # (b, h, chunks, c, w) -> (b, l, h, w)
        return _rows_out(t, b, l, nch, c)

    def group(t):
        t = rows_out(t).reshape(b, l, g, hpg, n)
        out = t[:, :, :, 0]
        for j in range(1, hpg):
            out = out + t[:, :, :, j]
        return out

    da = torch.zeros(h)
    for bi in range(b):
        for k in range(nch):
            da = da + dap[bi, :, k]
    da_terms = (dts * dadt).abs().sum((0, 2, 3))  # Σ|dt·dadt|, da's cancelling terms
    return (rows_out(dx), rows_out(ddt[..., None])[..., 0], da, group(dbp), group(dcp),
            dh0), da_terms


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("case", [SSD_CASES[1], SSD_CASES[2], MORE_CASES[3], MORE_CASES[4]])
def test_backward_schedule_matches_plain(case, state):
    """The kernels' backward schedule (:func:`backward_passes`) against
    ``ssd_bwd_plain`` at 1e-6 of each output's max abs (``da``: of the sum
    of its terms' magnitudes), f32."""
    _, (x, dt, a, bm, cm, _, h0) = _inputs(case, "float32")
    chunk = case[-1]
    h0 = h0 if state else None
    rng = np.random.default_rng(7)
    dy = torch.as_tensor(rng.standard_normal(x.shape).astype(np.float32))
    dh = torch.as_tensor(rng.standard_normal(h0.shape).astype(np.float32)) if state else None
    _, _, hs, cs = ss.ssd_fwd_plain(x, dt, a, bm, cm, h0, chunk=chunk)
    got, da_terms = backward_passes(dy, x, dt, a, bm, cm, hs, cs, dh, chunk=chunk)
    want = ss.ssd_bwd_plain(dy, x, dt, a, bm, cm, h0, hs, cs, dh, chunk=chunk)
    for name, gv, wv in zip(("dx", "ddt", "da", "dB", "dC", "dh0"), got, want):
        assert gv.shape == wv.shape, name
        # da sums terms of both signs in another order: held per head
        # against the sum of its terms' magnitudes.
        scale = da_terms if name == "da" else wv.float().abs().max()
        err = float(((gv - wv.float()).abs() / scale).max())
        assert err <= 1e-6, (name, err)


def backward_passes_tc(dy, x, dt, a, bm, cm, hs, cs, dh_last, *, chunk):
    """The bf16 backward's schedule on :func:`ss.grad_plan`'s bf16 layout
    (``namespace grad``'s tensor-core kernels): every non-bf16 factor split
    into hi + lo where the kernel splits it.  (a') ``U_k = split(dY∘e^cs)ᵀ
    C``; (b') the state pass; (c') per block of ``hpb`` heads of one group:
    per head ``dX = w∘(B split(Γ)ᵀ) + split(M∘G)ᵀ dY`` (ω from the first
    product), the sums of ``dM∘M`` and ``dM∘E``, ``dG = M∘Q`` summed over
    the block's heads in head order, ``w∘(X split(Γ))`` and ``e^cs∘(dY
    split(H_k))`` (ψ from the latter) accumulated in head order; then the
    block's partials ``dB += split(ΣdG)ᵀ C``, ``dC += split(ΣdG) B``; (r)
    the partials summed over each group's blocks in block order, ``da`` over
    (batch, chunk) in order.  Returns the six gradients (dx, dB, dC rounded
    to bf16) and, per head, the sum of the magnitudes of ``da``'s terms."""
    b, l, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    gp = ss.grad_plan(b, l, h, p, g, n, chunk, torch.bfloat16)
    c, nch, hpb = gp["chunk"], gp["chunks"], gp["heads_per_block"]
    xs, dys, bs, cs_ = (_items(t, b, l, h, c, nch) for t in (x, dy, bm, cm))
    dts = F.pad(dt, (0, 0, 0, nch * c - l)).reshape(b, nch, c, h).permute(0, 3, 1, 2)
    valid = (torch.arange(nch * c) < l).reshape(nch, c).float()
    csc = cs[..., c - 1 :]
    ecs = torch.exp(cs) * valid  # 0 past the valid rows
    w = torch.exp(csc - cs) * dts
    # (a') and (b').
    hi, lo = split(dys * ecs[..., None])
    grads = (torch.einsum("bhktp,bhktn->bhkpn", hi, cs_)
             + torch.einsum("bhktp,bhktn->bhkpn", lo, cs_))
    dh0, dots = _state_pass_back(grads, hs, csc, dh_last, gp["grid_states"][1] * 8)
    # (c'), per head.
    e = _causal(cs, c)
    m = e * dts[..., None, :]
    gmat = torch.einsum("bhktn,bhksn->bhkts", cs_, bs)
    q = torch.einsum("bhktp,bhksp->bhkts", dys, xs)
    dm = gmat * q
    rows = torch.stack([(dm * m).sum(-1), (dm * m).sum(-2), (dm * e).sum(-2)])
    bg = _mm_split(bs, grads, "bhksn,bhkpn->bhksp")
    omega = (xs * bg).sum(-1)
    dx = w[..., None] * bg + _mm_split(dys, m * gmat, "bhktp,bhkts->bhksp")
    z = _mm_split(dys, hs, "bhktp,bhkpn->bhktn")
    psi = (cs_ * z).sum(-1)
    # (c'), per block: the heads in order, then the summed dG's products.
    dbp = _block_sum(w[..., None] * _mm_split(xs, grads, "bhksp,bhkpn->bhksn"), hpb)
    dcp = _block_sum(ecs[..., None] * z, hpb)
    dgs = _block_sum(m * q, hpb)
    bsb, csb = bs[:, ::hpb], cs_[:, ::hpb]  # the block's group's B and C
    dbp = dbp + _mm_split(csb, dgs, "bhktn,bhkts->bhksn")
    dcp = dcp + _mm_split(bsb, dgs, "bhksn,bhkts->bhktn")
    dcs = rows[0] - rows[1] + ecs * psi - w * omega
    dcs[..., c - 1] += (w * omega).sum(-1) + torch.exp(csc[..., 0]) * dots
    dadt = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,))
    ddt = rows[2] + omega * torch.exp(csc - cs) + a[None, :, None, None] * dadt
    dap = (dts * dadt).sum(-1)
    # (r).
    da = torch.zeros(h)
    for bi in range(b):
        for k in range(nch):
            da = da + dap[bi, :, k]
    da_terms = (dts * dadt).abs().sum((0, 2, 3))

    def out(t):
        return _rows_out(t, b, l, nch, c)

    return (out(dx).to(x.dtype), out(ddt[..., None])[..., 0], da,
            _group_blocks(out(dbp).transpose(1, 2), g).transpose(1, 2).to(bm.dtype),
            _group_blocks(out(dcp).transpose(1, 2), g).transpose(1, 2).to(cm.dtype),
            dh0), da_terms


def jvp_passes_tc(x, dt, a, bm, cm, hs, cs, tx, tdt, ta, tb, tc, th0, *, chunk):
    """The bf16 tangent map's schedule (the forward's two tensor-core
    passes carrying tangent pairs): (a'') ``ċs`` by the warp scan, the
    tangent chunk state ``split(Ẋ∘w + X∘ẇ)ᵀ B + split(X∘w)ᵀ Ḃ + ċs_c
    e^{cs_c} H_k``; (b'') the forward's state pass; (c'') ``Ẏ = split(Ṁ∘G +
    M∘Ġ) X + split(M∘G) Ẋ + e^cs ∘ (ċs ∘ (C split(H_k)ᵀ) + Ċ split(H_k)ᵀ +
    C split(Ḣ_k)ᵀ)``.  Returns ``(ẏ in bf16, ḣ_last)``."""
    b, l, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    gp = ss.grad_plan(b, l, h, p, g, n, chunk, torch.bfloat16)
    c, nch = gp["chunk"], gp["chunks"]
    xs, txs, bs, cs_, tbs, tcs_ = (_items(t, b, l, h, c, nch) for t in (x, tx, bm, cm, tb, tc))
    dts, tdts = (F.pad(t, (0, 0, 0, nch * c - l)).reshape(b, nch, c, h).permute(0, 3, 1, 2)
                 for t in (dt, tdt))
    csc = cs[..., c - 1 :]
    tcs = warp_cumsum(ta[None, :, None, None] * dts + a[None, :, None, None] * tdts)
    tcsc = tcs[..., c - 1 :]
    ew = torch.exp(csc - cs)
    w = ew * dts
    tw = w * (tcsc - tcs) + ew * tdts
    # (a'').
    tst = (_mm_split(bs, txs * w[..., None] + xs * tw[..., None], "bhktn,bhktp->bhkpn")
           + _mm_split(tbs, xs * w[..., None], "bhktn,bhktp->bhkpn")
           + (tcsc * torch.exp(csc))[..., None] * hs)
    # (b'').
    hdot = th0.float() if th0 is not None else torch.zeros(b, h, p, n)
    decay = torch.exp(csc[..., 0])
    for k in range(nch):
        s_k = tst[:, :, k].clone()
        tst[:, :, k] = hdot
        hdot = decay[:, :, k, None, None] * hdot + s_k
    # (c'').
    e = _causal(cs, c)
    m = e * dts[..., None, :]
    tm = m * (tcs[..., :, None] - tcs[..., None, :]) + e * tdts[..., None, :]
    gmat = torch.einsum("bhktn,bhksn->bhkts", cs_, bs)
    tg = (torch.einsum("bhktn,bhksn->bhkts", tcs_, bs)
          + torch.einsum("bhktn,bhksn->bhkts", cs_, tbs))
    y = (_mm_split(xs, tm * gmat + m * tg, "bhksp,bhkts->bhktp")
         + _mm_split(txs, m * gmat, "bhksp,bhkts->bhktp"))
    ch = _mm_split(cs_, hs, "bhktn,bhkpn->bhktp") * tcs[..., None]
    ch = ch + _mm_split(tcs_, hs, "bhktn,bhkpn->bhktp") + _mm_split(cs_, tst, "bhktn,bhkpn->bhktp")
    y = y + torch.exp(cs)[..., None] * ch
    return _rows_out(y, b, l, nch, c).to(x.dtype), hdot


# bf16 at the full widths (p 64, n 128, c 128) with few heads and rows; a
# g = 2 ragged case whose groups span two blocks (hpb 5 of 10 heads a group).
TC_CASES = [(1, 300, 4, 64, 1, 128, 128), (1, 70, 20, 16, 2, 24, 32)]
GRAD_BAR = {"bfloat16": 5e-2, "float32": 2e-4}  # chip_smoke.py's, of the plain max abs


def _grad_inputs(case, state):
    _, (x, dt, a, bm, cm, _, h0) = _inputs(case, "bfloat16")
    rng = np.random.default_rng(sum(case) + 1)
    def rnd(shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape).astype(np.float32))
    dy, tx = rnd(x.shape).to(x.dtype), rnd(x.shape).to(x.dtype)
    tb, tc = rnd(bm.shape).to(x.dtype), rnd(cm.shape).to(x.dtype)
    tdt, ta = rnd(dt.shape, 0.1), rnd(a.shape, 0.1)
    dh, th0 = (rnd(h0.shape), rnd(h0.shape)) if state else (None, None)
    return x, dt, a, bm, cm, (h0 if state else None), dy, tx, tdt, ta, tb, tc, dh, th0


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("case", TC_CASES)
def test_backward_tc_schedule_matches_plain(case, state):
    """The bf16 backward's tensor-core schedule with its splits against
    ``ssd_bwd_plain`` at the card's bars: 5e-2 of the max abs on dx, dB
    and dC; 2e-4 on ddt and dh0, and on da of the sum of its terms'
    magnitudes (da's terms cancel)."""
    x, dt, a, bm, cm, h0, dy, *_, dh, _ = _grad_inputs(case, state)
    chunk = case[-1]
    _, _, hs, cs = ss.ssd_fwd_plain(x, dt, a, bm, cm, h0, chunk=chunk)
    got, da_terms = backward_passes_tc(dy, x, dt, a, bm, cm, hs, cs, dh, chunk=chunk)
    want = ss.ssd_bwd_plain(dy, x, dt, a, bm, cm, h0, hs, cs, dh, chunk=chunk)
    for name, gv, wv in zip(("dx", "ddt", "da", "dB", "dC", "dh0"), got, want):
        assert gv.shape == wv.shape and gv.dtype == wv.dtype, name
        scale = da_terms if name == "da" else wv.float().abs().max()
        bar = GRAD_BAR["bfloat16" if wv.dtype == torch.bfloat16 else "float32"]
        err = float(((gv.float() - wv.float()).abs() / scale).max())
        assert err <= bar, (name, err)


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("case", TC_CASES)
def test_jvp_tc_schedule_matches_plain(case, state):
    """The bf16 tangent map's tensor-core schedule against
    ``ssd_jvp_plain``: ẏ at 5e-2 of its max abs, the final state's tangent
    at 2e-4."""
    x, dt, a, bm, cm, h0, _, tx, tdt, ta, tb, tc, _, th0 = _grad_inputs(case, state)
    chunk = case[-1]
    _, _, hs, cs = ss.ssd_fwd_plain(x, dt, a, bm, cm, h0, chunk=chunk)
    got = jvp_passes_tc(x, dt, a, bm, cm, hs, cs, tx, tdt, ta, tb, tc, th0, chunk=chunk)
    want = ss.ssd_jvp_plain(x, dt, a, bm, cm, h0, hs, cs, tx, tdt, ta, tb, tc, th0, chunk=chunk)
    for name, gv, wv, bar in zip(("ty", "th"), got, want, (5e-2, 2e-4)):
        assert gv.shape == wv.shape and gv.dtype == wv.dtype, name
        err = float((gv.float() - wv.float()).abs().max() / wv.float().abs().max())
        assert err <= bar, (name, err)


def test_grad_plan_at_the_training_shape():
    """mamba2-1.3b's training shape: 1 024 items on (heads, chunks, batch),
    the state pass's grid and its 256 warps a (batch, head), and the f32
    scratch the backward and the tangent map allocate; in bf16, blocks of 8
    heads (128 of them), no scores or row scratch, and one dB / dC partial a
    block (8 where f32 has 64)."""
    gp = ss.grad_plan(2, 1024, 64, 64, 1, 128, 128)
    assert gp["chunk"] == 128 and gp["chunks"] == 8 and gp["grid_items"] == (64, 8, 2)
    assert gp["grid_states"] == (128, 32)
    assert gp["bwd_scratch"]["dots"] == (128, 8, 256)
    assert _scratch_bytes({"scratch": gp["bwd_scratch"]}) == 4 * (
        2 * 64 * 8 * (64 * 128 + 2 * 128 * 128 + 4 * 128 + 2 * 128 * 128 + 1) + 128 * 8 * 256)
    assert gp["jvp_scratch"] == {"states": (2, 64, 8, 64, 128), "dcs": (2, 64, 8, 128),
                                 "decay": (2, 64, 8)}
    assert ss.grad_plan(1, 37, 2, 4, 2, 8, 16)["grid_items"] == (2, 3, 1)
    with pytest.raises(ValueError):
        ss.grad_plan(1, 64, 2, 65, 1, 16, 32)
    tc = ss.grad_plan(2, 1024, 64, 64, 1, 128, 128, torch.bfloat16)
    assert tc["heads_per_block"] == 8 and tc["grid_items"] == (8, 8, 2)
    assert tc["grid_states"] == gp["grid_states"] and tc["jvp_scratch"] == gp["jvp_scratch"]
    assert tc["bwd_scratch"] == {"grads": (2, 64, 8, 64, 128), "dots": (128, 8, 256),
                                 "db": (2, 8, 8, 128, 128), "dc": (2, 8, 8, 128, 128),
                                 "da": (2, 64, 8)}
    assert _scratch_bytes({"scratch": tc["bwd_scratch"]}) == 4 * (
        2 * 64 * 8 * (64 * 128 + 1) + 128 * 8 * 256 + 2 * 2 * 8 * 8 * 128 * 128) == 51_384_320
    assert ss.grad_plan(1, 70, 20, 16, 2, 24, 32, torch.bfloat16)["grid_items"] == (4, 3, 1)


def _scratch_bytes(plan):
    return 4 * sum(math.prod(shape) for shape in plan["scratch"].values())


def test_plan_at_the_prefill():
    b, l, h, p, g, n, c = SSD_MAIN
    plan = ss.plan(b, l, h, p, g, n, c, torch.bfloat16)
    assert plan["chunk"] == 128 and plan["chunks"] == 32 and plan["heads_per_block"] == 8
    assert plan["grid_chunks"] == (8, 32, 4)  # 1 024 blocks: ~8 a SM on 132 SMs
    assert math.prod(plan["grid_chunks"]) * plan["heads_per_block"] == 8192  # (b, h, chunk) items
    assert plan["grid_states"] == (256, 32)  # a thread per state element
    assert plan["scratch"] == {"states": (4, 64, 32, 64, 128), "cs": (4, 64, 32, 128),
                               "decay": (4, 64, 32)}
    assert _scratch_bytes(plan) == 4 * 4 * 64 * 32 * (64 * 128 + 128 + 1) == 272_662_528
    f32 = ss.plan(b, l, h, p, g, n, c, torch.float32)
    assert f32["heads_per_block"] == 1 and f32["grid_chunks"] == (64, 32, 4)


def test_plan_puts_batch_heads_on_the_state_pass_x_axis():
    """b·h past 65 535 (a grid's y limit) stays on the state pass's x axis."""
    plan = ss.plan(1025, 8, 64, 16, 1, 16, 32, torch.bfloat16)
    assert plan["grid_states"] == (65_600, 1) and plan["grid_chunks"] == (8, 1, 1025)


@pytest.mark.parametrize("heads, groups, per_block", [(64, 1, 8), (24, 2, 6), (14, 2, 7),
                                                      (9, 1, 3), (4, 4, 1), (2, 1, 2)])
def test_plan_heads_per_block(heads, groups, per_block):
    plan = ss.plan(1, 256, heads, 64, groups, 128, 128, torch.bfloat16)
    assert plan["heads_per_block"] == per_block
    assert plan["grid_chunks"] == (heads // per_block, 2, 1)


@pytest.mark.parametrize("l, chunk, c, chunks", [(1, 128, 8, 1), (37, 16, 16, 3), (9, 128, 16, 1),
                                                 (129, 128, 128, 2), (4096, 128, 128, 32),
                                                 (100, 32, 32, 4)])
def test_plan_chunks(l, chunk, c, chunks):
    plan = ss.plan(2, l, 4, 16, 2, 32, chunk, torch.bfloat16)
    assert (plan["chunk"], plan["chunks"]) == (c, chunks)
    assert _scratch_bytes(plan) == 4 * 2 * 4 * chunks * (16 * 32 + c + 1)



@pytest.mark.parametrize("args", [(1, 64, 2, 65, 1, 16, 32), (1, 64, 2, 16, 1, 129, 32),
                                  (1, 300, 2, 16, 1, 16, 256), (1, 0, 2, 16, 1, 16, 32),
                                  (1, 64, 3, 16, 2, 16, 32), (65_536, 8, 2, 16, 1, 16, 32),
                                  (1, 65_536 * 8 + 1, 2, 16, 1, 16, 8)])
def test_plan_refuses_past_the_limits(args):
    with pytest.raises(ValueError):
        ss.plan(*args, torch.bfloat16)


def _split_views(b, l, h, p, g, n, dtype=torch.bfloat16, extra=0):
    conv = torch.zeros(b, l, extra + h * p + 2 * g * n, dtype=dtype)[..., extra:]
    xc, bc, cc = torch.split(conv, [h * p, g * n, g * n], dim=-1)
    return xc.reshape(b, l, h, p), bc.reshape(b, l, g, n), cc.reshape(b, l, g, n)


def test_row_strides_take_the_mixers_split_views():
    b, l, h, p, g, n = 4, 64, 64, 64, 1, 128
    x, bm, cm = _split_views(b, l, h, p, g, n)
    assert not x.is_contiguous()
    row = h * p + 2 * g * n
    views = [(t, ss.row_strides(name, t, t.shape)) for name, t in (("x", x), ("b", bm), ("c", cm))]
    assert [s for _, s in views] == [(l * row, row)] * 3
    assert ss.vectorized(views)


def test_row_strides_read_size_one_dimensions_as_zero():
    x = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    odd = x.as_strided((1, 1, 8, 64), (7, 3, 64, 1))
    assert ss.row_strides("x", odd, (1, 1, 8, 64)) == (0, 0)
    assert ss.row_strides("x", x, (1, 1, 8, 64)) == (0, 0)
    assert ss.row_strides("x", torch.zeros(2, 5, 1, 8)[:, :, :, :], (2, 5, 1, 8)) == (40, 8)


@pytest.mark.parametrize("view", ["last_strided", "heads_not_packed", "shape"])
def test_row_strides_refuse_other_layouts(view):
    base = torch.zeros(2, 16, 4, 32)
    t = {"last_strided": base[..., ::2],
         "heads_not_packed": base[..., :16].transpose(1, 2).contiguous().transpose(1, 2),
         "shape": base[..., :16]}[view]
    with pytest.raises(ValueError):
        ss.row_strides("x", t, (2, 16, 4, 16))


def test_vectorized_needs_bf16_and_sixteen_byte_rows():
    b, l, h, p, g, n = 2, 16, 4, 16, 1, 32

    def vec(views):
        return ss.vectorized([(t, ss.row_strides("t", t, t.shape)) for t in views])

    assert vec(_split_views(b, l, h, p, g, n))
    assert not vec(_split_views(b, l, h, p, g, n, extra=4))       # 8-byte aligned views
    assert not vec(_split_views(b, l, h, 4, g, n))                 # rows of 8 bytes
    assert not vec(_split_views(b, l, h, p, g, n, torch.float32))  # f32 runs on the CUDA cores
    assert not vec(_split_views(b, l, h, p, 1, 12))                # state rows of 24 bytes

