"""The one-launch iteration tails of K1 and K7, on the CPU.

K1 (``fused_cg_update``) and K7 (``lsmr_update``) each have a second arm
that carries its solver's scalar recurrence and frozen-step mask in the
same launch: ``fused_cg_step`` (def-CG and cg from ``pᵀAp`` on) and
``lsmr_step`` (LSMR after ``‖w‖²``).  On the CPU their wrappers run the
plain versions, ``fused_cg_step_plain`` and ``lsmr_step_plain``.  Here:

1. the plain versions against the loops' former inline arithmetic (the
   lines the solver loops ran around the kernels before the tails moved
   into them), bit for bit, over seeded live, frozen, exact-termination,
   breakdown and already-failed states;
2. whole ``lsmr``, ``defcg`` and ``cg`` solves against the live JAX
   reference (``repro.core``, x64) on the same numpy inputs: x to 1e-10
   (``tests/test_cg_fused.py:316``), iteration counts, statuses and
   ``SolveInfo.matvecs`` equal;
3. a torch emulation of K1's one-launch reduction (per-thread sums in
   grid-stride order, the warp trees, per-block partials, the ticket and
   the last block's sum in block order) against the plain sums to 1e-13
   relative, and bit for bit the same for any block completion order;
4. the sharded LSMR step ends in the same tail function as the unsharded
   one (one ``lsmr_step`` call a step in each, the same iterates);
5. the stall detector armed in both step arms (``window > 0``): the
   window-0 outputs unchanged, ``(best, stall, fail)`` the reference's
   ``engine.stagnation_update`` bit for bit, and whole solves stopping
   STAGNATED on the reference's iteration (cg, def-CG, with and without
   Jacobi) or, for LSMR (P5), where the rule on its own history fires.

The card holds the kernels to these plain versions
(``tests/test_torch_cuda.py``: scalars bit for bit).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jc  # noqa: E402
import repro.core.engine as jengine  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.kernels import cg_fused as cf  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
import torch_reduction_order as ro  # noqa: E402
from tests.conftest import make_spd  # noqa: E402

tlsmr = importlib.import_module("repro_torch.core.lsmr")
sharded = importlib.import_module("repro_torch.core.sharded")
DTYPES = [torch.float64, torch.float32]


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(a, b):
    """Bit for bit, NaN where NaN."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.dtype.is_floating_point:
        return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
            torch.nan_to_num(a), torch.nan_to_num(b))
    return torch.equal(a, b)


def _assert_info_equal(ji, ti):
    for field in ("iterations", "matvecs", "status", "converged"):
        np.testing.assert_array_equal(
            _np(getattr(ti, field)), np.asarray(getattr(ji, field)), err_msg=field)


def _assert_trace_head(ti, ji, head=10):
    """The first ``head`` entries of the residual history to 1e-8: past
    about ten iterations a last-digit difference grows in either package
    (ROADMAP P1 for CG, P5 for LSMR)."""
    j = min(int(ti.iterations) + 1, head)
    np.testing.assert_allclose(_np(ti.residual_norms)[:j], np.asarray(ji.residual_norms)[:j],
                               rtol=1e-8)


# ---------------------------------------------------------------------------
# 1. The plain tails against the loops' former inline arithmetic
# ---------------------------------------------------------------------------


def _former_sym_ortho(a, b):
    r = torch.sqrt(a * a + b * b)
    safe = torch.where(r == 0.0, 1.0, r)
    return a / safe, b / safe, r


def _former_safe(v):
    return torch.where(v == 0.0, 1.0, v)


def _former_trace_write(trace, j, rnorm, active):
    slot = (j + 1).reshape(1).to(torch.int64)
    old = trace.index_select(0, slot)
    trace.index_copy_(0, slot, torch.where(active, rnorm.reshape(1), old))


def _former_classify_breakdown(d, rnorm, diverged_at):
    nonfinite = ~torch.isfinite(d)
    indefinite = (~nonfinite) & (d <= 0.0)
    diverging = rnorm > diverged_at
    bad = nonfinite | indefinite | diverging
    code = torch.where(nonfinite, 2, torch.where(indefinite, 3, 4))
    return bad, torch.where(bad, code, 0).to(torch.int32)


def _former_lsmr_tail(x, hbar, h, v, w_vec, beta_new, scalars, j, fail, active, threshold,
                      diverged_at, maxiter, trace):
    """The LSMR loop body from α⁺ on, as the loop ran it inline, and its
    ``active_fn`` on the new state."""
    alpha, zetabar, alphabar, rho, rhobar, cbar, sbar = scalars
    alpha_new = torch.sqrt(torch.dot(w_vec, w_vec))
    v_new = w_vec / _former_safe(alpha_new)
    c, s, rho_new = _former_sym_ortho(alphabar, beta_new)
    thetanew = s * alpha_new
    alphabar_new = c * alpha_new
    thetabar = sbar * rho_new
    cbar_new, sbar_new, rhobar_new = _former_sym_ortho(cbar * rho_new, thetanew)
    zeta = cbar_new * zetabar
    zetabar_new = -sbar_new * zetabar
    c0 = thetabar * rho_new / (rho * rhobar)
    c1 = zeta / (_former_safe(rho_new) * _former_safe(rhobar_new))
    c2 = thetanew / _former_safe(rho_new)
    x_new, hbar_new, h_new = tref.lsmr_update(x, hbar, h, v_new, c0, c1, c2)
    exact = (beta_new == 0.0) | (alpha_new == 0.0)
    zetabar_new = torch.where(exact, 0.0, zetabar_new)
    normar_new = torch.abs(zetabar_new)
    live = (fail == 0) & active
    fail = torch.where(live & ~torch.isfinite(normar_new), 2, fail).to(torch.int32)
    fail = torch.where((fail == 0) & active & (normar_new > diverged_at), 4, fail).to(torch.int32)
    if trace is not None:
        _former_trace_write(trace, j, normar_new, active)

    def sel(new, cur):
        return torch.where(active, new, cur)

    s_new = [sel(alpha_new, alpha), sel(zetabar_new, zetabar), sel(alphabar_new, alphabar),
             sel(rho_new, rho), sel(rhobar_new, rhobar), sel(cbar_new, cbar),
             sel(sbar_new, sbar)]
    j = j + active.to(j.dtype)
    active_next = (j < maxiter) & (torch.abs(s_new[1]) > threshold) & (fail == 0)
    return (sel(x_new, x), sel(hbar_new, hbar), sel(h_new, h), sel(v_new, v), s_new, j, fail,
            active_next)


LSMR_CASES = ["live", "frozen", "beta0", "alpha0", "nonfinite", "diverging", "failed", "last"]


def _lsmr_state(dtype, n, case, seed):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=dtype)

    x, hbar, h, v, w = (rnd(n) for _ in range(5))
    s = rnd(7).abs() + 0.1
    beta = rnd(()).abs() + 0.1
    j, fail = 3, 0
    threshold, diverged_at = torch.tensor(1e-6, dtype=dtype), torch.tensor(1e8, dtype=dtype)
    if case == "beta0":
        beta = torch.zeros((), dtype=dtype)
    if case == "alpha0":
        w = torch.zeros_like(w)
    if case == "nonfinite":
        s[5] = float("nan")
    if case == "diverging":
        diverged_at = torch.tensor(1e-30, dtype=dtype)
    if case == "failed":
        fail = 3
    if case == "last":  # the step that reaches maxiter
        j = 9
    js = torch.tensor([j, fail], dtype=torch.int32)
    active = torch.tensor(case not in ("frozen",))
    return x, hbar, h, v, w, beta, s, js, active, threshold, diverged_at


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 33])
@pytest.mark.parametrize("case", LSMR_CASES)
def test_lsmr_step_plain_is_the_former_loop_body(dtype, n, case):
    x, hbar, h, v, w, beta, s, js, active, thr, div = _lsmr_state(dtype, n, case, n + 7)
    trace_a = torch.full((12,), float("nan"), dtype=dtype)
    trace_b = trace_a.clone()
    got = kops.lsmr_step(x, hbar, h, v, w, torch.dot(w, w), beta, s, js, active, thr, div, 10,
                         trace_a)
    want = _former_lsmr_tail(x, hbar, h, v, w, beta, list(s.unbind()), js[0], js[1], active,
                             thr, div, 10, trace_b)
    for q in range(4):
        assert _same(got[q], want[q]), q
    assert _same(got[4], torch.stack(want[4]))
    assert _same(got[5], torch.stack([want[5], want[6]]))
    assert _same(got[6], want[7])
    assert _same(trace_a, trace_b)


def _former_defcg_tail(x, r, p, ap, d, rs, rnorm, j, fail, active, threshold, diverged_at,
                       maxiter, aw, waw_inv, trace, row, rows, recurrence):
    """def-CG's loop body around the fused update, as the loop ran it
    inline (its direction update left out: it stays its own launch), and
    its ``active_fn`` on the new state.  Returns the values the step arm
    returns."""
    bad, code = _former_classify_breakdown(d, rnorm, diverged_at)
    fail = torch.where((fail == 0) & active, code, fail)
    ap = torch.where(bad, 0.0, ap)
    alpha = torch.where(bad | ~active, 0.0, rs / torch.where(bad, 1.0, d))
    x, r, rr, awr = tref.fused_cg_update(x, r, p, ap, alpha, aw if recurrence else None)
    beta = mu = None
    if recurrence:
        mu = waw_inv @ awr if aw is not None else None
        beta = rr / torch.where(rs == 0.0, 1.0, rs)
        if row is not None:
            slot = torch.where(active, row, rows[0].shape[0] - 1).to(torch.int64)
            rows[0].index_copy_(0, slot.reshape(1), alpha.reshape(1))
            rows[1].index_copy_(0, slot.reshape(1), beta.reshape(1))
    keep = active & ~bad
    rnorm_new = torch.sqrt(rr)
    fail = torch.where((fail == 0) & active & ~torch.isfinite(rnorm_new), 2, fail).to(torch.int32)
    rnorm = torch.where(active, rnorm_new, rnorm)
    if trace is not None:
        _former_trace_write(trace, j, rnorm, active)
    j = j + active.to(j.dtype)
    active_next = (j < maxiter) & (rnorm > threshold) & (fail == 0)
    return x, r, ap, rr, rnorm, alpha, beta, mu, j, fail, active_next, keep


CG_CASES = ["live", "frozen", "indefinite", "nonfinite", "diverging", "failed", "rs0",
            "recording", "frozen-recording", "preconditioned"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [0, 3])
@pytest.mark.parametrize("case", CG_CASES)
def test_fused_cg_step_plain_is_the_former_loop_body(dtype, k, case):
    g = torch.Generator().manual_seed(k + len(case))

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=dtype)

    n = 29
    x, r, p, ap = (rnd(n) for _ in range(4))
    recurrence = case != "preconditioned"
    aw = rnd(k, n) if k and recurrence else None
    waw_inv = rnd(k, k) if aw is not None else None
    d = torch.dot(p, ap).abs() + 1.0
    rs = torch.dot(r, r)
    rnorm = torch.sqrt(rs)
    thr, div = torch.tensor(1e-6, dtype=dtype), torch.tensor(1e8, dtype=dtype)
    js = torch.tensor([2, 4 if case == "failed" else 0], dtype=torch.int32)
    active = torch.tensor("frozen" not in case)
    if case == "indefinite":
        d = -d
    if case == "nonfinite":
        d = torch.tensor(float("inf"), dtype=dtype)
    if case == "diverging":
        div = torch.tensor(1e-30, dtype=dtype)
    if case == "rs0":
        rs = torch.zeros((), dtype=dtype)
    row = 1 if "recording" in case else None
    rows_a = (torch.zeros(5, dtype=dtype), torch.zeros(5, dtype=dtype))
    rows_b = tuple(t.clone() for t in rows_a)
    trace_a = torch.full((12,), float("nan"), dtype=dtype)
    trace_b = trace_a.clone()
    kw = dict(recurrence=recurrence, trace=trace_a)
    if row is not None:
        kw.update(row=row, a_rows=rows_a[0], b_rows=rows_a[1])
    x1, r1, ap1, so, js1, flags = kops.fused_cg_step(x, r, p, ap, d, rs, rnorm, js, active, thr,
                                                     div, 10, aw, waw_inv, **kw)
    want = _former_defcg_tail(x, r, p, ap, d, rs, rnorm, js[0], js[1], active, thr, div, 10,
                              aw, waw_inv, trace_b, row, rows_b, recurrence)
    x2, r2, ap2, rr, rnorm2, alpha, beta, mu, j2, fail2, active2, keep = want
    for a, b in ((x1, x2), (r1, r2), (ap1, ap2), (so[0], rr), (so[1], rnorm2), (so[2], alpha),
                 (js1[0], j2), (js1[1], fail2), (flags[0], active2), (flags[1], keep)):
        assert _same(a, b)
    if recurrence:
        assert _same(so[3], beta)
        assert _same(so[4:], mu if mu is not None else so.new_zeros(0))
    assert _same(trace_a, trace_b)
    assert _same(rows_a[0], rows_b[0]) and _same(rows_a[1], rows_b[1])


def test_status_codes_and_slots_match_the_engine():
    """The codes the tails write are the engine's, and the packed LSMR
    scalars start as the loop's initial state."""
    assert (cf.BREAKDOWN_NONFINITE, cf.BREAKDOWN_INDEFINITE, cf.STAGNATED) == (
        tc.SolveStatus.BREAKDOWN_NONFINITE, tc.SolveStatus.BREAKDOWN_INDEFINITE,
        tc.SolveStatus.STAGNATED)
    assert engine.classify_breakdown is cf.classify_breakdown
    v = torch.ones(4, dtype=torch.float64)
    alpha1, normar0 = torch.tensor(2.0, dtype=torch.float64), torch.tensor(3.0, dtype=torch.float64)
    state = tlsmr.lsmr_initial_state(v, v, None, v, v, alpha1, normar0,
                                     torch.tensor(1e-6, dtype=torch.float64), 5, None)
    js, s, active = state[:3]
    assert dict(zip(cf.LSMR_SLOTS, s.tolist())) == {
        "alpha": 2.0, "zetabar": 3.0, "alphabar": 2.0, "rho": 1.0, "rhobar": 1.0, "cbar": 1.0,
        "sbar": 0.0}
    assert js.tolist() == [0, 0] and bool(active)


# ---------------------------------------------------------------------------
# 2. Whole solves against the JAX reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["cold", "damped", "warm", "deflated-window", "tight"])
def test_lsmr_solve_matches_reference(case):
    rng = np.random.default_rng(len(case))
    m, n = 40, 25
    A, b = rng.standard_normal((m, n)), rng.standard_normal(m)
    damp = 0.0 if case in ("cold", "tight") else 0.1
    x0 = rng.standard_normal(n) if case == "warm" else None
    kw = dict(damp=damp, tol=1e-12 if case == "tight" else 1e-10, maxiter=300,
              record_residuals=True)
    jargs, targs = [], []
    if case == "deflated-window":
        W = np.linalg.qr(rng.standard_normal((n, 4)))[0].T
        NW = W @ (A.T @ A) + damp * W
        jargs, targs = [jnp.asarray(W), jnp.asarray(NW)], [_t(W), _t(NW)]
        kw["ell"] = 6
    ref = jc.lsmr(jc.DenseMatrixOperator(jnp.asarray(A)), jnp.asarray(b),
                  None if x0 is None else jnp.asarray(x0), *jargs,
                  **({"flat_recycle": True} if jargs else {}), **kw)
    got = tc.lsmr(tc.DenseMatrixOperator(_t(A)), _t(b), None if x0 is None else _t(x0),
                  *targs, **kw)
    if jargs:
        # The deflated solve ends at its threshold: the packages stop one
        # iteration apart by rounding alone (ROADMAP P5; the same before
        # the tail moved into the kernel), so the count is held within one
        # and the charge to the count.
        assert abs(int(got.info.iterations) - int(ref.info.iterations)) <= 1
        assert int(got.info.matvecs) == 1 + 2 * int(got.info.iterations)
        assert bool(got.info.converged) and bool(ref.info.converged)
    else:
        _assert_info_equal(ref.info, got.info)
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)
    _assert_trace_head(got.info, ref.info)
    if jargs:
        np.testing.assert_allclose(_np(got.recycle.P), np.asarray(ref.recycle.P), atol=1e-10)


@pytest.mark.parametrize("case", ["deflated", "window", "preconditioned", "plain"])
def test_defcg_solve_matches_reference(case):
    rng = np.random.default_rng(3 + len(case))
    n, k = 60, 4
    A, _, _ = make_spd(n, 1e3, rng)
    b = rng.standard_normal(n)
    kw = dict(tol=1e-10, maxiter=600, record_residuals=True)
    jargs = targs = (None, None)
    if case != "plain":
        W = np.linalg.qr(rng.standard_normal((n, k)))[0].T
        jargs, targs = (jnp.asarray(W), jnp.asarray(W @ A)), (_t(W), _t(W @ A))
    if case == "window":
        kw["ell"] = 6
    jkw, tkw = dict(kw), dict(kw)
    if case == "preconditioned":
        diag = np.diag(A).copy()
        jkw["M"] = jc.jacobi(jnp.asarray(diag))
        tkw["M"] = tc.jacobi(_t(diag))
    ref = jc.defcg(jc.from_matrix(jnp.asarray(A)), jnp.asarray(b), None, *jargs,
                   flat_recycle=True, **jkw)
    got = tc.defcg(tc.from_matrix(_t(A)), _t(b), None, *targs, **tkw)
    _assert_info_equal(ref.info, got.info)
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)
    _assert_trace_head(got.info, ref.info)
    if case == "window":
        for field in ("P", "AP", "alpha", "beta"):
            np.testing.assert_allclose(_np(getattr(got.recycle, field)),
                                       np.asarray(getattr(ref.recycle, field)), atol=1e-10,
                                       err_msg=field)


@pytest.mark.parametrize("case", ["plain", "preconditioned", "indefinite"])
def test_cg_solve_matches_reference(case):
    rng = np.random.default_rng(11 + len(case))
    n = 50
    A, _, _ = make_spd(n, 1e2, rng)
    if case == "indefinite":  # a negative eigenvalue: pᵀAp ≤ 0 stops the solve
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A = (q * np.linspace(-1.0, 5.0, n)) @ q.T
    b = rng.standard_normal(n)
    jkw, tkw = dict(tol=1e-10, maxiter=400), dict(tol=1e-10, maxiter=400)
    if case == "preconditioned":
        diag = np.diag(A).copy()
        jkw["M"] = jc.jacobi(jnp.asarray(diag))
        tkw["M"] = tc.jacobi(_t(diag))
    ref = jc.cg(jc.from_matrix(jnp.asarray(A)), jnp.asarray(b), **jkw)
    got = tc.cg(tc.from_matrix(_t(A)), _t(b), **tkw)
    _assert_info_equal(ref.info, got.info)
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)
    if case == "indefinite":
        assert int(got.info.status) == tc.SolveStatus.BREAKDOWN_INDEFINITE


# ---------------------------------------------------------------------------
# 2b. The stall detector in the step arms (stagnation_window > 0)
# ---------------------------------------------------------------------------

# Where the armed state stands against the step's fresh residual r':
# best far above it (improved), at it (a stall), at r' / 0.99 (the bar's
# own rounding decides), the latching step (stall = window − 1), a frozen
# step, an already failed solve, and a NaN best (torch.minimum keeps NaN).
STALL_CASES = ["improved", "stall", "bar", "latch", "frozen", "failed", "nan-best"]
WINDOW = 4


def _stall_state(case, rnorm_new, dtype):
    stall = WINDOW - 1 if case == "latch" else 1
    best = {"improved": 1.5 * rnorm_new, "bar": rnorm_new / 0.99,
            "nan-best": torch.tensor(float("nan"), dtype=dtype)}.get(case, rnorm_new)
    return torch.as_tensor(best, dtype=dtype).reshape(()), stall


def _reference_stall(best, stall, norm_new, fail, active):
    """The reference's ``engine.stagnation_update`` on the same values."""
    (b, st), f = jengine.stagnation_update(
        (jnp.asarray(_np(best)), jnp.int32(stall)), jnp.asarray(_np(norm_new)),
        jnp.int32(int(fail)), jnp.bool_(bool(active)), WINDOW)
    return np.asarray(b), int(st), int(f)


def _assert_stall_equal(best_got, stall_got, fail_got, want):
    b, st, f = want
    assert _same(best_got, torch.as_tensor(np.array(b))), (best_got, b)
    assert int(stall_got) == st and int(fail_got) == f


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [0, 3])
@pytest.mark.parametrize("case", STALL_CASES)
def test_fused_cg_step_armed_matches_reference_stall(dtype, k, case):
    """K1's armed step arm: every output of the window-0 arm unchanged
    (but ``fail`` and the next active flag where the stall latches), and
    ``(best', stall', fail')`` the reference's ``stagnation_update``, bit
    for bit."""
    g = torch.Generator().manual_seed(k + 3 * len(case))

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=dtype)

    n = 29
    x, r, p, ap = (rnd(n) for _ in range(4))
    aw = rnd(k, n) if k else None
    waw_inv = rnd(k, k) if k else None
    d = torch.dot(p, ap).abs() + 1.0
    rs = torch.dot(r, r)
    rnorm = torch.sqrt(rs)
    thr, div = torch.tensor(1e-6, dtype=dtype), torch.tensor(1e8, dtype=dtype)
    fail0 = 3 if case == "failed" else 0
    active = torch.tensor(case != "frozen")
    js2 = torch.tensor([2, fail0], dtype=torch.int32)
    plain = kops.fused_cg_step(x, r, p, ap, d, rs, rnorm, js2, active, thr, div, 10, aw,
                               waw_inv)
    rnorm_new = torch.sqrt(plain[3][0])
    best, stall = _stall_state(case, rnorm_new, dtype)
    js3 = torch.tensor([2, fail0, stall], dtype=torch.int32)
    armed = kops.fused_cg_step(x, r, p, ap, d, rs, rnorm, js3, active, thr, div, 10, aw,
                               waw_inv, window=WINDOW, best=best)
    for q in range(3):
        assert _same(armed[q], plain[q])
    so, js, flags = armed[3], armed[4], armed[5]
    assert so.shape == (5 + k,) and js.shape == (3,)
    assert _same(so[:4 + k], plain[3])
    assert int(js[0]) == int(plain[4][0])
    want = _reference_stall(best, stall, rnorm_new, fail0, active)
    _assert_stall_equal(so[-1], js[2], js[1], want)
    latched = want[2] == tc.SolveStatus.STAGNATED and fail0 == 0
    assert latched == (case == "latch")
    assert bool(flags[0]) == (bool(plain[5][0]) and not latched)
    assert _same(flags[1], plain[5][1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", STALL_CASES)
def test_lsmr_step_armed_matches_reference_stall(dtype, case):
    """K7's armed step arm, as K1's: the window-0 outputs unchanged, the
    best residual in ``s``'s extra slot and the stall count in ``js[2]``
    the reference's ``stagnation_update``, bit for bit."""
    x, hbar, h, v, w, beta, s, js, active, thr, div = _lsmr_state(dtype, 17, "live", len(case))
    if case == "frozen":
        active = torch.tensor(False)
    fail0 = 3 if case == "failed" else 0
    js = torch.tensor([3, fail0], dtype=torch.int32)
    wsq = torch.dot(w, w)
    plain = kops.lsmr_step(x, hbar, h, v, w, wsq, beta, s, js, active, thr, div, 10)
    normar_new = torch.abs(kops.lsmr_step(x, hbar, h, v, w, wsq, beta, s, js, torch.tensor(True),
                                          thr, div, 10)[4][1])
    best, stall = _stall_state(case, normar_new, dtype)
    s8 = torch.cat([s, best.reshape(1)])
    js3 = torch.tensor([3, fail0, stall], dtype=torch.int32)
    armed = kops.lsmr_step(x, hbar, h, v, w, wsq, beta, s8, js3, active, thr, div, 10,
                           window=WINDOW)
    for q in range(4):
        assert _same(armed[q], plain[q])
    assert _same(armed[4][:7], plain[4])
    assert int(armed[5][0]) == int(plain[5][0])
    want = _reference_stall(best, stall, normar_new, fail0, active)
    _assert_stall_equal(armed[4][7], armed[5][2], armed[5][1], want)
    latched = want[2] == tc.SolveStatus.STAGNATED and fail0 == 0
    assert latched == (case == "latch")
    assert bool(armed[6]) == (bool(plain[6]) and not latched)


def _stall_step(trace, window):
    """The first iteration at which the stall rule, applied to a recorded
    residual history (slot 0 the initial residual), reaches ``window``."""
    trace = _np(trace)
    best, stall = trace[0], 0
    for j in range(1, trace.shape[0]):
        if np.isnan(trace[j]):
            return None
        stall = 0 if trace[j] < 0.99 * best else stall + 1
        best = min(best, trace[j])
        if stall >= window:
            return j
    return None


@pytest.mark.parametrize("method", ["cg", "defcg", "defcg-jacobi", "cg-jacobi"])
def test_stagnation_solve_matches_reference(method):
    """A bounded perturbation of every product floors the residual: both
    packages stop STAGNATED on the same iteration, with the same matvecs
    and x to 1e-10."""
    rng = np.random.default_rng(2)
    A, _, _ = make_spd(32, 1e2, rng)
    b = rng.standard_normal(32)
    base = "cg" if method.startswith("cg") else "defcg"
    spec_kw = dict(method=base, k=4, ell=6, tol=1e-12, maxiter=400, stagnation_window=10,
                   recovery_rungs=0)
    jkw, tkw = {}, {}
    if method.endswith("jacobi"):
        spec_kw["precond"] = "jacobi"
        jkw["M"], tkw["M"] = jc.jacobi(jnp.asarray(np.diag(A).copy())), tc.jacobi(_t(np.diag(A)))
    ref = jc.solve(jc.FaultInjectingOperator(jc.from_matrix(jnp.asarray(A)), poison=1e-3),
                   jnp.asarray(b), jc.SolveSpec(**spec_kw), record_residuals=True, **jkw)
    got = tc.solve(tc.FaultInjectingOperator(tc.from_matrix(_t(A)), poison=1e-3), _t(b),
                   tc.SolveSpec(**spec_kw), record_residuals=True, **tkw)
    _assert_info_equal(ref.info, got.info)
    assert int(got.info.status) == tc.SolveStatus.STAGNATED
    assert _stall_step(got.info.residual_norms, 10) == int(got.info.iterations)
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)


@pytest.mark.parametrize("seed,window", [(3, 1), (4, 1), (0, 2)])
def test_stagnation_lsmr_stops_where_its_trace_stalls(seed, window):
    """LSMR on a cond-100 system: each package stops STAGNATED exactly where
    the stall rule on its own ‖Âᵀr̂‖ history fires.  The two histories part
    after a few iterations by rounding (ROADMAP P5), so the stopping
    iterations are held within P5's 8 a system, the charge to 2 an
    iteration."""
    rng = np.random.default_rng(seed)
    m, n = 40, 24
    U = np.linalg.qr(rng.standard_normal((m, n)))[0]
    V = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = U @ np.diag(np.logspace(0, -2, n)) @ V.T
    b = rng.standard_normal(m)
    kw = dict(tol=1e-12, maxiter=200, stagnation_window=window, record_residuals=True)
    ref = jc.lsmr(jc.DenseMatrixOperator(jnp.asarray(A)), jnp.asarray(b), **kw)
    got = tc.lsmr(tc.DenseMatrixOperator(_t(A)), _t(b), **kw)
    for info in (ref.info, got.info):
        assert int(info.status) == tc.SolveStatus.STAGNATED
        assert _stall_step(info.residual_norms, window) == int(info.iterations)
    assert abs(int(got.info.iterations) - int(ref.info.iterations)) <= 8
    assert int(got.info.matvecs) == 1 + 2 * int(got.info.iterations)
    _assert_trace_head(got.info, ref.info, head=6)


# ---------------------------------------------------------------------------
# 3. K1's one-launch reduction, emulated
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 1000, 36551])
@pytest.mark.parametrize("grid", [1, 3, 143])
@pytest.mark.parametrize("vec", [None, 2])
@pytest.mark.parametrize("k", [0, 8])
def test_k1_reduction_order(n, grid, vec, k):
    g = torch.Generator().manual_seed(n + grid + k)
    rn = torch.randn(n, generator=g, dtype=torch.float64)
    aw = torch.randn(k, n, generator=g, dtype=torch.float64)
    prods = torch.cat([(rn * rn)[None], aw * rn[None]])
    want = torch.cat([torch.dot(rn, rn)[None], aw @ rn])
    results = []
    for seed in range(3):
        order = torch.randperm(grid, generator=torch.Generator().manual_seed(seed)).tolist()
        results.append(ro.emulate_sums(prods, grid, vec, order))
    assert all(torch.equal(results[0], res) for res in results[1:])
    scale = prods.abs().sum(dim=1)
    assert bool(((results[0] - want).abs() <= 1e-13 * scale).all())


# ---------------------------------------------------------------------------
# 4. The sharded LSMR step ends in the same tail
# ---------------------------------------------------------------------------


class _OneRank:
    """A solve mesh of one rank: every collective is the identity."""

    size = 1

    def all_reduce(self, t):
        return t


@pytest.mark.parametrize("damp", [0.0, 0.1])
def test_sharded_lsmr_shares_the_tail(monkeypatch, damp):
    assert sharded.lsmr_tail is tlsmr.lsmr_tail
    assert sharded.lsmr_initial_state is tlsmr.lsmr_initial_state
    calls = []
    step = kops.lsmr_step

    def counting(*args, **kwargs):
        calls.append(1)
        return step(*args, **kwargs)

    monkeypatch.setattr(kops, "lsmr_step", counting)
    rng = np.random.default_rng(2)
    A, b = _t(rng.standard_normal((30, 20))), _t(rng.standard_normal(30))
    kw = dict(tol=1e-10, atol=0.0, maxiter=200, record_residuals=True)
    got = tc.lsmr(tc.DenseMatrixOperator(A), b, damp=damp, **kw)
    unsharded_calls, calls[:] = len(calls), []
    x, info = sharded._sharded_lsmr(lambda v: A @ v, lambda u: A.T @ u, _OneRank(), b,
                                    torch.zeros(20, dtype=torch.float64), has_x0=False,
                                    damp=damp, **kw)
    # Every step, live or frozen, is one tail call in both loops.
    steps = engine.CHUNK * -(-int(got.info.iterations) // engine.CHUNK)
    assert unsharded_calls == len(calls) == steps
    assert int(info.iterations) == int(got.info.iterations)
    assert int(info.status) == int(got.info.status)
    np.testing.assert_allclose(_np(x), _np(got.x), atol=1e-12)


# ---------------------------------------------------------------------------
# 5. The entry points dispatch by device and never fall back
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["auto", "plain", "reference"])
def test_step_entry_points_run_the_plain_version_on_the_cpu(backend):
    x, hbar, h, v, w, beta, s, js, active, thr, div = _lsmr_state(torch.float64, 9, "live", 3)
    got = kops.lsmr_step(x, hbar, h, v, w, torch.dot(w, w), beta, s, js, active, thr, div, 10,
                         backend=backend)
    want = cf.lsmr_step_plain(x, hbar, h, v, w, torch.dot(w, w), beta, s, js, active, thr, div, 10)
    assert all(_same(a, b) for a, b in zip(got, want))
    d = torch.dot(x, v).abs() + 1.0
    rs = torch.dot(h, h)
    args = (x, hbar, h, v, d, rs, rs.sqrt(), js, active, thr, div, 10)
    got = kops.fused_cg_step(*args, backend=backend)
    want = cf.fused_cg_step_plain(*args)
    assert all(_same(a, b) for a, b in zip(got, want))


def test_step_entry_points_refuse_cuda_on_cpu_tensors():
    x, hbar, h, v, w, beta, s, js, active, thr, div = _lsmr_state(torch.float64, 9, "live", 4)
    with pytest.raises(ValueError, match="CUDA"):
        kops.lsmr_step(x, hbar, h, v, w, torch.dot(w, w), beta, s, js, active, thr, div, 10,
                       backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        kops.fused_cg_step(x, hbar, h, v, torch.dot(x, v), torch.dot(h, h), torch.dot(h, h), js,
                           active, thr, div, 10, backend="cuda")
    # The wrappers themselves refuse a CPU tensor: no fallback.
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu tensor"):
        cf.lsmr_step_cuda(x, hbar, h, v, w, torch.dot(w, w), beta, s, js, active, thr, div, 10)
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu tensor"):
        cf.fused_cg_step_cuda(x, hbar, h, v, torch.dot(x, v), torch.dot(h, h), torch.dot(h, h),
                              js, active, thr, div, 10)
