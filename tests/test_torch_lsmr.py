"""Least-squares path of the PyTorch port against the live JAX reference.

The same numpy inputs go through ``repro`` (x64 on, ``tests/conftest.py``)
and ``repro_torch`` on the CPU, where the port's kernel wrappers run
their plain versions.  Tolerances:

* ``lsmr_update``: f64 1e-13 against the reference's ``reference`` and
  ``chunked`` arms (both compute in f64 off the TPU, as the port's f64
  kernel does); f32 1e-6 against the Pallas kernel in interpret mode and
  the ``chunked`` arm (the tolerance of ``tests/test_lsmr.py``);
* operators: adjoint gaps 1e-10 (``tests/test_operators.py``'s
  ``ADJ_TOL``), products against the reference 1e-12;
* ``lsmr``: x 1e-10, iteration and matvec counts equal;
* recycled sequences (ROADMAP queue 3, P5): on the ill-conditioned
  drifting systems of ``tests/test_lsmr.py`` (κ(Â) ≈ 100) LSMR's Krylov
  vectors lose orthogonality after about ten iterations and a
  last-digit difference between the packages grows until the recorded
  ``(v, N̂v)`` rows past the first dozen differ at O(1), while x still
  converges to the same minimizer.  So with the reference test's window
  (k = 8, ℓ = 40) the carried bases part after the first system and each
  system's count moves by up to 10 % (the reference itself moves by up
  to 3 iterations when its products are summed in another order;
  ``tools/lsmr_rounding_witness.py``).  There the tests hold what does
  not depend on rounding: convergence, the ridge solution, recycling's
  saving, the matvec accounting, and counts within 10 %.  With a window
  inside the faithful rows (ℓ = 8) the bases agree up to the sign of each
  row at 1e-10 over the whole sequence, and counts within 3.  Where the
  solves take few iterations (λ = 0.1) everything matches: counts equal,
  x 1e-10.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jc  # noqa: E402
from repro.core import pytree as jpt  # noqa: E402
from repro.core.strategies import extract_next_basis_core as jextract  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import pytree as tpt  # noqa: E402
from repro_torch.core.strategies import extract_next_basis_core  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

ADJ_TOL = 1e-10
RECT_SHAPES = [(7, 4), (4, 7), (23, 11), (11, 23), (16, 16)]


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rect(m, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)), rng.standard_normal(m)


def _ill_conditioned_sequence(num, m=90, n=60, drift=0.02, seed=3):
    """``tests/test_lsmr.py``'s drifting systems (logspace(0, −3) singular
    values), as numpy."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, m)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    base = U[:, :n] @ np.diag(np.logspace(0, -3, n)) @ V.T
    mats, bs = [], []
    for _ in range(num):
        mats.append(base)
        bs.append(rng.standard_normal(m))
        base = base + drift * np.linalg.norm(base) / np.sqrt(m * n) * rng.standard_normal((m, n))
    return np.stack(mats), np.stack(bs)


def _sign_aligned(ref, got):
    ref, got = _np(ref), _np(got)
    sign = np.where(np.sum(ref * got, axis=1) < 0, -1.0, 1.0)[:, None]
    return sign * got, sign


def _assert_basis_close(W_ref, NW_ref, W_got, NW_got, atol=1e-10):
    w_al, sign = _sign_aligned(W_ref, W_got)
    np.testing.assert_allclose(w_al, np.asarray(W_ref), atol=atol)
    np.testing.assert_allclose(sign * _np(NW_got), np.asarray(NW_ref), atol=atol)


def _assert_info_equal(ji, ti, fields=("iterations", "matvecs", "status", "converged")):
    for field in fields:
        np.testing.assert_array_equal(
            _np(getattr(ti, field)), np.asarray(getattr(ji, field)), err_msg=field
        )


def _assert_counts_close(ji, ti, its_tol):
    """Per-system iterations within ``its_tol``, the same matvec charges
    beyond the two per iteration, and the same statuses."""
    its_ref, its = np.asarray(ji.iterations), _np(ti.iterations)
    assert np.all(np.abs(its - its_ref) <= its_tol), (its, its_ref)
    np.testing.assert_array_equal(_np(ti.matvecs) - 2 * its,
                                  np.asarray(ji.matvecs) - 2 * its_ref)
    np.testing.assert_array_equal(_np(ti.status), np.asarray(ji.status))


# ---------------------------------------------------------------------------
# K7: lsmr_update
# ---------------------------------------------------------------------------

K7_ARMS = {
    "f64-reference": ("reference", np.float64, 1e-13),
    "f64-chunked": ("chunked", np.float64, 1e-13),
    "f32-interpret": ("interpret", np.float32, 1e-6),
    "f32-chunked": ("chunked", np.float32, 1e-6),
}


@pytest.mark.parametrize("arm", sorted(K7_ARMS))
@pytest.mark.parametrize("n", [4096, 1000, 130])
def test_lsmr_update_matches_reference(arm, n):
    impl, dtype, tol = K7_ARMS[arm]
    rng = np.random.default_rng(n)
    vecs = [rng.standard_normal(n).astype(dtype) for _ in range(4)]
    c = (0.37, -1.21, 0.83)
    want = jops.lsmr_update(*(jnp.asarray(v) for v in vecs), *c, impl=impl)
    args = [torch.from_numpy(v) for v in vecs]
    cs = [torch.tensor(ci, dtype=args[0].dtype) for ci in c]
    for got in (tops.lsmr_update(*args, *cs), tref.lsmr_update(*args, *cs)):
        for g, w, name in zip(got, want, ("x", "hbar", "h")):
            assert g.dtype == args[0].dtype
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol,
                                       err_msg=f"{arm} {name} n={n}")


def test_lsmr_update_backends():
    """``plain`` is the oracle plus its counter; ``cuda`` refuses a CPU
    tensor rather than falling back."""
    args = [torch.randn(50, dtype=torch.float64) for _ in range(4)]
    c = [torch.tensor(v, dtype=torch.float64) for v in (0.1, 0.2, 0.3)]
    for g, w in zip(tops.lsmr_update(*args, *c, backend="plain"),
                    tops.lsmr_update(*args, *c, backend="reference")):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA"):
        tops.lsmr_update(*args, *c, backend="cuda")


# ---------------------------------------------------------------------------
# Operators: rectangular adjoints, Gauss-Newton and GGN products
# ---------------------------------------------------------------------------


def _gap(op, v, w):
    """|⟨Av, w⟩ − ⟨v, Aᵀw⟩| scaled to the magnitudes involved."""
    lhs = float(torch.dot(op.matvec(v), w))
    rhs = float(torch.dot(v, tc.adjoint_matvec(op)(w)))
    return abs(lhs - rhs) / max(1.0, abs(lhs), abs(rhs))


@pytest.mark.parametrize("m,n", RECT_SHAPES)
def test_dense_operator_rectangular(m, n):
    rng = np.random.default_rng(m * 100 + n)
    A, v, w = rng.standard_normal((m, n)), rng.standard_normal(n), rng.standard_normal(m)
    jop, top = jc.DenseMatrixOperator(jnp.asarray(A)), tc.DenseMatrixOperator(_t(A))
    np.testing.assert_allclose(_np(top.matvec(_t(v))), np.asarray(jop.matvec(jnp.asarray(v))),
                               atol=1e-12)
    np.testing.assert_allclose(_np(top.rmatvec(_t(w))), np.asarray(jop.rmatvec(jnp.asarray(w))),
                               atol=1e-12)
    assert top.domain_size == n
    assert _gap(top, _t(v), _t(w)) < ADJ_TOL
    assert _gap(top.T, _t(w), _t(v)) < ADJ_TOL
    assert torch.equal(top.T.T.mat, _t(A))
    lin = tc.LinearOperator(matvec=lambda x: _t(A) @ x, rmatvec=lambda u: _t(A).T @ u)
    assert _gap(lin, _t(v), _t(w)) < ADJ_TOL
    assert _gap(lin.T, _t(w), _t(v)) < ADJ_TOL
    assert torch.equal(lin.T.T.matvec(_t(v)), lin.matvec(_t(v)))
    sym = tc.from_callable(lambda x: x)
    assert tc.adjoint_matvec(sym) is sym.matvec and sym.T is sym


@pytest.mark.parametrize("m,n", RECT_SHAPES)
def test_gauss_newton_operator_matches_reference(m, n):
    rng = np.random.default_rng(m * 100 + n + 3)
    X, y = rng.standard_normal((m, n)), rng.standard_normal(m)
    p, v, w = rng.standard_normal(n), rng.standard_normal(n), rng.standard_normal(m)
    jop = jc.GaussNewtonOperator(lambda q: jnp.tanh(jnp.asarray(X) @ q) - jnp.asarray(y),
                                 jnp.asarray(p))
    top = tc.GaussNewtonOperator(lambda q: torch.tanh(_t(X) @ q) - _t(y), _t(p))
    np.testing.assert_allclose(_np(top.matvec(_t(v))), np.asarray(jop.matvec(jnp.asarray(v))),
                               atol=1e-12)
    np.testing.assert_allclose(_np(top.rmatvec(_t(w))), np.asarray(jop.rmatvec(jnp.asarray(w))),
                               atol=1e-12)
    np.testing.assert_allclose(_np(top.residuals()), np.asarray(jop.residuals()), atol=1e-12)
    assert _gap(top, _t(v), _t(w)) < ADJ_TOL
    assert _gap(top.T, _t(w), _t(v)) < ADJ_TOL


def test_gauss_newton_operator_dict_domain():
    """Dict parameters and residuals, inserted in unsorted key order: the
    port ravels them as JAX does (keys sorted), so flat vectors mean the
    same coordinates in both packages."""
    rng = np.random.default_rng(7)
    X = rng.standard_normal((9, 5))

    def residual(lib, tensor):
        def fn(p):
            h = lib.tanh(tensor(X) @ p["w"] + p["b"])
            return {"r2": 2.0 * h[4:], "r1": h[:4]}
        return fn

    params = {"w": rng.standard_normal(5), "b": rng.standard_normal(())}
    v_flat, u_flat = rng.standard_normal(6), rng.standard_normal(9)
    jparams = {k: jnp.asarray(a) for k, a in params.items()}
    jop = jc.GaussNewtonOperator(residual(jnp, jnp.asarray), jparams)
    top = tc.GaussNewtonOperator(residual(torch, _t), {k: _t(a) for k, a in params.items()})
    _, unravel_x = jpt.ravel_vector(jparams)
    _, unravel_r = jpt.ravel_vector(jop.residuals())
    want_jv = jpt.ravel(jop.matvec(unravel_x(jnp.asarray(v_flat))))
    want_jtu = jpt.ravel(jop.rmatvec(unravel_r(jnp.asarray(u_flat))))
    np.testing.assert_allclose(_np(top.matvec(_t(v_flat))), np.asarray(want_jv), atol=1e-12)
    np.testing.assert_allclose(_np(top.rmatvec(_t(u_flat))), np.asarray(want_jtu), atol=1e-12)
    assert top.domain_size == 6
    assert _gap(top, _t(v_flat), _t(u_flat)) < ADJ_TOL
    flat, unravel = tpt.ravel_vector({k: _t(a) for k, a in params.items()})
    np.testing.assert_array_equal(_np(flat), np.asarray(jpt.ravel(jparams)))
    back = unravel(flat)
    assert torch.equal(back["w"], _t(params["w"])) and back["b"].shape == ()


def test_ggn_operator_matches_reference():
    """GGN products (one vector and a stacked basis) on dict parameters in
    unsorted key order, with the f32 LM damping of ``hf_step``."""
    rng = np.random.default_rng(24)
    X = rng.standard_normal((20, 6))
    params = {"w": rng.standard_normal((6, 2)), "b": rng.standard_normal(2)}
    basis = rng.standard_normal((3, 14))

    def model(lib, tensor):
        return lambda p: lib.tanh(tensor(X) @ p["w"] + p["b"])

    jparams = {k: jnp.asarray(a) for k, a in params.items()}
    jop = jc.GGNOperator(model(jnp, jnp.asarray), lambda out, t: 2.0 * t / out.size, jparams,
                         damping=jnp.float32(0.3))
    top = tc.GGNOperator(model(torch, _t), lambda out, t: 2.0 * t / out.numel(),
                         {k: _t(a) for k, a in params.items()},
                         damping=torch.tensor(0.3, dtype=torch.float32))
    _, unravel = jpt.ravel_vector(jparams)
    want = [jpt.ravel(jop.matvec(unravel(jnp.asarray(b)))) for b in basis]
    got = [top.matvec(_t(b)) for b in basis]
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-12)
    want_basis = jax.vmap(lambda b: jpt.ravel(jop.matvec(unravel(b))))(jnp.asarray(basis))
    np.testing.assert_allclose(_np(top.basis_matvec(_t(basis))), np.asarray(want_basis),
                               atol=1e-12)
    v, w = _t(basis[0]), _t(basis[1])
    assert _gap(top, v, w) < ADJ_TOL


# ---------------------------------------------------------------------------
# lsmr
# ---------------------------------------------------------------------------

LSMR_CASES = {
    "lstsq-tall": dict(shape=(80, 50), damp=0.0, warm=False, tol=1e-12),
    "lstsq-wide": dict(shape=(50, 80), damp=0.0, warm=False, tol=1e-12),
    "ridge": dict(shape=(70, 40), damp=0.25, warm=False, tol=1e-12),
    "ridge-warm-start": dict(shape=(70, 40), damp=0.4, warm=True, tol=1e-12),
}


@pytest.mark.parametrize("case", sorted(LSMR_CASES))
def test_lsmr_matches_reference(case):
    cfg = LSMR_CASES[case]
    m, n = cfg["shape"]
    A, b = _rect(m, n, seed=m + n + int(100 * cfg["damp"]))
    x0 = np.random.default_rng(13).standard_normal(n) if cfg["warm"] else None
    kw = dict(damp=cfg["damp"], tol=cfg["tol"], maxiter=400, record_residuals=True)
    ref = jc.lsmr(jc.DenseMatrixOperator(jnp.asarray(A)), jnp.asarray(b),
                  None if x0 is None else jnp.asarray(x0), **kw)
    got = tc.lsmr(tc.DenseMatrixOperator(_t(A)), _t(b), None if x0 is None else _t(x0), **kw)
    _assert_info_equal(ref.info, got.info)
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)
    assert int(got.info.matvecs) == (1 if x0 is None else 2) + 2 * int(got.info.iterations)
    j = int(got.info.iterations)
    # The normal-residual history, down to 1e-3 of its start; below that
    # the rounding of each package shows in the leading digits (P5).
    trace_ref = np.asarray(ref.info.residual_norms)[: j + 1]
    head = trace_ref > 1e-3 * trace_ref[0]
    np.testing.assert_allclose(_np(got.info.residual_norms)[: j + 1][head], trace_ref[head],
                               rtol=1e-8)
    # The dense solution, as the reference's own test holds it.
    x_ref = np.linalg.solve(A.T @ A + cfg["damp"] * np.eye(n), A.T @ b) if m >= n or cfg["damp"] \
        else np.linalg.lstsq(A, b, rcond=None)[0]
    assert np.linalg.norm(_np(got.x) - x_ref) / np.linalg.norm(x_ref) < 1e-8


def test_lsmr_zero_and_nonfinite_rhs():
    A, b = _rect(30, 20, seed=14)
    jA, tA = jc.DenseMatrixOperator(jnp.asarray(A)), tc.DenseMatrixOperator(_t(A))
    for rhs in (np.zeros(30), np.where(np.arange(30) == 0, np.nan, b)):
        ref = jc.lsmr(jA, jnp.asarray(rhs), tol=1e-10, maxiter=50)
        got = tc.lsmr(tA, _t(rhs), tol=1e-10, maxiter=50)
        _assert_info_equal(ref.info, got.info)
        assert int(got.info.iterations) == 0
    assert int(got.info.status) == tc.SolveStatus.BREAKDOWN_NONFINITE


def test_lsmr_deflated_window_matches_reference():
    """One deflated solve with a recording window: x, counts and the
    recorded (v, N̂v) rows against the reference's."""
    mats, bs = _ill_conditioned_sequence(num=1)
    A, b = mats[0], bs[0]
    W = np.linalg.qr(np.random.default_rng(5).standard_normal((60, 4)))[0].T
    NW = W @ (A.T @ A) + 0.1 * W
    kw = dict(damp=0.1, ell=8, tol=1e-10, maxiter=400)
    ref = jc.lsmr(jc.DenseMatrixOperator(jnp.asarray(A)), jnp.asarray(b), None,
                  jnp.asarray(W), jnp.asarray(NW), flat_recycle=True, **kw)
    got = tc.lsmr(tc.DenseMatrixOperator(_t(A)), _t(b), None, _t(W), _t(NW), **kw)
    _assert_info_equal(ref.info, got.info)
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)
    assert int(got.recycle.stored) == int(ref.recycle.stored) == 8
    np.testing.assert_allclose(_np(got.recycle.P), np.asarray(ref.recycle.P), atol=1e-10)
    np.testing.assert_allclose(_np(got.recycle.AP), np.asarray(ref.recycle.AP), atol=1e-10)
    # The extraction over [W; V] gives the reference's next basis from the
    # reference's own window.
    wr, nwr, thr, _ = jax.jit(jextract, static_argnums=(5,))(
        jnp.asarray(W), jnp.asarray(NW), ref.recycle.P, ref.recycle.AP, ref.recycle.stored, 4)
    wt, nwt, tht, _ = extract_next_basis_core(
        _t(W), _t(NW), _t(ref.recycle.P), _t(ref.recycle.AP),
        torch.as_tensor(int(ref.recycle.stored)), 4)
    _assert_basis_close(wr, nwr, wt, nwt)
    np.testing.assert_allclose(_np(tht), np.asarray(thr), rtol=1e-10)


# ---------------------------------------------------------------------------
# Recycled sequences
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sequence8():
    return _ill_conditioned_sequence(num=8)


def test_solve_sequence_lsmr_matches_reference(sequence8):
    """``tests/test_lsmr.py``'s recycled-LSMR case (k = 8, ℓ = 40, λ = 1e-4,
    tol 1e-8) in both packages, held to what rounding does not move (P5)."""
    mats, bs = sequence8
    kw = dict(k=8, ell=40, damp=1e-4, tol=1e-8, maxiter=400, refresh_aw="exact")
    ref = jc.solve_sequence_lsmr(jnp.asarray(mats), jnp.asarray(bs),
                                 make_operator=jc.DenseMatrixOperator, **kw)
    got = tc.solve_sequence_lsmr(_t(mats), _t(bs), make_operator=tc.DenseMatrixOperator, **kw)
    assert bool(np.all(_np(got.info.converged)))
    # Per system within 8 and in total within 3 %: the widest gaps that
    # tools/lsmr_rounding_witness.py shows on this sequence (reference
    # 117 73 77 94 78 93 92 95, port 118 73 78 91 75 91 84 91; P5).
    _assert_counts_close(ref.info, got.info, 8)
    its = _np(got.info.iterations)
    assert abs(int(its.sum()) - int(np.asarray(ref.info.iterations).sum())) <= 0.03 * its.sum()
    # The reference test's claims: each x solves its ridge problem, and
    # recycling spends fewer A/Aᵀ products than cold LSMR.
    for i in (0, len(mats) - 1):
        A, b = mats[i], bs[i]
        x_ref = np.linalg.solve(A.T @ A + 1e-4 * np.eye(A.shape[1]), A.T @ b)
        assert np.linalg.norm(_np(got.x[i]) - x_ref) / np.linalg.norm(x_ref) < 1e-5
        assert np.linalg.norm(_np(got.x[i]) - np.asarray(ref.x[i])) / np.linalg.norm(x_ref) < 1e-5
    cold = [tc.lsmr(tc.DenseMatrixOperator(_t(a)), _t(r), damp=1e-4, tol=1e-8, maxiter=400)
            for a, r in zip(mats, bs)]
    assert all(bool(c.info.converged) for c in cold)
    assert int(_np(got.info.matvecs).sum()) < sum(int(c.info.matvecs) for c in cold)
    assert int(its.sum()) < sum(int(c.info.iterations) for c in cold)


def test_solve_sequence_lsmr_short_window_bases(sequence8):
    """With the window inside the rows both packages record alike (ℓ = 8),
    the carried basis and its normal products agree over all eight
    systems up to the sign of each row."""
    mats, bs = sequence8
    kw = dict(k=8, ell=8, damp=1e-4, tol=1e-8, maxiter=400, refresh_aw="exact")
    ref = jc.solve_sequence_lsmr(jnp.asarray(mats), jnp.asarray(bs),
                                 make_operator=jc.DenseMatrixOperator, **kw)
    got = tc.solve_sequence_lsmr(_t(mats), _t(bs), make_operator=tc.DenseMatrixOperator, **kw)
    _assert_counts_close(ref.info, got.info, 3)
    _assert_basis_close(ref.W, ref.AW, got.W, got.AW)
    np.testing.assert_allclose(_np(got.theta), np.asarray(ref.theta), rtol=1e-9)
    xr = np.asarray(ref.x)
    assert np.max(np.linalg.norm(_np(got.x) - xr, axis=1) / np.linalg.norm(xr, axis=1)) < 1e-6


def test_solve_sequence_lsmr_exact_parity():
    """Where each solve takes a dozen iterations (λ = 0.1) the packages
    agree exactly: counts equal, x 1e-10, Ritz values 1e-8."""
    mats, bs = _ill_conditioned_sequence(num=6)
    kw = dict(k=8, ell=40, damp=0.1, tol=1e-8, maxiter=400, refresh_aw="exact")
    ref = jc.solve_sequence_lsmr(jnp.asarray(mats), jnp.asarray(bs),
                                 make_operator=jc.DenseMatrixOperator, **kw)
    got = tc.solve_sequence_lsmr(_t(mats), _t(bs), make_operator=tc.DenseMatrixOperator, **kw)
    _assert_info_equal(ref.info, got.info)
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)
    np.testing.assert_allclose(_np(got.theta), np.asarray(ref.theta), rtol=1e-8)
    stale = tc.solve_sequence_lsmr(_t(mats), _t(bs), make_operator=tc.DenseMatrixOperator,
                                   **{**kw, "refresh_aw": "stale"})
    ref_stale = jc.solve_sequence_lsmr(jnp.asarray(mats), jnp.asarray(bs),
                                       make_operator=jc.DenseMatrixOperator,
                                       **{**kw, "refresh_aw": "stale"})
    # Stale mode deflates with the recombined products of the recorded
    # window, whose rows near convergence carry each package's rounding:
    # the counts match, and x agrees to the rounding those products carry.
    _assert_info_equal(ref_stale.info, stale.info)
    xr = np.asarray(ref_stale.x)
    assert np.max(np.linalg.norm(_np(stale.x) - xr, axis=1) / np.linalg.norm(xr, axis=1)) < 1e-4


def test_deflsmr_front_door_threaded_by_hand(sequence8):
    """``solve(method="deflsmr")`` system by system, the state fed back
    in, against the reference's front door and the port's own sequence."""
    mats, bs = sequence8
    spec = dict(method="deflsmr", k=8, ell=8, tol=1e-8, maxiter=400, lsq_shift=1e-4)
    jspec, tspec = jc.SolveSpec(**spec), tc.SolveSpec(**spec)
    jstate = tstate = None
    for A, b in zip(mats[:4], bs[:4]):
        ref = jc.solve(jc.DenseMatrixOperator(jnp.asarray(A)), jnp.asarray(b), jspec, jstate)
        got = tc.solve(tc.DenseMatrixOperator(_t(A)), _t(b), tspec, tstate)
        # The first solve is cold LSMR: within 6, the witness's widest
        # cold gap between the packages (P5).
        _assert_counts_close(ref.info, got.info, 6)
        xr = np.asarray(ref.x)
        assert np.linalg.norm(_np(got.x) - xr) / np.linalg.norm(xr) < 1e-6
        jstate, tstate = ref.state, got.state
    _assert_basis_close(jstate.W, jstate.AW, tstate.W, tstate.AW)
    assert int(tstate.systems_solved) == 4
    seq = tc.solve_sequence(_t(mats[:4]), _t(bs[:4]), tspec, make_operator=tc.DenseMatrixOperator)
    assert torch.equal(seq.x[-1], got.x)
    assert torch.equal(seq.state.W, tstate.W) and torch.equal(seq.state.AW, tstate.AW)


def _bench_totals():
    """The reference's acceptance numbers for ``benchmarks/lsq_bench.py``
    (cold and recycled A/Aᵀ products), as ``BENCH_solvers.json`` holds them."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "BENCH_solvers.json")
    with open(path) as fh:
        blob = json.load(fh)
    section = next(v["lsq"] for v in blob.values() if isinstance(v, dict) and "lsq" in v)
    return section


def _drifting_lsq(num, m, n, decay, drift, seed=0):
    """``benchmarks/lsq_bench.py``'s drifting ridge sequence, as numpy."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, m)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.logspace(0, -3, n) if decay == "logspace" else np.abs(rng.standard_normal(n)) + 0.5
    base = U[:, :n] @ np.diag(s) @ V.T
    mats, bs = [], []
    for _ in range(num):
        mats.append(base)
        bs.append(rng.standard_normal(m))
        base = base + drift * np.linalg.norm(base) / np.sqrt(m * n) * rng.standard_normal((m, n))
    return np.stack(mats), np.stack(bs)


@pytest.fixture
def one_thread():
    """torch on one CPU thread for the test: its small products and
    eigensolves gain nothing from a thread pool, and beside the suite's
    other workers a pool of all cores waits on every parallel region (this
    test took 20x longer so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("decay", ["logspace", "flat"])
def test_lsq_bench_acceptance(decay, one_thread):
    """ROADMAP's recycled-LSMR acceptance: lsq_bench's problem (m = 180, n = 120,
    12 systems, λ = 1e-4, tol 1e-8, deflsmr(8, 48)) against the reference's
    cold and recycled A/Aᵀ products.  The flat spectrum takes ~45
    iterations a system and must match within one iteration (two products)
    per system; the logspace one takes ~240 and is held within 5 % (P5),
    with recycling saving at least 10 % of the products."""
    num, k, ell = 12, 8, 48
    mats, bs = _drifting_lsq(num, 180, 120, decay, 0.02)
    totals = _bench_totals()
    cold = sum(int(tc.lsmr(tc.DenseMatrixOperator(_t(a)), _t(r), damp=1e-4, tol=1e-8,
                           maxiter=600).info.matvecs) for a, r in zip(mats, bs))
    seq = tc.solve_sequence_lsmr(_t(mats), _t(bs), k=k, ell=ell, damp=1e-4,
                                 make_operator=tc.DenseMatrixOperator, tol=1e-8,
                                 maxiter=600, refresh_aw="exact")
    assert bool(_np(seq.info.converged).all())
    recycled = int(_np(seq.info.matvecs).sum())
    want_cold = totals[f"lsq/{decay}_cold_matvecs"]
    want_rec = totals[f"lsq/{decay}_recycled_matvecs"]
    slack = 2 * num if decay == "flat" else 0.05
    for got, want in ((cold, want_cold), (recycled, want_rec)):
        bound = slack if isinstance(slack, int) else slack * want
        assert abs(got - want) <= bound, (decay, cold, recycled, want_cold, want_rec)
    if decay == "logspace":
        assert recycled < 0.9 * cold


# ---------------------------------------------------------------------------
# Front doors
# ---------------------------------------------------------------------------

LAM = 0.2


def _spec(lib, method="deflsmr", **kw):
    base = dict(method=method, k=4, ell=12, tol=1e-10, maxiter=300, lsq_shift=LAM)
    base.update(kw)
    return lib.SolveSpec(**base)


def test_solve_lsmr_front_door():
    A, b = _rect(60, 40, seed=41)
    ref = jc.solve(jc.DenseMatrixOperator(jnp.asarray(A)), jnp.asarray(b), _spec(jc, "lsmr"))
    got = tc.solve(tc.DenseMatrixOperator(_t(A)), _t(b), _spec(tc, "lsmr"))
    _assert_info_equal(ref.info, got.info)
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)
    x_ref = np.linalg.solve(A.T @ A + LAM * np.eye(40), A.T @ b)
    assert np.linalg.norm(_np(got.x) - x_ref) / np.linalg.norm(x_ref) < 1e-7
    assert int(got.report.matvecs) == int(got.info.matvecs)


def test_deflsmr_state_carries_over_from_reference():
    """A reference deflsmr state (W, NW in the AW slot) continues in the
    port through ``convert`` and gives the reference's warm solve; the
    port's state goes back the same way."""
    A, b = _rect(60, 40, seed=42)
    jA, tA = jc.DenseMatrixOperator(jnp.asarray(A)), tc.DenseMatrixOperator(_t(A))
    cold = jc.solve(jA, jnp.asarray(b), _spec(jc))
    assert cold.state.W.shape == (4, 40)
    warm_ref = jc.solve(jA, jnp.asarray(b), _spec(jc), cold.state)
    state = convert.recycle_state_from_numpy(
        cold.state.W, cold.state.AW, cold.state.theta, cold.state.systems_solved,
        cold.state.drift, dtype=torch.float64, device="cpu")
    warm = tc.solve(tA, _t(b), _spec(tc), state)
    _assert_info_equal(warm_ref.info, warm.info)
    assert int(warm.info.iterations) <= int(cold.info.iterations)
    np.testing.assert_allclose(_np(warm.x), np.asarray(warm_ref.x), atol=1e-10)
    back = convert.recycle_state_to_numpy(warm.state)
    _assert_basis_close(warm_ref.state.W, warm_ref.state.AW, back["W"], back["AW"])
    np.testing.assert_allclose(back["theta"], np.asarray(warm_ref.state.theta), rtol=1e-10)
    assert int(back["systems_solved"]) == 2


def test_solve_sequence_deflsmr_two_legs():
    mats, bs = _ill_conditioned_sequence(num=4, m=45, n=30)
    spec = _spec(tc, lsq_shift=1e-3)
    seq = tc.solve_sequence(_t(mats), _t(bs), spec, make_operator=tc.DenseMatrixOperator)
    ref = jc.solve_sequence(jnp.asarray(mats), jnp.asarray(bs), _spec(jc, lsq_shift=1e-3),
                            make_operator=jc.DenseMatrixOperator)
    _assert_counts_close(ref.info, seq.info, 1)
    assert bool(_np(seq.info.converged).all())
    assert tuple(seq.state.W.shape) == (4, 30)
    assert int(seq.state.systems_solved) == 4
    seq2 = tc.solve_sequence([_t(a) for a in mats], list(_t(bs)), spec, seq.state,
                             make_operator=tc.DenseMatrixOperator)
    assert int(_np(seq2.info.iterations).sum()) <= int(_np(seq.info.iterations).sum())
    assert int(seq2.state.systems_solved) == 8


def test_spec_validation_and_refusals():
    with pytest.raises(ValueError):
        tc.SolveSpec(method="deflsmr", k=0)
    with pytest.raises(ValueError):
        tc.SolveSpec(method="lsmr", lsq_shift=-1.0)
    with pytest.raises(ValueError):
        tc.SolveSpec(method="cg", lsq_shift=0.5)
    with pytest.raises(ValueError):
        tc.SolveSpec(method="lsmr", precond="jacobi")
    with pytest.raises(ValueError):
        tc.SolveSpec(method="gmres")
    A, b = _rect(30, 20, seed=44)
    with pytest.raises(ValueError, match="preconditioner"):
        tc.solve(tc.DenseMatrixOperator(_t(A)), _t(b), _spec(tc, "lsmr"), M=lambda r: r)
    with pytest.raises(ValueError, match="method"):
        tc.solve_sequence(_t(A)[None], _t(b)[None], _spec(tc, "lsmr"))
    # A bare closure does not know its domain: deflsmr needs x0 or a state.
    op = tc.LinearOperator(matvec=lambda v: _t(A) @ v, rmatvec=lambda u: _t(A).T @ u)
    with pytest.raises(ValueError, match="domain"):
        tc.solve(op, _t(b), _spec(tc))
    res = tc.solve(op, _t(b), _spec(tc), x0=torch.zeros(20, dtype=torch.float64))
    assert bool(res.info.converged)


def test_state_passes_through_plain_lsmr():
    A, b = _rect(30, 20, seed=45)
    state = tc.RecycleState.zeros(4, 20, dtype=torch.float64, device="cpu")
    res = tc.solve(tc.DenseMatrixOperator(_t(A)), _t(b), _spec(tc, "lsmr"), state)
    assert res.state is state
