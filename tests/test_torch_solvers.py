"""Solver layers of the PyTorch port against the live JAX reference.

The same numpy inputs go through ``repro`` (x64 on, ``tests/conftest.py``)
and ``repro_torch`` on the CPU.  Tolerances are the reference's own:
f64 iterates 1e-10, iteration and matvec counts equal, recycled bases
equal up to the sign of each row (eigenvector signs are not unique),
Ritz values 1e-10.

The fig2 Newton trace is compared at ``tol`` 1e-8 and 1e-11.  Between
those, at the 1e-9 its golden pins use, the trace is rounding-sensitive:
past ~10 iterations a last-digit difference in a dot product grows by
orders of magnitude per iteration, so the first system stops one
iteration apart.  See ROADMAP queue 3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro.core.recycle import random_orthonormal_basis  # noqa: E402
from repro.gp import RBFKernel  # noqa: E402
from repro_torch import convert  # noqa: E402
from tests.conftest import make_spd  # noqa: E402

N, K, ELL, NUM_SYSTEMS = 96, 4, 8, 4


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _sign_aligned(ref, got):
    ref, got = _np(ref), _np(got)
    sign = np.where(np.sum(ref * got, axis=1) < 0, -1.0, 1.0)[:, None]
    return sign * got, sign


@pytest.fixture(scope="module")
def fig2_trace():
    """The miniature fig2 GP Newton trace of tests/test_trajectory_pin.py."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, 4))
    kmat = np.asarray(RBFKernel(theta=2.0, lengthscale=1.5).gram(jnp.asarray(x)))
    f = rng.standard_normal(N) * 0.3
    y = np.sign(rng.standard_normal(N))
    sqrt_hs, bs = [], []
    for _ in range(NUM_SYSTEMS):
        pi = 1.0 / (1.0 + np.exp(-f))
        sh = np.sqrt(pi * (1.0 - pi))
        sqrt_hs.append(sh)
        bs.append(sh * (y - pi) + 0.1 * f)
        f = f + 0.35 * rng.standard_normal(N)
    return kmat, np.stack(sqrt_hs), np.stack(bs)


def _ops(kmat):
    kj, kt = jnp.asarray(kmat), _t(kmat)
    return (
        lambda sh: jc.KernelSystemOperator(lambda v: kj @ v, jnp.asarray(sh)),
        lambda sh: tc.KernelSystemOperator(lambda v: kt @ v, _t(sh)),
    )


def _assert_info_equal(ji, ti):
    for field in ("iterations", "matvecs", "status", "converged"):
        np.testing.assert_array_equal(
            _np(getattr(ti, field)), np.asarray(getattr(ji, field)), err_msg=field
        )


def _assert_state_close(jstate_w, jstate_aw, tw, taw, atol=1e-10):
    w_al, sign = _sign_aligned(jstate_w, tw)
    np.testing.assert_allclose(w_al, np.asarray(jstate_w), atol=atol)
    np.testing.assert_allclose(sign * _np(taw), np.asarray(jstate_aw), atol=atol)


# ---------------------------------------------------------------------------
# cg / defcg
# ---------------------------------------------------------------------------


def test_cg_matches_reference():
    rng = np.random.default_rng(0)
    A, _, _ = make_spd(64, 10.0, rng)
    b = rng.standard_normal(64)
    x0 = rng.standard_normal(64)
    ref = jc.cg(jc.from_matrix(jnp.asarray(A)), jnp.asarray(b), jnp.asarray(x0),
                tol=1e-10, maxiter=500, record_residuals=True)
    got = tc.cg(tc.from_matrix(_t(A)), _t(b), _t(x0), tol=1e-10, maxiter=500,
                record_residuals=True)
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)
    _assert_info_equal(ref.info, got.info)
    np.testing.assert_allclose(
        _np(got.info.residual_norms), np.asarray(ref.info.residual_norms),
        rtol=1e-6, equal_nan=True,
    )


@pytest.mark.parametrize("exact_aw", [True, False], ids=["exact", "stale-guard"])
def test_defcg_matches_reference(exact_aw):
    rng = np.random.default_rng(1)
    n, k = 80, 5
    A, _, _ = make_spd(n, 1e3, rng)
    b = rng.standard_normal(n)
    W = np.linalg.qr(rng.standard_normal((n, k)))[0].T
    AW = W @ A if exact_aw else W @ (A + 1e-3 * np.eye(n))
    kw = dict(ell=6, tol=1e-10, maxiter=800, exact_aw=exact_aw,
              stale_guard=None if exact_aw else 1e-6)
    ref = jc.defcg(jc.from_matrix(jnp.asarray(A)), jnp.asarray(b), None,
                   jnp.asarray(W), jnp.asarray(AW), flat_recycle=True, **kw)
    got = tc.defcg(tc.from_matrix(_t(A)), _t(b), None, _t(W), _t(AW), **kw)
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)
    _assert_info_equal(ref.info, got.info)
    assert bool(got.info.guard_fired) == bool(ref.info.guard_fired)
    for field in ("P", "AP", "alpha", "beta"):
        np.testing.assert_allclose(
            _np(getattr(got.recycle, field)),
            np.asarray(getattr(ref.recycle, field)), atol=1e-10, err_msg=field,
        )
    assert int(got.recycle.stored) == int(ref.recycle.stored)


def test_defcg_recording_window_past_convergence():
    """A solve that converges inside the window leaves rows past
    ``stored`` zero, as the reference's masked scan does."""
    A = np.diag(np.array([1.0, 2.0, 3.0, 4.0]))
    b = np.ones(4)
    ref = jc.defcg(jc.from_matrix(jnp.asarray(A)), jnp.asarray(b), ell=8,
                   tol=1e-12, flat_recycle=True)
    got = tc.defcg(tc.from_matrix(_t(A)), _t(b), ell=8, tol=1e-12)
    assert int(got.recycle.stored) == int(ref.recycle.stored) == 4
    np.testing.assert_allclose(_np(got.recycle.P), np.asarray(ref.recycle.P), atol=1e-12)
    assert float(got.recycle.P[4:].abs().sum()) == 0.0
    _assert_info_equal(ref.info, got.info)


@pytest.mark.parametrize("seed", [1, 2])
def test_defcg_r1_case_against_dense_solve(seed):
    """ROADMAP R1: the case on which the reference diverges at its default
    jitter.  Without jitter the port solves it; the solution is held
    against a dense solve."""
    n, k = 12, 1
    rng = np.random.default_rng(seed)
    A, _, _ = make_spd(n, 1e4, rng)
    b = rng.standard_normal(n)
    W = np.asarray(random_orthonormal_basis(jax.random.PRNGKey(seed % 97), jnp.zeros(n), k))
    got = tc.defcg(tc.from_matrix(_t(A)), _t(b), W=_t(W), tol=1e-10,
                   maxiter=20 * n, waw_jitter=0.0)
    assert bool(got.info.converged)
    np.testing.assert_allclose(_np(got.x), np.linalg.solve(A, b), rtol=1e-6)


def test_harmonic_ritz_flat_matches_reference():
    rng = np.random.default_rng(3)
    n, m, k = 120, 14, 6
    A, _, _ = make_spd(n, 1e3, rng)
    Z = rng.standard_normal((m, n))
    valid = np.arange(m) < 11
    ref = jc.harmonic_ritz_flat(jnp.asarray(Z), jnp.asarray(Z @ A), k,
                                valid=jnp.asarray(valid))
    got = tc.harmonic_ritz_flat(_t(Z), _t(Z @ A), k, valid=torch.as_tensor(valid))
    _assert_state_close(ref[0], ref[1], got[0], got[1])
    np.testing.assert_allclose(_np(got[2]), np.asarray(ref[2]), rtol=1e-10)


# ---------------------------------------------------------------------------
# The fig2 Newton trace through the three sequence paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tol", [1e-8, 1e-11])
def test_fig2_solve_sequence_matches_reference(fig2_trace, tol):
    kmat, sqrt_hs, bs = fig2_trace
    j_op, t_op = _ops(kmat)
    spec = dict(method="defcg", k=K, ell=ELL, tol=tol, maxiter=600)
    ref = jc.solve_sequence(jnp.asarray(sqrt_hs), jnp.asarray(bs),
                            jc.SolveSpec(**spec), make_operator=j_op)
    got = tc.solve_sequence(_t(sqrt_hs), _t(bs), tc.SolveSpec(**spec),
                            make_operator=t_op)
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)
    _assert_info_equal(ref.info, got.info)
    np.testing.assert_allclose(_np(got.theta), np.asarray(ref.theta), atol=1e-10)
    np.testing.assert_array_equal(_np(got.report.rung), np.asarray(ref.report.rung))
    _assert_state_close(ref.state.W, ref.state.AW, got.state.W, got.state.AW)
    assert int(got.state.systems_solved) == NUM_SYSTEMS


def test_fig2_solve_front_door_matches_reference(fig2_trace):
    kmat, sqrt_hs, bs = fig2_trace
    j_op, t_op = _ops(kmat)
    spec = dict(method="defcg", k=K, ell=ELL, tol=1e-11, maxiter=600)
    jstate = tstate = None
    jx = tx = None
    for sh, b in zip(sqrt_hs, bs):
        ref = jc.solve(j_op(sh), jnp.asarray(b), jc.SolveSpec(**spec), jstate, x0=jx)
        got = tc.solve(t_op(sh), _t(b), tc.SolveSpec(**spec), tstate, x0=tx)
        np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)
        _assert_info_equal(ref.info, got.info)
        np.testing.assert_allclose(_np(got.state.theta), np.asarray(ref.state.theta), atol=1e-10)
        _assert_state_close(ref.state.W, ref.state.AW, got.state.W, got.state.AW)
        assert int(got.report.rung) == 0
        jstate, tstate, jx, tx = ref.state, got.state, ref.x, got.x


def test_fig2_recycle_manager_matches_reference(fig2_trace):
    kmat, sqrt_hs, bs = fig2_trace
    j_op, t_op = _ops(kmat)
    jm = jc.RecycleManager(k=K, ell=ELL, tol=1e-11, maxiter=600)
    tm = tc.RecycleManager(k=K, ell=ELL, tol=1e-11, maxiter=600)
    for sh, b in zip(sqrt_hs, bs):
        ref = jm.solve(j_op(sh), jnp.asarray(b))
        got = tm.solve(t_op(sh), _t(b))
        np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)
        _assert_info_equal(ref.info, got.info)
        np.testing.assert_allclose(_np(tm.theta), np.asarray(jm.theta), atol=1e-10)
        _assert_state_close(jm.W, jm.AW, tm.W, tm.AW)


def test_state_carries_over_from_reference(fig2_trace):
    """Two systems in ``repro``, the state carried over through
    ``repro_torch.convert``, two more in ``repro_torch``: the same numbers
    as ``repro`` running all four."""
    kmat, sqrt_hs, bs = fig2_trace
    j_op, t_op = _ops(kmat)
    jspec = jc.SolveSpec(method="defcg", k=K, ell=ELL, tol=1e-11, maxiter=600)
    fields = dataclasses.asdict(jspec)
    fields.pop("strategy")
    tspec = convert.spec_from_fields(fields)
    assert dataclasses.asdict(tspec).keys() == dataclasses.asdict(jspec).keys()

    full = jc.solve_sequence(jnp.asarray(sqrt_hs), jnp.asarray(bs), jspec,
                             make_operator=j_op)
    head = jc.solve_sequence(jnp.asarray(sqrt_hs[:2]), jnp.asarray(bs[:2]),
                             jspec, make_operator=j_op)
    s = head.state
    state = convert.recycle_state_from_numpy(
        s.W, s.AW, s.theta, s.systems_solved, s.drift,
        dtype=torch.float64, device="cpu",
    )
    tail = tc.solve_sequence(_t(sqrt_hs[2:]), _t(bs[2:]), tspec, state,
                             make_operator=t_op)
    np.testing.assert_allclose(_np(tail.x), np.asarray(full.x[2:]), atol=1e-10)
    np.testing.assert_array_equal(_np(tail.info.iterations),
                                  np.asarray(full.info.iterations[2:]))
    np.testing.assert_array_equal(_np(tail.info.matvecs),
                                  np.asarray(full.info.matvecs[2:]))
    back = convert.recycle_state_to_numpy(tail.state)
    np.testing.assert_allclose(back["theta"], np.asarray(full.state.theta), atol=1e-10)
    _assert_state_close(full.state.W, full.state.AW, back["W"], back["AW"])
    assert int(back["systems_solved"]) == NUM_SYSTEMS


# ---------------------------------------------------------------------------
# What this slice leaves out raises; the recovery ladder
# ---------------------------------------------------------------------------


def test_unported_paths_raise():
    A = tc.from_matrix(torch.eye(6, dtype=torch.float64))
    b = torch.ones(6, dtype=torch.float64)
    # MGeometryHarmonic is ported, and so are the batched least-squares
    # doors (two tenants of the identity: x = b in one iteration).
    res = tc.solve(A, b, tc.SolveSpec(precond="jacobi", strategy=tc.MGeometryHarmonic()),
                   M=lambda v: v)
    assert bool(res.info.converged)
    tenants = tc.from_matrix(torch.eye(6, dtype=torch.float64).repeat(2, 1, 1))
    bs = torch.ones(2, 6, dtype=torch.float64)
    for method in ("lsmr", "deflsmr"):
        out = tc.solve_batch(tenants, bs, tc.SolveSpec(method=method))
        assert out.info.converged.all() and torch.allclose(out.x, bs), method
    # mesh= runs the sharded engine now; what is not a solve mesh is refused.
    with pytest.raises(ValueError, match="SolveMesh"):
        tc.solve(A, b, tc.SolveSpec(), mesh=object())
    with pytest.raises(ValueError, match="method"):
        tc.SolveSpec(method="gmres")


def _indefinite_case(pkg, conv):
    """A basis carried from ``2I`` into an indefinite 48 × 48 system: def-CG
    breaks down (pᵀAp ≤ 0), and the ladder climbs to its third rung."""
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((48, 48)))
    eigs = np.concatenate([np.linspace(0.5, 4.0, 44), [-1.0, -0.2, 2.0, 9.0]])
    mat = conv((q * eigs) @ q.T)
    b = conv(rng.standard_normal(48))
    spec = pkg.SolveSpec(method="defcg", k=3, ell=6, tol=1e-8, maxiter=300)
    warm = pkg.solve(pkg.from_matrix(conv(2.0 * np.eye(48))), b, spec)
    return pkg.solve(pkg.from_matrix(mat), b, spec, warm.state)


def test_ladder_indefinite_case_matches_reference():
    """The case the port used to refuse: the same rung (3), status
    (BREAKDOWN_INDEFINITE), matvecs and iterations as the reference, x to
    1e-10, and the basis retired (zeroed)."""
    ref = _indefinite_case(jc, jnp.asarray)
    got = _indefinite_case(tc, _t)
    assert int(got.report.rung) == int(ref.report.rung) == 3
    assert int(got.report.status) == int(ref.report.status) == tc.SolveStatus.BREAKDOWN_INDEFINITE
    _assert_info_equal(ref.info, got.info)
    np.testing.assert_array_equal(_np(got.report.matvecs), np.asarray(ref.report.matvecs))
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)
    assert not torch.any(got.state.W != 0) and not torch.any(got.state.AW != 0)


# ROADMAP P9: the fig2 trace with a stale refresh, and with the smallest
# harmonic Ritz values kept, climbs the ladder in the reference.  At tol
# 1e-10 the stale case's fourth system is rounding-sensitive (P1): its
# rung-1 re-solve ends in the reference at 0.907 of the threshold after 19
# iterations, and here one iteration later; every other count is equal.
P9_CASES = {
    "stale-1e-8": (dict(refresh_aw="stale", tol=1e-8), [0, 1, 1, 1], 0),
    "stale-1e-10": (dict(refresh_aw="stale", tol=1e-10), [0, 1, 1, 1], 1),
    "stale-1e-11": (dict(refresh_aw="stale", tol=1e-11), [0, 1, 1, 1], 0),
    "smallest-1e-12": (dict(select="smallest", tol=1e-12), [0, 2, 2, 2], 0),
}


@pytest.mark.parametrize("case", list(P9_CASES))
def test_p9_ladder_sequence_matches_reference(fig2_trace, case):
    kw, rungs, slack = P9_CASES[case]
    kmat, sqrt_hs, bs = fig2_trace
    j_op, t_op = _ops(kmat)
    ref = jc.solve_sequence(jnp.asarray(sqrt_hs), jnp.asarray(bs),
                            jc.SolveSpec(k=K, ell=ELL, maxiter=600, **kw), make_operator=j_op)
    got = tc.solve_sequence(_t(sqrt_hs), _t(bs), tc.SolveSpec(k=K, ell=ELL, maxiter=600, **kw),
                            make_operator=t_op)
    np.testing.assert_array_equal(np.asarray(ref.report.rung), rungs)
    np.testing.assert_array_equal(_np(got.report.rung), rungs)
    it_ref, it_got = np.asarray(ref.info.iterations), _np(got.info.iterations)
    assert np.all(np.abs(it_got - it_ref) <= slack), (it_got, it_ref)
    # Every attempt's products charged as the reference charges them: the
    # only difference is the iterations P1 moved.
    np.testing.assert_array_equal(_np(got.info.matvecs) - np.asarray(ref.info.matvecs),
                                  it_got - it_ref)
    np.testing.assert_array_equal(_np(got.report.status), np.asarray(ref.report.status))
    assert bool(torch.all(got.info.converged))
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)


@pytest.mark.parametrize("with_aw", [False, True], ids=["W", "W+AW"])
def test_seeded_recycle_manager_matches_reference(fig2_trace, with_aw):
    """``RecycleManager.seed`` with an a-priori basis (and optionally its
    products): the next solves match the reference's seeded manager."""
    kmat, sqrt_hs, bs = fig2_trace
    j_op, t_op = _ops(kmat)
    W = np.linalg.qr(np.random.default_rng(11).standard_normal((N, 3)))[0].T
    AW = np.stack([_np(t_op(sqrt_hs[0])(_t(w))) for w in W]) if with_aw else None
    jm = jc.RecycleManager(k=K, ell=ELL, tol=1e-11, maxiter=600)
    tm = tc.RecycleManager(k=K, ell=ELL, tol=1e-11, maxiter=600)
    jm.seed(jnp.asarray(W), None if AW is None else jnp.asarray(AW))
    tm.seed(_t(W), None if AW is None else _t(AW))
    for sh, b in zip(sqrt_hs[:2], bs[:2]):
        ref = jm.solve(j_op(sh), jnp.asarray(b))
        got = tm.solve(t_op(sh), _t(b))
        np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)
        _assert_info_equal(ref.info, got.info)
        _assert_state_close(jm.W, jm.AW, tm.W, tm.AW)
    with pytest.raises(ValueError, match="between 1 and"):
        tm.seed(_t(np.zeros((K + 1, N))))
