"""The port's recycle strategies against the live JAX reference.

Mirrors ``tests/test_strategies.py`` where it reaches
``WindowedRecombine`` and ``MGeometryHarmonic`` (the accounting and drift
guard on a genuine GP Newton sequence, the M-geometry extraction against
a dense M^½-similarity reference, the spec checks, the warm batch parity),
and runs ``benchmarks/seq_bench.py``'s strategy matrix (six drifting
Newton systems, k = 8, ℓ = 12, tol 1e-5; harmonic, windowed, M-geometry
with Jacobi) at n = 1200 in both packages on the same numpy data: per
system the matvec accounting (matvecs − iterations) exactly and the
iterations within ±1 (ROADMAP P1: counts near the tolerance move with
summation order).  f64 throughout.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax.config.update("jax_enable_x64", True)

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro.data import make_infinite_digits  # noqa: E402
from repro_torch.core.strategies import extract_next_basis_core  # noqa: E402
from tests.conftest import make_spd  # noqa: E402


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def _newton_sequence(n, num=6, theta=3.0, lengthscale=3.0):
    """A genuine GP Newton sequence in numpy: per-iteration ``(H½, b)``
    from Newton's method on the Laplace mode (exact inner solves), and
    the dense RBF kernel."""
    x, y = make_infinite_digits(n, seed=0, noise=0.1)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    sq = np.sum(x * x, 1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * x @ x.T, 0.0)
    kd = theta**2 * np.exp(-0.5 * d2 / lengthscale**2)
    f = np.zeros(n)
    shs, bs = [], []
    for _ in range(num):
        pi = 1.0 / (1.0 + np.exp(-f))
        grad, hdiag = (y + 1.0) / 2.0 - pi, pi * (1.0 - pi)
        sh = np.sqrt(hdiag)
        bg = hdiag * f + grad
        b = sh * (kd @ bg)
        shs.append(sh)
        bs.append(b)
        xsol = np.linalg.solve(np.eye(n) + sh[:, None] * kd * sh[None, :], b)
        f = kd @ (bg - sh * xsol)
    return kd, np.stack(shs), np.stack(bs)


def _residuals(kd, shs, bs, xs):
    xs = np.asarray(xs)
    return [float(np.linalg.norm(bs[i] - xs[i] - shs[i] * (kd @ (shs[i] * xs[i])))
                  / np.linalg.norm(bs[i])) for i in range(bs.shape[0])]


def _port_sequence(kd, shs, bs, spec, make_prec=None):
    K = _t(kd)
    return tc.solve_sequence(
        _t(shs), _t(bs), spec, make_operator=lambda sh: tc.KernelSystemOperator(
            lambda v: K @ v, sh),
        make_preconditioner=make_prec)


def _ref_sequence(kd, shs, bs, spec, make_prec=None):
    K = jnp.asarray(kd)
    k_mv = lambda v: K @ v  # noqa: E731
    return jc.solve_sequence(jc.KernelSystemOperator(k_mv, jnp.asarray(shs)), jnp.asarray(bs),
                             spec, make_preconditioner=make_prec)


def _counts(seq):
    return np.asarray(seq.info.iterations), np.asarray(seq.info.matvecs)


class TestWindowedRecombine:
    def test_paper_accounting_on_gp_newton_sequence(self):
        """matvecs = iterations + 2 (+k only on guard-bought refreshes),
        iterations within ±1 of HarmonicRitz, and the reference's own
        accounting system by system."""
        kd, shs, bs = _newton_sequence(160)
        k = 8
        base = _port_sequence(kd, shs, bs, tc.SolveSpec(k=k, ell=12, tol=1e-5, maxiter=2000))
        win = _port_sequence(kd, shs, bs, tc.SolveSpec(
            k=k, ell=12, tol=1e-5, maxiter=2000, strategy=tc.WindowedRecombine()))
        it_b, _ = _counts(base)
        it_w, mv_w = _counts(win)
        assert max(_residuals(kd, shs, bs, win.x)) < 1e-4
        assert np.max(np.abs(it_w - it_b)) <= 1, (it_w, it_b)
        assert set(np.unique(mv_w - it_w - 2)).issubset({0, k}), mv_w - it_w - 2
        assert it_w[-1] < it_w[0]
        ref = _ref_sequence(kd, shs, bs, jc.SolveSpec(
            k=k, ell=12, tol=1e-5, maxiter=2000, strategy=jc.WindowedRecombine()))
        it_r, mv_r = _counts(ref)
        np.testing.assert_array_equal(mv_w - it_w, mv_r - it_r)
        assert np.max(np.abs(it_w - it_r)) <= 1, (it_w, it_r)

    def test_zero_refresh_accounting_on_multiple_rhs(self):
        """One operator, many right-hand sides: the guard never fires,
        matvecs = iterations + 2 exactly."""
        kd, shs, bs = _newton_sequence(160)
        num, k = 5, 8
        same = np.stack([shs[-1]] * num)
        rhs = np.random.default_rng(1).standard_normal((num, bs.shape[1]))
        spec = tc.SolveSpec(k=k, ell=12, tol=1e-5, maxiter=2000,
                            strategy=tc.WindowedRecombine())
        it_, mv = _counts(_port_sequence(kd, same, rhs, spec))
        np.testing.assert_array_equal(mv, it_ + 2)
        assert it_[-1] < it_[0]
        _, mv_b = _counts(_port_sequence(kd, same, rhs,
                                         tc.SolveSpec(k=k, ell=12, tol=1e-5, maxiter=2000)))
        assert np.all(mv[1:] <= mv_b[1:] - k + 1)

    def test_guard_zero_reduces_to_exact_refresh(self):
        """guard = 0 refreshes every carried basis once: the exact path's
        iterations, iterations + 2 + k matvecs from system 2 on."""
        kd, shs, bs = _newton_sequence(160)
        it_b, _ = _counts(_port_sequence(kd, shs, bs,
                                         tc.SolveSpec(k=8, ell=12, tol=1e-5, maxiter=2000)))
        it0, mv0 = _counts(_port_sequence(kd, shs, bs, tc.SolveSpec(
            k=8, ell=12, tol=1e-5, maxiter=2000, strategy=tc.WindowedRecombine(guard=0.0))))
        np.testing.assert_array_equal(it0, it_b)
        assert mv0[0] == it0[0] + 2
        np.testing.assert_array_equal(mv0[1:], it0[1:] + 2 + 8)

    def test_state_carries_finite_drift(self):
        kd, shs, bs = _newton_sequence(160)
        seq = _port_sequence(kd, shs, bs, tc.SolveSpec(
            k=8, ell=12, tol=1e-5, maxiter=2000, strategy=tc.WindowedRecombine()))
        assert np.isfinite(float(seq.state.drift))

    def test_single_solve_front_door_accounting(self):
        """solve() carries the state: a second solve on the same operator
        costs iterations + 2, no refresh."""
        rng = np.random.default_rng(2)
        A0, _, _ = make_spd(96, 1e3, rng)
        A = tc.from_matrix(_t(A0))
        spec = tc.SolveSpec(k=6, ell=12, tol=1e-6, maxiter=2000,
                            strategy=tc.WindowedRecombine())
        r1 = tc.solve(A, _t(rng.standard_normal(96)), spec)
        r2 = tc.solve(A, _t(rng.standard_normal(96)), spec, r1.state)
        assert int(r2.info.matvecs) == int(r2.info.iterations) + 2
        assert int(r2.info.iterations) < int(r1.info.iterations)

    def test_manager_mirrors_the_guard(self):
        """RecycleManager's host-side refresh decision is prepare()'s."""
        w = tc.WindowedRecombine(guard=0.1)
        assert not w.manager_wants_refresh("exact", torch.tensor(1e-20, dtype=torch.float64),
                                           1e-5)
        assert w.manager_wants_refresh("exact", torch.tensor(1e-3, dtype=torch.float64), 1e-5)


class TestMGeometryHarmonic:
    def _preconditioned_window(self, n=96, ell=16, seed=4):
        rng = np.random.default_rng(seed)
        A0, _, _ = make_spd(n, 1e4, rng)
        s = np.logspace(0, 1.5, n)
        A = _t(A0 * np.outer(s, s))
        mdiag = torch.diagonal(A).clone()
        b = _t(rng.standard_normal(n))
        res = tc.defcg(tc.from_matrix(A), b, tol=1e-12, maxiter=20 * n, ell=ell,
                       M=tc.jacobi(mdiag))
        return A, mdiag, res.recycle

    def test_matches_dense_m_half_similarity_reference(self):
        """θ and the subspace match plain harmonic Ritz of the similarity
        transform Ã = M^{-1/2} A M^{-1/2} on the transformed window, mapped
        back (the definition of the M-geometry extraction)."""
        k = 5
        A, mdiag, rec = self._preconditioned_window()
        m = int(rec.stored)
        W_g, _, th_g, _ = extract_next_basis_core(
            None, None, rec.P, rec.AP, rec.stored, k, m_apply=lambda v: v / mdiag)
        m_half = torch.sqrt(mdiag)
        W_t, _, th_ref = tc.harmonic_ritz_flat(rec.P[:m] * m_half, rec.AP[:m] / m_half, k)
        np.testing.assert_allclose(th_g.numpy(), th_ref.numpy(), rtol=1e-8)
        W_ref = W_t / m_half
        wr = W_ref / torch.linalg.norm(W_ref, dim=1, keepdim=True)
        for i in range(k):
            assert float(torch.abs(torch.sum(wr[i] * W_g[i]))) > 1.0 - 1e-8, i

    def test_mgeometry_targets_effective_spectrum(self):
        k = 5
        A, mdiag, rec = self._preconditioned_window()
        _, _, th_e, _ = extract_next_basis_core(None, None, rec.P, rec.AP, rec.stored, k)
        _, _, th_g, _ = extract_next_basis_core(None, None, rec.P, rec.AP, rec.stored, k,
                                                m_apply=lambda v: v / mdiag)
        assert float(th_g[0]) < 0.1 * float(th_e[0])
        dm = np.diag(1.0 / np.sqrt(mdiag.numpy()))
        eff = np.linalg.eigvalsh(dm @ A.numpy() @ dm)
        np.testing.assert_allclose(float(th_g[0]), eff[-1], rtol=0.1)

    def test_extraction_matches_the_reference(self):
        """The same window through both packages' M-geometry extraction."""
        k = 5
        A, mdiag, rec = self._preconditioned_window()
        W_t, AW_t, th_t, _ = extract_next_basis_core(
            None, None, rec.P, rec.AP, rec.stored, k, m_apply=lambda v: v / mdiag)
        from repro.core.strategies import extract_next_basis_core as j_extract

        md = jnp.asarray(mdiag.numpy())
        W_j, AW_j, th_j, _ = j_extract(None, None, jnp.asarray(rec.P.numpy()),
                                       jnp.asarray(rec.AP.numpy()), int(rec.stored), k,
                                       m_apply=lambda v: v / md)
        np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), rtol=1e-8)
        dots = np.abs(np.sum(W_t.numpy() * np.asarray(W_j), axis=1))
        np.testing.assert_allclose(dots, 1.0, atol=1e-8)

    def test_spec_requires_preconditioner(self):
        with pytest.raises(ValueError, match="precond"):
            tc.SolveSpec(strategy=tc.MGeometryHarmonic())

    def test_manager_requires_preconditioner(self):
        mgr = tc.RecycleManager(k=4, ell=8, strategy=tc.MGeometryHarmonic())
        with pytest.raises(ValueError, match="pass M"):
            mgr.solve(tc.from_matrix(torch.eye(8, dtype=torch.float64)),
                      torch.ones(8, dtype=torch.float64))

    def test_end_to_end_preconditioned_sequence(self):
        """MGeometryHarmonic + Jacobi: correct solutions, recycling cuts
        iterations, and the reference's accounting system by system."""
        kd, shs, bs = _newton_sequence(160)
        kdiag = np.diag(kd)
        spec_t = tc.SolveSpec(k=8, ell=12, tol=1e-5, maxiter=2000, precond="jacobi",
                              strategy=tc.MGeometryHarmonic())
        kdt = _t(kdiag)
        seq = _port_sequence(kd, shs, bs, spec_t,
                             lambda op: tc.jacobi(1.0 + op.sqrt_h**2 * kdt))
        assert max(_residuals(kd, shs, bs, seq.x)) < 1e-4
        it_, mv = _counts(seq)
        assert it_[-1] < it_[0]
        kdj = jnp.asarray(kdiag)
        ref = _ref_sequence(kd, shs, bs, jc.SolveSpec(
            k=8, ell=12, tol=1e-5, maxiter=2000, precond="jacobi",
            strategy=jc.MGeometryHarmonic()), lambda op: jc.jacobi(1.0 + op.sqrt_h**2 * kdj))
        it_r, mv_r = _counts(ref)
        np.testing.assert_array_equal(mv - it_, mv_r - it_r)
        assert np.max(np.abs(it_ - it_r)) <= 1, (it_, it_r)


class TestSpecValidation:
    def test_stale_refresh_conflicts_with_owned_policy(self):
        with pytest.raises(ValueError, match="stale"):
            tc.SolveSpec(refresh_aw="stale", strategy=tc.WindowedRecombine())

    def test_strategy_must_be_instance(self):
        with pytest.raises(ValueError, match="strategy"):
            tc.SolveSpec(strategy="windowed")

    def test_spec_with_strategy_is_hashable(self):
        s1 = tc.SolveSpec(strategy=tc.WindowedRecombine(guard=0.2))
        s2 = tc.SolveSpec(strategy=tc.WindowedRecombine(guard=0.2))
        assert hash(s1) == hash(s2) and s1 == s2
        assert s1 != tc.SolveSpec(strategy=tc.WindowedRecombine(guard=0.3))

    def test_windowed_needs_a_window(self):
        with pytest.raises(ValueError, match="ell > 0"):
            tc.SolveSpec(ell=0, strategy=tc.WindowedRecombine())

    def test_mgeometry_is_accepted_by_the_front_door(self):
        """The port no longer refuses MGeometryHarmonic."""
        rng = np.random.default_rng(5)
        A0, _, _ = make_spd(40, 1e2, rng)
        A = tc.from_matrix(_t(A0))
        spec = tc.SolveSpec(k=4, ell=8, tol=1e-8, precond="jacobi",
                            strategy=tc.MGeometryHarmonic())
        res = tc.solve(A, _t(rng.standard_normal(40)), spec,
                       M=tc.jacobi(torch.diagonal(A.mat).clone()))
        assert bool(res.info.converged)


class TestBatchEarlyExit:
    def test_warm_batch_parity_with_sequential(self):
        """Warm tenants through solve_batch match their sequential solves."""
        rng = np.random.default_rng(3)
        n, B = 72, 3
        spec = tc.SolveSpec(k=4, ell=10, tol=1e-8, maxiter=2000)
        mats, states, bvecs = [], [], []
        for _ in range(B):
            A0, _, _ = make_spd(n, 1e3, rng)
            A = _t(A0)
            r = tc.solve(tc.from_matrix(A), _t(rng.standard_normal(n)), spec)
            mats.append(A)
            states.append(r.state)
            bvecs.append(_t(rng.standard_normal(n)))
        batched = tc.RecycleState(*(torch.stack([getattr(s, f) for s in states])
                                    for f in ("W", "AW", "theta", "systems_solved", "drift")))
        out = tc.solve_batch(torch.stack(mats), torch.stack(bvecs), spec, batched,
                             make_operator=tc.from_matrix)
        for i in range(B):
            ref = tc.solve(tc.from_matrix(mats[i]), bvecs[i], spec, states[i])
            assert int(out.info.iterations[i]) == int(ref.info.iterations)
            np.testing.assert_allclose(out.x[i].numpy(), ref.x.numpy(), rtol=1e-8, atol=1e-10)


# ---------------------------------------------------------------------------
# seq_bench's strategy matrix at n = 1200, both packages in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["harmonic", "windowed", "mgeometry"])
def test_strategy_matrix_against_reference(name):
    kd, shs, bs = _newton_sequence(1200)
    kdiag = np.diag(kd)
    common = dict(k=8, ell=12, tol=1e-5, maxiter=2000)
    kdt, kdj = _t(kdiag), jnp.asarray(kdiag)
    cases = {
        "harmonic": ({}, None, None),
        "windowed": ({"strategy": "windowed"}, None, None),
        "mgeometry": ({"precond": "jacobi", "strategy": "mgeometry"},
                      lambda op: tc.jacobi(1.0 + op.sqrt_h**2 * kdt),
                      lambda op: jc.jacobi(1.0 + op.sqrt_h**2 * kdj)),
    }
    extra, prec_t, prec_j = cases[name]

    def spec(pkg):
        kw = dict(common)
        if "precond" in extra:
            kw["precond"] = extra["precond"]
        strat = {"windowed": pkg.WindowedRecombine, "mgeometry": pkg.MGeometryHarmonic}.get(
            extra.get("strategy"))
        if strat is not None:
            kw["strategy"] = strat()
        return pkg.SolveSpec(**kw)

    seq_t = _port_sequence(kd, shs, bs, spec(tc), prec_t)
    seq_j = _ref_sequence(kd, shs, bs, spec(jc), prec_j)
    it_t, mv_t = _counts(seq_t)
    it_j, mv_j = _counts(seq_j)
    np.testing.assert_array_equal(mv_t - it_t, mv_j - it_j)
    assert np.max(np.abs(it_t - it_j)) <= 1, (it_t, it_j)
    assert max(_residuals(kd, shs, bs, seq_t.x)) < 1e-4
