"""``solve_batch`` and ``solve_pool_step`` against sequential solves and the
live JAX reference.

Mirrors ``tests/test_api.py``'s ``TestSolveBatch`` on the reference's own
inputs (``make_spd`` tenants, cond 1e2 … 1e4): B = 5 tenants against
sequential port ``solve`` calls, iterations and matvecs equal and x to
1e-12; states fed back; sequences; cg passing the state through;
per-tenant convergence.  On the CPU a lane IS its sequential solve: the
step kernels' plain versions, the lanes' scalar reductions and a dense
tenant's product all run lane by lane in the one-system order
(``operators.over_lanes``, ``operators.LaneDenseOperator``).

Against the reference's ``solve_batch`` the lanes hold its convergence,
status and matvec accounting (matvecs − iterations) exactly, and x to what
both solves' residual tolerance implies, ``‖x − x_ref‖ ≤ 2·tol·‖b‖ /
λ_min``.  Iteration counts are held against the reference only where
rounding leaves them (the pool step, within one): on these spectra CG
runs past n steps and its count moves with rounding, so the port's
ONE-system solve already differs from the reference's (57 / 56 and
137 / 134 on the B = 5 case; up to 6 on the sequences: ROADMAP P1).

Also: ``solve_pool_step``'s idle-slot semantics against the reference's,
the shared-K tenant batch (one ``K`` product of the ``(n, B)`` stack an
iteration), preconditioned tenants (K6's lane arm), the recovery ladder
per lane, the card forms of the lane reductions, and the lane-axis
reduction order of K1 / K6 emulated in torch
(``tests/torch_reduction_order.py``).  f64, n ≤ 96, B ≤ 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax.config.update("jax_enable_x64", True)

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import torch_reduction_order as ro  # noqa: E402
from repro_torch.core import solvers as ts  # noqa: E402
from tests.conftest import make_spd  # noqa: E402

SPEC = dict(k=6, ell=10, tol=1e-8, maxiter=3000)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _tenants(B=5, n=48, seed=17):
    """The reference's B tenants: ``make_spd`` at cond 1e2, 1e3, 1e4, …"""
    rng = np.random.default_rng(seed)
    mats, bs = [], []
    for i in range(B):
        A0, _, _ = make_spd(n, 10.0 ** (2 + i % 3), rng)
        mats.append(A0)
        bs.append(rng.standard_normal(n))
    return np.stack(mats), np.stack(bs)


def _drifting_mats(n=96, k=8, num=4, seed=11, drift=0.01):
    """``tests/test_api.py``'s drifting systems (numpy)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.concatenate([np.linspace(1.0, 5.0, n - k), np.logspace(3.0, 4.5, k)])
    base = (q * eigs) @ q.T
    mats, bs = [], []
    for _ in range(num):
        pert = rng.standard_normal((n, n)) * drift
        mats.append(base + pert @ pert.T)
        bs.append(rng.standard_normal(n))
    return np.stack(mats), np.stack(bs)


def _same(got, want, what=""):
    """A lane against its sequential port solve (the reference test's bar)."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-12, atol=1e-12,
                               err_msg=str(what))


def _same_counts(got_info, want_info, i=None):
    """Iterations and matvecs of lane ``i`` equal the sequential solve's."""
    for field in ("iterations", "matvecs"):
        got = getattr(got_info, field)
        got = got if i is None else got[i]
        assert int(got) == int(getattr(want_info, field)), (field, i)


def _counts_close(got, want):
    """Iteration counts within one (ROADMAP P1)."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.max(np.abs(got - want)) <= 1, (got, want)


def _near_reference(x, x_ref, mats, bs, tol):
    """Both solves meet ``‖b − A x‖ ≤ tol‖b‖``: per tenant
    ``‖x − x_ref‖ ≤ 2·tol·‖b‖ / λ_min(A)``."""
    x, x_ref = np.asarray(x), np.asarray(x_ref)
    for i in range(len(bs)):
        lam = np.linalg.eigvalsh(mats[i])[0]
        bound = 2 * tol * np.linalg.norm(bs[i]) / lam
        assert np.linalg.norm(x[i] - x_ref[i]) <= bound, i


def _ref_batch(mats, bs, spec, state=None, **kw):
    return jc.solve_batch(jnp.asarray(mats), jnp.asarray(bs), spec, state,
                          make_operator=jc.from_matrix, **kw)


class TestSolveBatch:
    def test_parity_with_sequential_solves_and_reference(self):
        """B = 5 tenants: each lane its sequential port solve (iterations
        and matvecs equal, x to 1e-12, W to 1e-9), and the reference's
        batch lane (convergence, status and the matvec accounting exactly,
        x within the tolerance's bound)."""
        mats, bs = _tenants()
        spec = tc.SolveSpec(**SPEC)
        batch = tc.solve_batch(_t(mats), _t(bs), spec, make_operator=tc.from_matrix)
        assert batch.info.converged.all()
        for i in range(len(bs)):
            single = tc.solve(tc.from_matrix(_t(mats[i])), _t(bs[i]), spec)
            _same_counts(batch.info, single.info, i)
            _same(batch.x[i], single.x, i)
            np.testing.assert_allclose(batch.state.W[i].numpy(), single.state.W.numpy(),
                                       rtol=1e-9, atol=1e-9)
        ref = _ref_batch(mats, bs, jc.SolveSpec(**SPEC))
        it, mv = batch.info.iterations.numpy(), batch.info.matvecs.numpy()
        np.testing.assert_array_equal(mv - it, np.asarray(ref.info.matvecs)
                                      - np.asarray(ref.info.iterations))
        for key in ("converged", "status"):
            np.testing.assert_array_equal(getattr(batch.info, key).numpy(),
                                          np.asarray(getattr(ref.info, key)), key)
        _near_reference(batch.x, ref.x, mats, bs, SPEC["tol"])
        np.testing.assert_array_equal(batch.state.systems_solved.numpy(), 1)

    def test_batched_states_feed_back(self):
        """A second batched round consumes the first round's states: each
        lane the sequential warm solve, and 30 % fewer iterations."""
        B, n = 3, 64
        rng = np.random.default_rng(23)
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        eigs = np.concatenate([np.linspace(1.0, 5.0, n - 6), np.logspace(3.0, 4.5, 6)])
        A0 = (q * eigs) @ q.T
        mats = _t(np.stack([A0 + 0.01 * np.eye(n) * i for i in range(B)]))
        spec = tc.SolveSpec(**SPEC)
        bs1, bs2 = _t(rng.standard_normal((B, n))), _t(rng.standard_normal((B, n)))
        first = tc.solve_batch(mats, bs1, spec, make_operator=tc.from_matrix)
        second = tc.solve_batch(mats, bs2, spec, first.state, make_operator=tc.from_matrix)
        assert second.info.converged.all()
        assert (second.info.iterations < 0.7 * first.info.iterations).all()
        assert (second.state.systems_solved == 2).all()
        for i in range(B):
            one = tc.solve(tc.from_matrix(mats[i]), bs1[i], spec)
            two = tc.solve(tc.from_matrix(mats[i]), bs2[i], spec, one.state)
            _same_counts(second.info, two.info, i)
            _same(second.x[i], two.x, i)

    def test_batched_sequences(self):
        """sequence=True: B tenants × N systems (the reference's case),
        each tenant its sequential solve_sequence (iterations equal, x to
        1e-12) and every solution meeting the residual bar, as the
        reference's own test holds its batch."""
        B, N, n = 3, 3, 64
        rng = np.random.default_rng(29)
        A0, _, _ = make_spd(n, 1e4, rng)
        mats = np.empty((B, N, n, n))
        bs = np.empty((B, N, n))
        for t in range(B):
            for i in range(N):
                pert = rng.standard_normal((n, n)) * 0.01
                mats[t, i] = A0 * (1.0 + 0.1 * t) + pert @ pert.T
                bs[t, i] = rng.standard_normal(n)
        spec = tc.SolveSpec(**SPEC)
        batch = tc.solve_batch(_t(mats), _t(bs), spec, make_operator=tc.from_matrix,
                               sequence=True)
        assert tuple(batch.x.shape) == (B, N, n)
        for t in range(B):
            seq = tc.solve_sequence(_t(mats[t]), _t(bs[t]), spec, make_operator=tc.from_matrix)
            np.testing.assert_array_equal(batch.info.iterations[t].numpy(),
                                          seq.info.iterations.numpy())
            np.testing.assert_array_equal(batch.info.matvecs[t].numpy(), seq.info.matvecs.numpy())
            _same(batch.x[t], seq.x, t)
            for i in range(N):
                np.testing.assert_allclose(mats[t, i] @ batch.x[t, i].numpy(), bs[t, i],
                                           atol=1e-6 * np.linalg.norm(bs[t, i]))
        ref = _ref_batch(mats, bs, jc.SolveSpec(**SPEC), sequence=True)
        assert np.asarray(ref.info.converged).all() and batch.info.converged.all()

    def test_carry_x_sequences(self):
        """carry_x warm-starts each tenant's sequence from its last x."""
        B, N, n = 2, 3, 64
        rng = np.random.default_rng(41)
        A0, _, _ = make_spd(n, 1e3, rng)
        mats = _t(np.stack([np.stack([A0 * (1 + 0.01 * i) for i in range(N)])] * B))
        b0 = rng.standard_normal(n)
        bs = _t(np.stack([np.stack([b0 * (1 + 1e-3 * i) for i in range(N)])] * B))
        spec = tc.SolveSpec(**SPEC)
        warm = tc.solve_batch(mats, bs, spec, make_operator=tc.from_matrix, sequence=True,
                              carry_x=True)
        seq = tc.solve_sequence(mats[0], bs[0], spec, make_operator=tc.from_matrix,
                                carry_x=True)
        np.testing.assert_array_equal(warm.info.iterations[0].numpy(),
                                      seq.info.iterations.numpy())
        _same(warm.x[0], seq.x)

    def test_cg_batch_passes_state_through(self):
        """method='cg' neither consumes nor updates the state (the
        reference's case); each lane is the sequential ``cg``."""
        mats, bs = _drifting_mats(num=2)
        spec = tc.SolveSpec(**SPEC)
        prev = tc.solve_batch(_t(mats), _t(bs), spec, make_operator=tc.from_matrix)
        out = tc.solve_batch(_t(mats), _t(bs), tc.SolveSpec(method="cg", tol=1e-8,
                                                            maxiter=3000),
                             prev.state, make_operator=tc.from_matrix)
        assert out.state is prev.state
        assert out.info.converged.all()
        for i in range(2):
            single = tc.cg(tc.from_matrix(_t(mats[i])), _t(bs[i]), tol=1e-8, maxiter=3000)
            _same_counts(out.info, single.info, i)
            _same(out.x[i], single.x, i)

    def test_per_tenant_convergence_mask(self):
        """A hard tenant does not corrupt an easy tenant's answer (the
        reference's case)."""
        n = 48
        rng = np.random.default_rng(31)
        easy, _, _ = make_spd(n, 10.0, rng)
        hard, _, _ = make_spd(n, 1e6, rng)
        mats = _t(np.stack([easy, hard]))
        bs = _t(rng.standard_normal((2, n)))
        spec = tc.SolveSpec(k=4, ell=8, tol=1e-12, maxiter=40)
        batch = tc.solve_batch(mats, bs, spec, make_operator=tc.from_matrix)
        assert bool(batch.info.converged[0]) and not bool(batch.info.converged[1])
        single = tc.solve(tc.from_matrix(mats[0]), bs[0], spec)
        _same(batch.x[0], single.x)
        _same_counts(batch.info, single.info, 0)

    def test_shared_kernel_batch_is_one_product(self):
        """A KernelSystemOperator whose sqrt_h is (B, n): K runs once per
        iteration on the (n, B) stack, and each tenant is its own solve.
        The one product sums each column in the matrix product's order,
        not the sequential GEMV's, so here a lane agrees with its
        sequential solve to rounding: counts within one, x within the
        tolerance's bound."""
        rng = np.random.default_rng(7)
        n, B = 64, 4
        x = rng.standard_normal((n, 3))
        K = _t(np.exp(-0.5 * np.sum((x[:, None] - x[None]) ** 2, -1)))
        calls = []

        def k_mv(v):
            calls.append(tuple(v.shape))
            return K @ v

        sh = _t(rng.uniform(0.1, 0.5, (B, n)))
        bs = _t(rng.standard_normal((B, n)))
        spec = tc.SolveSpec(k=4, ell=8, tol=1e-8, maxiter=500)
        batch = tc.solve_batch(tc.KernelSystemOperator(k_mv, sh), bs, spec)
        assert all(shape == (n, B) for shape in calls), set(calls)
        assert batch.info.converged.all()
        singles, mats = [], []
        for i in range(B):
            single = tc.solve(tc.KernelSystemOperator(lambda v: K @ v, sh[i]), bs[i], spec)
            _counts_close(int(batch.info.iterations[i]), int(single.info.iterations))
            singles.append(single.x.numpy())
            h = sh[i].numpy()
            mats.append(np.eye(n) + h[:, None] * K.numpy() * h[None, :])
        _near_reference(batch.x, np.stack(singles), np.stack(mats), bs.numpy(), 1e-8)

    def test_preconditioned_tenants(self):
        """Jacobi tenants run K6's lane arm: each lane the sequential
        preconditioned solve, warm round included."""
        mats, bs = _tenants(B=3, seed=43)
        spec = tc.SolveSpec(precond="jacobi", **SPEC)

        def make_prec(op):
            return tc.jacobi(torch.diagonal(op.mat).clone())

        batch = tc.solve_batch(_t(mats), _t(bs), spec, make_operator=tc.from_matrix,
                               make_preconditioner=make_prec)
        batch = tc.solve_batch(_t(mats), _t(bs[::-1].copy()), spec, batch.state,
                               make_operator=tc.from_matrix, make_preconditioner=make_prec)
        for i in range(3):
            A = tc.from_matrix(_t(mats[i]))
            s1 = tc.solve(A, _t(bs[i]), spec, M=make_prec(A))
            s2 = tc.solve(A, _t(bs[::-1][i].copy()), spec, s1.state, M=make_prec(A))
            _same_counts(batch.info, s2.info, i)
            _same(batch.x[i], s2.x, i)

    def test_recovery_ladder_runs_per_lane(self):
        """A poisoned tenant climbs the ladder on its own lane (the others
        ride along on a zero right-hand side and keep their answers): every
        lane's rung, status, counts and x those of its sequential solve."""
        mats, bs = _tenants(B=3, seed=51)
        spec = tc.SolveSpec(**SPEC)
        warm = tc.solve_batch(_t(mats), _t(bs), spec, make_operator=tc.from_matrix)
        systems = {"mat": _t(mats), "poison": torch.tensor([0.0, float("nan"), 0.0],
                                                           dtype=torch.float64)}

        def make(s):
            return tc.FaultInjectingOperator(tc.from_matrix(s["mat"]), s["poison"])

        b2 = _t(bs[::-1].copy())
        out = tc.solve_batch(systems, b2, spec, warm.state, make_operator=make)
        assert torch.isfinite(out.x).all()
        np.testing.assert_array_equal(out.report.rung.numpy(), [0, 3, 0])
        for i in range(3):
            state_i = tc.RecycleState(*(getattr(warm.state, f)[i] for f in
                                        ("W", "AW", "theta", "systems_solved", "drift")))
            one = tc.solve(make({"mat": systems["mat"][i], "poison": systems["poison"][i]}),
                           b2[i], spec, state_i)
            assert int(out.report.rung[i]) == int(one.report.rung)
            assert int(out.report.status[i]) == int(one.report.status)
            _same_counts(out.info, one.info, i)
            _same(out.x[i], one.x, i)
        assert not out.state.W[1].any()

    def test_least_squares_batches_refuse(self):
        """The least-squares doors, which refused before batched LSMR was
        ported, run: each lane of an ``lsmr`` and a ``deflsmr`` batch is its
        sequential port solve (``tests/test_torch_batch_lsq.py`` holds them
        against the reference)."""
        mats, bs = _tenants(B=2)
        for method in ("lsmr", "deflsmr"):
            spec = tc.SolveSpec(method=method, k=4, ell=8, tol=1e-10, maxiter=300)
            batch = tc.solve_batch(_t(mats), _t(bs), spec, make_operator=tc.from_matrix)
            assert batch.info.converged.all()
            for i in range(2):
                one = tc.solve(tc.from_matrix(_t(mats[i])), _t(bs[i]), spec)
                _same_counts(batch.info, one.info, i)
                assert torch.equal(batch.x[i], one.x), (method, i)


class TestSolvePoolStep:
    def test_idle_slots_against_reference(self):
        """Idle slots: zero right-hand side, state bit-untouched, info and
        report scrubbed (0 iterations, 0 matvecs, CONVERGED), as the
        reference's; active slots their sequential warm solves (and the
        reference's status and convergence, its iterations within one, x
        within the bound)."""
        mats, bs = _tenants(B=4, seed=11)
        spec_t, spec_j = tc.SolveSpec(**SPEC), jc.SolveSpec(**SPEC)
        warm_t = tc.solve_batch(_t(mats), _t(bs), spec_t, make_operator=tc.from_matrix)
        warm_j = _ref_batch(mats, bs, spec_j)
        active = np.array([True, False, True, False])
        bs2 = np.random.default_rng(12).standard_normal(bs.shape)
        out_t = tc.solve_pool_step(_t(mats), _t(bs2), spec_t, warm_t.state, torch.tensor(active),
                                   make_operator=tc.from_matrix)
        out_j = jc.solve_pool_step(jnp.asarray(mats), jnp.asarray(bs2), spec_j, warm_j.state,
                                   jnp.asarray(active), make_operator=jc.from_matrix)
        for field in ("W", "AW", "theta", "systems_solved", "drift"):
            new, old = getattr(out_t.state, field), getattr(warm_t.state, field)
            for i in np.flatnonzero(~active):
                assert torch.equal(new[i], old[i]), field
        np.testing.assert_array_equal(out_t.state.systems_solved.numpy(), [2, 1, 2, 1])
        for key in ("status", "converged"):
            np.testing.assert_array_equal(getattr(out_t.info, key).numpy(),
                                          np.asarray(getattr(out_j.info, key)), key)
        _counts_close(out_t.info.iterations, out_j.info.iterations)
        idle = ~active
        for got in (out_t.info.iterations, out_t.info.matvecs, out_t.report.matvecs,
                    out_t.report.rung, out_t.report.status):
            assert not got.numpy()[idle].any()
        np.testing.assert_array_equal(np.asarray(out_j.info.iterations)[idle], 0)
        np.testing.assert_array_equal(np.asarray(out_j.info.matvecs)[idle], 0)
        assert not out_t.x[~torch.tensor(active)].any()
        for i in np.flatnonzero(active):
            state_i = tc.RecycleState(*(getattr(warm_t.state, f)[i] for f in
                                        ("W", "AW", "theta", "systems_solved", "drift")))
            one = tc.solve(tc.from_matrix(_t(mats[i])), _t(bs2[i]), spec_t, state_i)
            _same_counts(out_t.info, one.info, i)
            _same(out_t.x[i], one.x, i)
        act = np.flatnonzero(active)
        _near_reference(out_t.x.numpy()[act], np.asarray(out_j.x)[act], mats[act], bs2[act],
                        SPEC["tol"])

    def test_all_idle_pool_costs_nothing(self):
        mats, bs = _tenants(B=2, seed=13)
        spec = tc.SolveSpec(**SPEC)
        state = tc.solve_batch(_t(mats), _t(bs), spec, make_operator=tc.from_matrix).state
        out = tc.solve_pool_step(_t(mats), _t(bs), spec, state, torch.zeros(2, dtype=torch.bool),
                                 make_operator=tc.from_matrix)
        assert not out.info.iterations.any() and not out.info.matvecs.any()
        assert torch.equal(out.state.W, state.W)


# ---------------------------------------------------------------------------
# The lane axis's reductions: the card's batched forms, and K1 / K6's order
# ---------------------------------------------------------------------------


def test_card_forms_of_the_lane_reductions():
    """On the card the solve's lane reductions run as one batched call
    each (``operators.over_lanes``'s second form): each agrees with the
    one-system reduction lane by lane to rounding."""
    g = torch.Generator().manual_seed(3)
    B, k, n = 4, 5, 37
    a, b = (torch.randn(B, n, generator=g, dtype=torch.float64) for _ in range(2))
    W = torch.randn(B, k, n, generator=g, dtype=torch.float64)
    AW = W + 0.1 * torch.randn(B, k, n, generator=g, dtype=torch.float64)
    c = torch.randn(B, k, generator=g, dtype=torch.float64)
    chol = ts.factor_waw_gram(W, AW, 1e-12, lanes=True)
    eye = torch.eye(k, dtype=torch.float64).expand(B, k, k)
    cases = [
        (torch.linalg.vecdot(a, b), [ts._dot(a[i], b[i]) for i in range(B)]),
        (ts._basis_dot_batched(W, a), [ts._basis_dot(W[i], a[i]) for i in range(B)]),
        (ts._combine_batched(W, c), [ts._combine(W[i], c[i]) for i in range(B)]),
        (ts._chol_solve_batched(chol, c), [ts._chol_solve(chol[i], c[i]) for i in range(B)]),
        (ts._chol_solve_batched(chol, eye), [ts._chol_solve(chol[i], eye[i]) for i in range(B)]),
        (ts._factor(W, AW, 1e-12), [ts.factor_waw_gram(W[i], AW[i], 1e-12) for i in range(B)]),
    ]
    for got, want in cases:
        torch.testing.assert_close(got, torch.stack(want), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("n,k", [(36551, 8), (36551, 0), (1001, 3), (1, 1)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lane_axis_reduction_order(n, k, dtype):
    """Lane i of a B-lane K1 / K6 launch sums exactly as a one-lane launch
    on lane i's data: its loads (16-byte or element, by its own rows'
    alignment), its block count and its block order."""
    B = 5
    g = torch.Generator().manual_seed(n + k)
    r = torch.randn(B, n, generator=g, dtype=dtype)
    z = torch.randn(B, n, generator=g, dtype=dtype)
    aw = torch.randn(B, k, n, generator=g, dtype=dtype) if k else None
    for i in range(B):
        # Lane i starts i·n elements into the stack: its own alignment.
        offset = i * n * r.element_size()
        lane = ro.lane_sums(r, z, aw, i, resident=1056, capacity=1056)
        one = ro.one_lane_sums(r[i], z[i], None if aw is None else aw[i], offset,
                               resident=1056, capacity=1056)
        assert torch.equal(lane, one), i
