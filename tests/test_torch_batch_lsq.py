"""Batched least squares (``solve_batch`` / ``solve_pool_step`` for ``lsmr``
and ``deflsmr``) and K7's lane axis, against sequential port solves and the
live JAX reference.

Mirrors ``tests/test_lsmr.py``'s ``test_solve_batch_stateless_lsmr`` and
``test_solve_pool_step_deflsmr_masked`` on its own inputs
(``_ill_conditioned_sequence(num=3, m=45, n=30)``: logspace(0, −3)
singular values, λ = 1e-3, tol 1e-10).  On the CPU every lane IS its
sequential port solve (``solve``, ``solve_sequence(deflsmr)``):
iterations, matvecs, x and the carried basis bit for bit — the lanes'
reductions, products and refreshes run lane by lane in the one-system
order and layout there.  Against the reference's batch: status,
convergence and the accounting ``matvecs = init + 2·iterations`` exactly;
iterations within ROADMAP P5's bars (LSMR on ill-conditioned systems
parts with rounding past ~12 iterations: 8 a system, 3 % in total); x to
1e-7 relative (``test_lsmr.py``'s bar for the front door).

K7's step arm on a ``(B, n)`` lane axis (``tests/torch_lane_cases.py``):
its plain version is the one-lane plain arm lane by lane, on strided
per-lane scalars, armed and unarmed (the card holds the kernel to it bit
for bit: ``tests/test_torch_cuda.py``).  And ``examples/quickstart.py``'s
``solve_batch`` half in both packages on the same data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax.config.update("jax_enable_x64", True)

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import torch_lane_cases as lc  # noqa: E402
from repro_torch.kernels import cg_fused  # noqa: E402

LAM = 1e-3
SPEC_KW = dict(k=4, ell=12, tol=1e-10, maxiter=300, lsq_shift=LAM)
PER_SYSTEM, TOTAL = 8, 0.03  # ROADMAP P5's bars
# def-LSMR's products besides 2 an iteration: the exact NW refresh (2k), the
# warm start's residual and adjoint (2), A x₀ and Âᵀu₁ (2).
DEFLSMR_INIT = 2 * SPEC_KW["k"] + 4


def _ill_conditioned_sequence(num, m=90, n=60, drift=0.02, seed=3):
    """``tests/test_lsmr.py``'s drifting rectangular systems (numpy)."""
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


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _specs(method):
    return tc.SolveSpec(method=method, **SPEC_KW), jc.SolveSpec(method=method, **SPEC_KW)


def _same_lane(batch, i, one):
    """Lane ``i`` of a batch is bit for bit its sequential port solve."""
    for field in ("iterations", "matvecs", "converged", "status"):
        assert torch.equal(getattr(batch.info, field)[i], torch.as_tensor(
            getattr(one.info, field)).to(getattr(batch.info, field).dtype)), (field, i)
    assert torch.equal(batch.x[i], one.x), i


def _against_reference(got_info, got_x, ref_info, ref_x, init):
    """Status, convergence and the accounting exactly; iterations within
    P5's bars; x to 1e-7 relative."""
    for field in ("status", "converged"):
        np.testing.assert_array_equal(getattr(got_info, field).numpy(),
                                      np.asarray(getattr(ref_info, field)), field)
    its, ref_its = got_info.iterations.numpy(), np.asarray(ref_info.iterations)
    np.testing.assert_array_equal(got_info.matvecs.numpy(), init + 2 * its)
    np.testing.assert_array_equal(np.asarray(ref_info.matvecs), init + 2 * ref_its)
    assert np.max(np.abs(its - ref_its)) <= PER_SYSTEM, (its, ref_its)
    assert abs(its.sum() - ref_its.sum()) <= max(1, TOTAL * ref_its.sum()), (its, ref_its)
    x, ref_x = got_x.numpy(), np.asarray(ref_x)
    err = np.linalg.norm(x - ref_x, axis=-1) / np.linalg.norm(ref_x, axis=-1)
    assert err.max() < 1e-7, err


@pytest.fixture(scope="module")
def systems():
    return _ill_conditioned_sequence(num=3, m=45, n=30)


def test_solve_batch_stateless_lsmr(systems):
    """``tests/test_lsmr.py:334``: three tenants' ``lsmr`` at once; the
    state passes through; each lane is its sequential solve."""
    mats, bs = systems
    spec_t, spec_j = _specs("lsmr")
    state = tc.RecycleState.zeros(4, 30, dtype=torch.float64, device="cpu")
    res = tc.solve_batch(_t(mats), _t(bs), spec_t, state, make_operator=tc.DenseMatrixOperator)
    assert res.info.converged.all() and res.x.shape == (3, 30)
    assert res.state is state
    for i in range(3):
        _same_lane(res, i, tc.solve(tc.DenseMatrixOperator(_t(mats[i])), _t(bs[i]), spec_t))
    ref = jc.solve_batch_jit(jnp.asarray(mats), jnp.asarray(bs), spec_j,
                             make_operator=jc.DenseMatrixOperator)
    _against_reference(res.info, res.x, ref.info, ref.x, init=1)
    # The normal residual each lane reports is its own.
    for i in range(3):
        A, b = mats[i], bs[i]
        x = res.x[i].numpy()
        normal = np.linalg.norm(A.T @ (b - A @ x) - LAM * x)
        assert abs(normal - float(res.info.residual_norm[i])) <= 1e-6 * np.linalg.norm(A.T @ b)


def test_solve_pool_step_deflsmr_masked(systems):
    """``tests/test_lsmr.py:343``: a cold pool, the middle slot idle (zero
    right-hand side, 0 iterations, its state bit-untouched); then a warm
    step with the first slot idle.  Active lanes are their sequential
    ``solve`` calls and the reference's pool step."""
    mats, bs = systems
    spec_t, spec_j = _specs("deflsmr")
    active = np.array([True, False, True])
    res = tc.solve_pool_step(_t(mats), _t(bs), spec_t, None, torch.tensor(active),
                             make_operator=tc.DenseMatrixOperator)
    assert res.state.systems_solved.tolist() == [1, 0, 1]
    assert int(res.info.iterations[1]) == 0 and int(res.info.matvecs[1]) == 0
    assert not res.state.W[1].any() and not res.x[1].any()
    ref = jc.solve_pool_step_jit(jnp.asarray(mats), jnp.asarray(bs), spec_j, None,
                                 jnp.asarray(active), make_operator=jc.DenseMatrixOperator)
    np.testing.assert_array_equal(np.asarray(ref.state.systems_solved), [1, 0, 1])
    for i in np.flatnonzero(active):
        _same_lane(res, i, tc.solve(tc.DenseMatrixOperator(_t(mats[i])), _t(bs[i]), spec_t))
    act = torch.tensor(active)
    sub = lambda info: type(info)(*(None if v is None else torch.as_tensor(v)[act]  # noqa: E731
                                    for v in info))
    _against_reference(sub(res.info), res.x[act], jax.tree_util.tree_map(
        lambda v: np.asarray(v)[active], ref.info), np.asarray(ref.x)[active], init=DEFLSMR_INIT)

    # Warm: the first slot idle keeps its state bit for bit.
    active2 = torch.tensor([False, True, True])
    bs2 = _t(np.random.default_rng(8).standard_normal(bs.shape))
    warm = tc.solve_pool_step(tc.DenseMatrixOperator(_t(mats)), bs2, spec_t, res.state, active2)
    for field in ("W", "AW", "theta", "systems_solved", "drift"):
        assert torch.equal(getattr(warm.state, field)[0], getattr(res.state, field)[0]), field
    assert warm.state.systems_solved.tolist() == [1, 1, 2]
    state2 = tc.RecycleState(*(getattr(res.state, f)[2] for f in
                               ("W", "AW", "theta", "systems_solved", "drift")))
    _same_lane(warm, 2, tc.solve(tc.DenseMatrixOperator(_t(mats[2])), bs2[2], spec_t, state2))


@pytest.mark.parametrize("carry_x", [False, True])
def test_solve_batch_deflsmr_sequences(carry_x):
    """Three tenants, each its own drifting sequence (``sequence=True``):
    every lane bit for bit its ``solve_sequence(deflsmr)`` — x, counts and
    the final basis — and the reference's batch within P5's bars."""
    B, num = 3, 3
    mats, bs = zip(*[_ill_conditioned_sequence(num, m=45, n=30, seed=10 + i) for i in range(B)])
    mats, bs = np.stack(mats), np.stack(bs)
    spec_t, spec_j = _specs("deflsmr")
    # The tenants as raw matrices mapped through make_operator, or as one
    # DenseMatrixOperator over the (B, N, m, n) stack.
    systems = dict(systems=tc.DenseMatrixOperator(_t(mats))) if carry_x else dict(
        systems=_t(mats), make_operator=tc.DenseMatrixOperator)
    res = tc.solve_batch(b_batch=_t(bs), spec=spec_t, sequence=True, carry_x=carry_x,
                         **systems)
    assert res.x.shape == (B, num, 30) and res.info.converged.all()
    for i in range(B):
        seq = tc.solve_sequence(_t(mats[i]), _t(bs[i]), spec_t,
                                make_operator=tc.DenseMatrixOperator, carry_x=carry_x)
        assert torch.equal(res.info.iterations[i], seq.info.iterations), i
        assert torch.equal(res.info.matvecs[i], seq.info.matvecs), i
        assert torch.equal(res.x[i], seq.x), i
        assert torch.equal(res.state.W[i], seq.state.W) and torch.equal(res.state.AW[i],
                                                                       seq.state.AW)
    ref = jc.solve_batch_jit(jnp.asarray(mats), jnp.asarray(bs), spec_j,
                             make_operator=jc.DenseMatrixOperator, sequence=True,
                             carry_x=carry_x)
    flat = lambda info: type(info)(*(None if v is None else torch.as_tensor(v).reshape(-1)  # noqa
                                     for v in info))
    _against_reference(flat(res.info), res.x.reshape(B * num, -1),
                       jax.tree_util.tree_map(lambda v: np.asarray(v).reshape(-1), ref.info),
                       np.asarray(ref.x).reshape(B * num, -1), init=DEFLSMR_INIT)


def test_lane_operator_adjoint_and_stacked_dense_tenants():
    """The lane operators' adjoint: a (B, m, n) stack is held as given (a
    view, no copy) and multiplies as each tenant's own operator, forward,
    adjoint and on a basis; a list of tenants multiplies one by one to the
    same result; ``solve_batch`` holds a stacked batch as one
    ``LaneDenseOperator``."""
    from repro_torch.core import api as api_mod
    from repro_torch.core import operators as ops_mod

    g = torch.Generator().manual_seed(0)
    mats = torch.randn(3, 2, 7, 5, generator=g, dtype=torch.float64)
    ops = [tc.DenseMatrixOperator(mats[i, 1]) for i in range(3)]
    lane = ops_mod.LaneDenseOperator(mats[:, 1])
    assert lane.mats.data_ptr() == mats[0, 1].data_ptr() and lane.domain_size == 5
    v, u = torch.randn(3, 5, generator=g, dtype=torch.float64), \
        torch.randn(3, 7, generator=g, dtype=torch.float64)
    basis = torch.randn(3, 4, 5, generator=g, dtype=torch.float64)
    for i, op in enumerate(ops):
        assert torch.equal(lane.matvec(v)[i], op(v[i]))
        assert torch.equal(lane.rmatvec(u)[i], op.rmatvec(u[i]))
        assert torch.equal(lane.T.matvec(u)[i], op.T(u[i]))
        assert torch.equal(lane.basis_matvec(basis)[i], ops_mod.apply_to_basis(op, basis[i]))
    apart = ops_mod.lane_operator([tc.DenseMatrixOperator(mats[i, 1].clone()) for i in range(3)])
    assert type(apart) is ops_mod.LaneOperator
    assert torch.equal(apart.rmatvec(u), lane.rmatvec(u))
    assert torch.equal(apart.basis_matvec(basis), lane.basis_matvec(basis))
    generic = ops_mod.LaneOperator([tc.LinearOperator(op.matvec, rmatvec=op.rmatvec)
                                    for op in ops])
    assert torch.equal(ops_mod.adjoint_matvec(generic)(u), lane.rmatvec(u))
    for systems, make in ((tc.DenseMatrixOperator(mats[:, 1]), None),
                          (mats[:, 1], tc.DenseMatrixOperator), (mats[:, 1], tc.from_matrix)):
        A, _, _ = api_mod._lane_problem(systems, 3, make, None)
        assert isinstance(A, ops_mod.LaneDenseOperator)
        assert A.mats.data_ptr() == mats[0, 1].data_ptr()


@pytest.mark.parametrize("window", [0, 10])
@pytest.mark.parametrize("lanes,n", [(8, 33), (5, 1), (3, 1000)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lsmr_step_plain_lanes_are_the_one_lane_arm(window, lanes, n, dtype):
    """K7's plain step on a (B, n) stack is the one-lane plain step on each
    lane's views (strided per-lane scalars, ``s`` rows of a wider buffer,
    live, frozen, converging, diverging and exactly terminating lanes),
    armed and unarmed; the CUDA wrapper refuses CPU tensors."""
    t = lc.lsmr_lane_inputs(torch, "cpu", dtype, lanes, n, window=window, seed=lanes + n)
    assert t["s"].stride(0) > t["s"].shape[1] and t["wsq"].stride(0) > 1
    full, per_lane = lc.run_lsmr_lane_arms(torch, cg_fused, t, arms="plain")
    assert lc.lane_mismatches(torch, full, per_lane) == []
    assert full["so"].shape == (lanes, 7 + (window > 0))
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu tensor"):
        lc.run_lsmr_steps(torch, cg_fused, t, arms="cuda")


def test_quickstart_solve_batch_half():
    """``examples/quickstart.py``'s ``solve_batch`` half in both packages on
    the same data: B = 4 tenants sharing K converge, and the recycled
    second round takes fewer iterations on average than the cold one."""
    from repro.data import make_infinite_digits
    from repro.gp import RBFKernel as JRBF
    from repro_torch.gp import RBFKernel as TRBF

    n, B = 220, 4
    x, _ = make_infinite_digits(n, seed=7)
    rng = np.random.default_rng(0)
    fs = rng.standard_normal((B, n)) * 0.5
    sqrt_h = np.sqrt(1.0 / (1.0 + np.exp(-fs)) * (1.0 - 1.0 / (1.0 + np.exp(-fs))))
    bs, bs2 = rng.standard_normal((B, n)), rng.standard_normal((B, n))
    kw = dict(method="defcg", k=8, ell=12, tol=1e-8, maxiter=2000)

    kd_j = JRBF(theta=30.0, lengthscale=32.0).gram(jnp.asarray(x, jnp.float64))
    tenants_j = jc.KernelSystemOperator(lambda v: kd_j @ v, jnp.asarray(sqrt_h))
    one_j = jc.solve_batch_jit(tenants_j, jnp.asarray(bs), jc.SolveSpec(**kw))
    two_j = jc.solve_batch_jit(tenants_j, jnp.asarray(bs2), jc.SolveSpec(**kw), one_j.state)

    kd_t = TRBF(theta=30.0, lengthscale=32.0).gram(_t(x))
    tenants_t = tc.KernelSystemOperator(lambda v: kd_t @ v, _t(sqrt_h))
    one_t = tc.solve_batch(tenants_t, _t(bs), tc.SolveSpec(**kw))
    two_t = tc.solve_batch(tenants_t, _t(bs2), tc.SolveSpec(**kw), one_t.state)

    for one, two in ((one_j, two_j), (one_t, two_t)):
        cold, warm = np.asarray(one.info.iterations), np.asarray(two.info.iterations)
        assert np.asarray(one.info.converged).all() and np.asarray(two.info.converged).all()
        assert warm.mean() < cold.mean(), (cold, warm)
