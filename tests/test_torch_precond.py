"""Preconditioners, the matrix-free Newton operator and preconditioned
solves of the PyTorch port against the live JAX reference.

The same numpy inputs go through ``repro`` (x64 on) and ``repro_torch`` on
the CPU.  Operators and preconditioner applies agree to 1e-12; solves to
the reference's own tolerances: f64 iterates 1e-10, iteration counts
equal or within the ±3 that ROADMAP R4 documents for preconditioned
counts, matvecs equal where the counts are.  A Nyström sketch is random,
so the port is held to the reference's sketch carried across with
:func:`repro_torch.convert.nystrom_sketch_from_numpy`, and its own sketch
is checked by properties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro.core import operators as j_operators  # noqa: E402
from repro.gp import RBFKernel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import strategies as t_strategies  # noqa: E402

N, D, RANK = 150, 13, 12


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, tol):
    got, want = _np(got), np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def gp_data():
    rng = np.random.default_rng(17)
    x = rng.standard_normal((N, D))
    pi = 1.0 / (1.0 + np.exp(-0.5 * rng.standard_normal(N)))
    sqrt_h = np.sqrt(pi * (1.0 - pi))
    return x, sqrt_h, rng.standard_normal(N), rng.standard_normal((5, N))


@pytest.fixture(scope="module")
def k_sketch(gp_data):
    """The reference's Nyström sketch of K (θ = 2, λ = 1.5)."""
    x = gp_data[0]
    k_mv = RBFKernel(2.0, 1.5).matvec_fn(jnp.asarray(x), impl="chunked")
    return jc.randomized_nystrom(k_mv, jnp.zeros(N), RANK, jax.random.PRNGKey(3))


def _rbf_ops(x, sqrt_h):
    j_op = j_operators.RBFKernelSystemOperator(
        jnp.asarray(x), jnp.asarray(sqrt_h), 2.0, 1.5, block=64, impl="chunked"
    )
    t_op = tc.RBFKernelSystemOperator(_t(x), _t(sqrt_h), 2.0, 1.5, block=64)
    return j_op, t_op


def test_rbf_system_operator_matches_reference(gp_data):
    x, sqrt_h, v, basis = gp_data
    j_op, t_op = _rbf_ops(x, sqrt_h)
    _close(t_op.matvec(_t(v)), j_op.matvec(jnp.asarray(v)), 1e-12)
    _close(t_op(_t(v)), j_op(jnp.asarray(v)), 1e-12)
    _close(t_op.basis_matvec(_t(basis)), j_op.basis_matvec(jnp.asarray(basis)), 1e-12)
    _close(tc.apply_to_basis(t_op, _t(basis)),
           np.stack([np.asarray(j_op.matvec(jnp.asarray(b))) for b in basis]), 1e-12)


def test_matvec_fn_is_the_gram_product(gp_data):
    x, _, v, basis = gp_data
    from repro_torch.gp import RBFKernel as TKernel

    k = TKernel(2.0, 1.5)
    kmat = k.gram(_t(x))
    mv = k.matvec_fn(_t(x), block=37)
    _close(mv(_t(v)), kmat @ _t(v), 1e-12)
    _close(mv(_t(basis).T), kmat @ _t(basis).T, 1e-12)


def test_jacobi_apply_matches_reference(gp_data):
    _, sqrt_h, v, _ = gp_data
    diag = 1.0 + 4.0 * sqrt_h**2
    _close(tc.jacobi(_t(diag))(_t(v)), jc.jacobi(jnp.asarray(diag))(jnp.asarray(v)), 1e-12)


def test_nystrom_apply_matches_reference(gp_data, k_sketch):
    _, _, v, _ = gp_data
    U, lam = convert.nystrom_sketch_from_numpy(
        *k_sketch, dtype=torch.float64, device="cpu"
    )
    want = jc.nystrom_preconditioner(*k_sketch, 0.7)(jnp.asarray(v))
    _close(tc.nystrom_preconditioner(U, lam, 0.7)(_t(v)), want, 1e-12)


def test_woodbury_apply_matches_reference(gp_data, k_sketch):
    _, sqrt_h, v, _ = gp_data
    U, lam = convert.nystrom_sketch_from_numpy(
        *k_sketch, dtype=torch.float64, device="cpu"
    )
    want = jc.kernel_nystrom_preconditioner(*k_sketch, jnp.asarray(sqrt_h))
    got = tc.kernel_nystrom_preconditioner(U, lam, _t(sqrt_h))
    _close(got(_t(v)), want(jnp.asarray(v)), 1e-12)


def test_randomized_nystrom_properties():
    """U is orthonormal and, on a rank-8 SPD matrix (plus 1e-6·I, which
    keeps the 16 probes' sketch full rank), the Ritz values are its top
    eigenvalues; the multi-RHS and row-by-row operators give the same
    sketch."""
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.standard_normal((N, 8)))
    eigs = np.array([50.0, 20.0, 9.0, 5.0, 3.0, 2.0, 1.5, 1.1])
    mat = _t((q * eigs) @ q.T + 1e-6 * np.eye(N))
    gen = torch.Generator().manual_seed(0)
    U, lam = tc.randomized_nystrom(tc.from_matrix(mat), torch.zeros(N, dtype=torch.float64),
                                   8, gen)
    assert U.shape == (8, N) and lam.shape == (8,)
    np.testing.assert_allclose(_np(U @ U.T), np.eye(8), atol=1e-12)
    np.testing.assert_allclose(_np(lam), eigs + 1e-6, rtol=1e-10)
    np.testing.assert_allclose(_np(lam), np.linalg.eigvalsh(_np(mat))[::-1][:8], rtol=1e-10)
    gen = torch.Generator().manual_seed(0)
    U2, lam2 = tc.randomized_nystrom(lambda v: mat @ v, torch.zeros(N, dtype=torch.float64),
                                     8, gen)
    torch.testing.assert_close(lam2, lam, rtol=1e-12, atol=1e-12)
    # Unit rows: the two products differ in their last bits, which the
    # 1e-6 tail of the sketch turns into ~1e-10 in the Ritz vectors.
    torch.testing.assert_close(U2, U, rtol=0.0, atol=1e-8)


def test_make_preconditioner_matches_spec(gp_data):
    x, sqrt_h, v, _ = gp_data
    _, t_op = _rbf_ops(x, sqrt_h)
    template = torch.zeros(N, dtype=torch.float64)
    assert tc.make_preconditioner(t_op, tc.SolveSpec(), template) is None
    jac = tc.make_preconditioner(t_op, tc.SolveSpec(precond="jacobi"), template,
                                 diag=_t(1.0 + sqrt_h**2))
    assert isinstance(jac, tc.JacobiPreconditioner)
    nys = tc.make_preconditioner(t_op, tc.SolveSpec(precond="nystrom", precond_rank=6),
                                 template, generator=torch.Generator().manual_seed(1))
    assert isinstance(nys, tc.NystromPreconditioner) and nys.U.shape == (6, N)
    with pytest.raises(ValueError, match="diag"):
        tc.make_preconditioner(t_op, tc.SolveSpec(precond="jacobi"), template)
    with pytest.raises(ValueError, match="generator"):
        tc.make_preconditioner(t_op, tc.SolveSpec(precond="nystrom"), template)
    with pytest.raises(ValueError, match="custom"):
        tc.make_preconditioner(t_op, tc.SolveSpec(precond="custom"), template)
    with pytest.raises(ValueError, match="no M was passed"):
        tc.solve(t_op, _t(v), tc.SolveSpec(precond="jacobi"))
    with pytest.raises(ValueError, match="make_preconditioner"):
        tc.solve_sequence(_t(sqrt_h)[None], _t(v)[None], tc.SolveSpec(precond="jacobi"),
                          make_operator=lambda s: t_op)


def _preconditioners(kind, gp_data, k_sketch, sqrt_h):
    if kind == "jacobi":
        diag = 1.0 + 4.0 * sqrt_h**2  # diag(A) = 1 + h θ²
        return jc.jacobi(jnp.asarray(diag)), tc.jacobi(_t(diag))
    U, lam = convert.nystrom_sketch_from_numpy(*k_sketch, dtype=torch.float64, device="cpu")
    return (jc.kernel_nystrom_preconditioner(*k_sketch, jnp.asarray(sqrt_h)),
            tc.kernel_nystrom_preconditioner(U, lam, _t(sqrt_h)))


def _assert_solves_agree(ref, got):
    _close(got.x, ref.x, 1e-10)
    ji, ti = ref.info, got.info
    assert abs(int(ti.iterations) - int(ji.iterations)) <= 3
    # The same charges beyond the iterations (initial residual, refresh).
    assert int(ti.matvecs) - int(ti.iterations) == int(ji.matvecs) - int(ji.iterations)
    assert bool(ti.converged) and bool(ji.converged)


@pytest.mark.parametrize("kind", ["jacobi", "nystrom"])
@pytest.mark.parametrize("method", ["cg", "defcg"])
def test_preconditioned_solve_matches_reference(gp_data, k_sketch, kind, method):
    """A preconditioned sequence of three Newton-like systems through the
    ``solve`` front door, state carried, against the reference."""
    x, sqrt_h0, _, bs = gp_data
    jspec = jc.SolveSpec(method=method, k=4, ell=8, tol=1e-11, precond=kind)
    tspec = tc.SolveSpec(method=method, k=4, ell=8, tol=1e-11, precond=kind)
    jstate = tstate = None
    counts = []
    for i in range(3):
        sqrt_h = sqrt_h0 * (1.0 + 0.1 * i)
        j_op, t_op = _rbf_ops(x, sqrt_h)
        jm, tm = _preconditioners(kind, gp_data, k_sketch, sqrt_h)
        ref = jc.solve(j_op, jnp.asarray(bs[i]), jspec, jstate, M=jm)
        got = tc.solve(t_op, _t(bs[i]), tspec, tstate, M=tm)
        _assert_solves_agree(ref, got)
        counts.append((int(ref.info.iterations), int(got.info.iterations)))
        jstate, tstate = ref.state, got.state
    assert sum(abs(a - b) for a, b in counts) <= 3, counts


def test_preconditioned_recycle_manager_matches_reference(gp_data, k_sketch):
    x, sqrt_h0, _, bs = gp_data
    jm_mgr = jc.RecycleManager(k=4, ell=8, tol=1e-11)
    tm_mgr = tc.RecycleManager(k=4, ell=8, tol=1e-11)
    for i in range(3):
        sqrt_h = sqrt_h0 * (1.0 - 0.1 * i)
        j_op, t_op = _rbf_ops(x, sqrt_h)
        jm, tm = _preconditioners("nystrom", gp_data, k_sketch, sqrt_h)
        ref = jm_mgr.solve(j_op, jnp.asarray(bs[i]), M=jm)
        got = tm_mgr.solve(t_op, _t(bs[i]), M=tm)
        _assert_solves_agree(ref, got)


def test_preconditioned_solve_sequence_matches_reference(gp_data):
    x, sqrt_h0, _, bs = gp_data
    sqrt_hs = np.stack([sqrt_h0 * (1.0 + 0.05 * i) for i in range(3)])
    spec_kw = dict(k=4, ell=8, tol=1e-11, precond="jacobi")

    def j_make(sh):
        return j_operators.RBFKernelSystemOperator(
            jnp.asarray(x), sh, 2.0, 1.5, block=64, impl="chunked")

    def t_make(sh):
        return tc.RBFKernelSystemOperator(_t(x), sh, 2.0, 1.5, block=64)

    ref = jc.solve_sequence(
        jnp.asarray(sqrt_hs), jnp.asarray(bs[:3]), jc.SolveSpec(**spec_kw),
        make_operator=j_make,
        make_preconditioner=lambda op: jc.jacobi(1.0 + 4.0 * op.sqrt_h**2),
    )
    got = tc.solve_sequence(
        _t(sqrt_hs), _t(bs[:3]), tc.SolveSpec(**spec_kw), make_operator=t_make,
        make_preconditioner=lambda op: tc.jacobi(1.0 + 4.0 * op.sqrt_h**2),
    )
    _close(got.x, ref.x, 1e-10)
    np.testing.assert_array_equal(_np(got.info.iterations), np.asarray(ref.info.iterations))
    np.testing.assert_array_equal(_np(got.info.matvecs), np.asarray(ref.info.matvecs))


def test_m_geometry_strategy_is_not_ported(gp_data):
    """MGeometryHarmonic runs now: with Jacobi on the matrix-free operator
    a warm second solve gives the reference's counts; without a
    preconditioner the spec and the manager refuse it."""
    x, sqrt_h, b, bs = gp_data
    j_op, t_op = _rbf_ops(x, sqrt_h)
    kw = dict(k=4, ell=8, tol=1e-11, precond="jacobi")
    j_spec = jc.SolveSpec(strategy=jc.MGeometryHarmonic(), **kw)
    t_spec = tc.SolveSpec(strategy=tc.MGeometryHarmonic(), **kw)
    j_m, t_m = jc.jacobi(1.0 + 4.0 * j_op.sqrt_h**2), tc.jacobi(1.0 + 4.0 * t_op.sqrt_h**2)
    ref = jc.solve(j_op, jnp.asarray(b), j_spec, M=j_m)
    ref = jc.solve(j_op, jnp.asarray(bs[0]), j_spec, ref.state, M=j_m)
    got = tc.solve(t_op, _t(b), t_spec, M=t_m)
    got = tc.solve(t_op, _t(bs[0]), t_spec, got.state, M=t_m)
    assert int(got.info.iterations) == int(ref.info.iterations)
    assert int(got.info.matvecs) == int(ref.info.matvecs)
    _close(got.x, ref.x, 1e-10)
    with pytest.raises(ValueError, match="precond"):
        tc.SolveSpec(strategy=tc.MGeometryHarmonic())
    mgr = tc.RecycleManager(k=4, ell=8, strategy=t_strategies.MGeometryHarmonic())
    with pytest.raises(ValueError, match="pass M"):
        mgr.solve(t_op, _t(b))