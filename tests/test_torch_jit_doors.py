"""The port's compiled front doors against the reference's and its own eager doors.

The reference jits ``cg``, ``defcg``, ``solve``, ``solve_sequence``,
``solve_batch``, ``solve_pool_step``, ``lsmr`` and ``solve_sequence_lsmr``
(and ``RecycleManager`` solves through ``defcg_jit``); the port runs the
same doors with every masked loop as one compiled program
(``repro_torch.core.engine.Program``: CUDA graphs on the card, the same
buffers stepped eagerly on the CPU).  On the same numpy inputs, in f64 at
n = 64 (spectra of condition 10: every solve stops well under n, where

* each door against the reference's door: iterates to 1e-10, iterations
  within 1, matvecs and statuses exactly (the reference doors run once, a
  module fixture);
* each door bit for bit against the port's eager door (x, info, state,
  the recorded window);
* a program's buffers against ``run_recording_loop`` bit for bit;
* the program cache: a new Newton system (a new ``sqrt_h``) reuses its
  program, a new ``kernel_matvec`` closure builds a new one that shares
  the first one's buffers, and a dead closure's program is evicted;
* the fault-injecting operator's declared host-state route.
"""

import dataclasses
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax.config.update("jax_enable_x64", True)

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core import recycle as jrecycle  # noqa: E402
from repro.core import solvers as jsolvers  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import recycle as trecycle  # noqa: E402
from repro_torch.core import solvers as tsolvers  # noqa: E402

# ``repro.core.lsmr`` and ``repro_torch.core.lsmr`` are the functions; the
# modules by name:
jlsmr = importlib.import_module("repro.core.lsmr")
tlsmr = importlib.import_module("repro_torch.core.lsmr")

N, K, ELL, TOL = 64, 4, 8, 1e-10
M_ROWS = 96
B = 3


def _spd(seed, n=N, cond=10.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.geomspace(1.0, cond, n)) @ q.T


def _drift(a, i):
    """System i of a slowly drifting sequence."""
    return a + 0.05 * i * np.diag(np.linspace(0.0, 1.0, a.shape[0]))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    a = _spd(0)
    mats = np.stack([_drift(a, i) for i in range(3)])
    bs = rng.standard_normal((3, N))
    w0, _ = np.linalg.qr(rng.standard_normal((N, K)))
    rect = 0.3 * rng.standard_normal((3, M_ROWS, N)) / np.sqrt(M_ROWS) + np.eye(M_ROWS, N)
    brect = rng.standard_normal((3, M_ROWS))
    tenants = np.stack([_spd(10 + i) for i in range(B)])
    btenants = rng.standard_normal((B, N))
    return types.SimpleNamespace(a=a, mats=mats, bs=bs, w0=w0.T.copy(), rect=rect,
                                 brect=brect, tenants=tenants, btenants=btenants,
                                 diag=np.diag(a).copy())


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


SPEC = dict(k=K, ell=ELL, tol=TOL, maxiter=400)


@pytest.fixture(scope="module")
def ref(data):
    """Every reference door once, on the module's systems."""
    d = data
    out = {}
    A = jcore.from_matrix(_j(d.a))
    out["cg"] = jsolvers.cg_jit(A, _j(d.bs[0]), None, tol=TOL, maxiter=400,
                                M=jcore.jacobi(_j(d.diag)))
    w, aw = _j(d.w0), _j(d.w0 @ d.a)
    out["defcg"] = jsolvers.defcg_jit(A, _j(d.bs[0]), None, w, aw, ell=ELL, tol=TOL,
                                      maxiter=400)
    mgr = jcore.RecycleManager(k=K, ell=ELL, tol=TOL, maxiter=400)
    out["manager"] = [mgr.solve(jcore.from_matrix(_j(m)), _j(b)) for m, b in
                      zip(d.mats, d.bs)]
    spec, state, runs = jcore.SolveSpec(**SPEC), None, []
    for m, b in zip(d.mats, d.bs):
        res = jcore.solve_jit(jcore.from_matrix(_j(m)), _j(b), spec, state)
        state = res.state
        runs.append(res)
    out["solve"] = runs
    out["sequence"] = jrecycle.solve_sequence_jit(_j(d.mats), _j(d.bs), k=K, ell=ELL,
                                                  make_operator=jcore.from_matrix, tol=TOL,
                                                  maxiter=400)
    # The reference's door is traceable rather than jitted ("for jitted outer
    # loops"); called bare it dispatches its ops one by one (~12 s).
    recycled = jax.jit(jrecycle.recycled_solve_jit,
                       static_argnames=("k", "ell", "tol", "maxiter", "select"))
    out["recycled"] = recycled(A, _j(d.bs[1]), None, w, k=K, ell=ELL, tol=TOL, maxiter=400)
    R = jcore.from_matrix(_j(d.rect[0]))
    out["lsmr"] = jlsmr.lsmr_jit(R, _j(d.brect[0]), damp=0.1, ell=ELL, tol=TOL, maxiter=400)
    out["lsmr_seq"] = jlsmr.solve_sequence_lsmr_jit(_j(d.rect), _j(d.brect), k=K, ell=ELL,
                                                    damp=0.1, make_operator=jcore.from_matrix,
                                                    tol=TOL, maxiter=400)
    out["batch"] = jcore.solve_batch_jit(_j(d.tenants), _j(d.btenants), spec, None,
                                         make_operator=jcore.from_matrix)
    active = np.array([True, False, True])
    out["pool"] = jcore.solve_pool_step_jit(_j(d.tenants), _j(d.btenants), spec, None,
                                            _j(active), make_operator=jcore.from_matrix)
    return out


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    if t.is_floating_point():
        return t.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[t.element_size()])
    return t


def assert_bitwise(got, want, path="result"):
    """Two results of the port (tensors, tuples, NamedTuples, dataclasses)
    equal bit for bit, NaN payloads included."""
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor), path
        assert got.shape == want.shape and got.dtype == want.dtype, path
        assert torch.equal(_bits(got), _bits(want)), path
    elif dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            assert_bitwise(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, tuple):
        assert type(got) is type(want) and len(got) == len(want), path
        names = getattr(want, "_fields", range(len(want)))
        for name, g, w in zip(names, got, want):
            assert_bitwise(g, w, f"{path}.{name}")
    else:
        assert got == want, path


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_matches_reference(got, want):
    """A port result against the reference's: x to 1e-10, iterations within
    1, matvecs and statuses exactly."""
    scale = max(1.0, float(np.abs(_np(want.x)).max()))
    np.testing.assert_allclose(_np(got.x), _np(want.x), rtol=0, atol=1e-10 * scale)
    gi, wi = _np(got.info.iterations), _np(want.info.iterations)
    assert np.abs(gi.astype(int) - wi.astype(int)).max() <= 1, (gi, wi)
    np.testing.assert_array_equal(_np(got.info.matvecs), _np(want.info.matvecs))
    np.testing.assert_array_equal(_np(got.info.status), _np(want.info.status))


@pytest.fixture()
def stats():
    engine.clear_programs()
    engine.reset_graph_stats()
    return engine.GRAPHS


# ---------------------------------------------------------------------------
# The doors
# ---------------------------------------------------------------------------


def test_cg_jit(data, ref, stats):
    A = tcore.from_matrix(_t(data.a))
    M = tcore.jacobi(_t(data.diag))
    kw = dict(tol=TOL, maxiter=400, M=M, record_residuals=True)
    got = tsolvers.cg_jit(A, _t(data.bs[0]), **kw)
    assert_bitwise(got, tsolvers.cg(A, _t(data.bs[0]), **kw))
    assert_matches_reference(got, ref["cg"])
    assert stats["buffered"] > 0 and stats["captured"] == 0
    # A bare closure M is static by identity, as the reference's static-M jit.
    jac = lambda r: r / M.diag  # noqa: E731
    assert_bitwise(tsolvers.cg_jit(A, _t(data.bs[0]), tol=TOL, maxiter=400, M=jac),
                   tsolvers.cg(A, _t(data.bs[0]), tol=TOL, maxiter=400, M=jac))


def test_defcg_jit(data, ref):
    A = tcore.from_matrix(_t(data.a))
    w, aw = _t(data.w0), _t(data.w0 @ data.a)
    kw = dict(ell=ELL, tol=TOL, maxiter=400, record_residuals=True)
    got = tsolvers.defcg_jit(A, _t(data.bs[0]), None, w, aw, **kw)
    assert_bitwise(got, tsolvers.defcg(A, _t(data.bs[0]), None, w, aw, **kw))
    assert_matches_reference(got, ref["defcg"])
    m = int(got.recycle.stored)
    np.testing.assert_allclose(got.recycle.P[:m].numpy(), np.asarray(ref["defcg"].recycle.P)[:m],
                               rtol=0, atol=1e-9)


def test_recycle_manager_use_jit(data, ref, stats):
    assert tcore.RecycleManager(k=K, ell=ELL).use_jit is True
    mgrs = [tcore.RecycleManager(k=K, ell=ELL, tol=TOL, maxiter=400, use_jit=flag)
            for flag in (True, False)]
    for i, (m, b) in enumerate(zip(data.mats, data.bs)):
        got, want = (mgr.solve(tcore.from_matrix(_t(m)), _t(b)) for mgr in mgrs)
        assert_bitwise(got, want)
        assert_bitwise(mgrs[0].state, mgrs[1].state)
        assert_matches_reference(got, ref["manager"][i])
    # The cold system and the warm ones: two programs, the third system reused one.
    assert stats["built"] == 2 and stats["reused"] == 1


def test_solve_jit(data, ref):
    spec = tcore.SolveSpec(**SPEC)
    states = [None, None]
    for i, (m, b) in enumerate(zip(data.mats, data.bs)):
        A = tcore.from_matrix(_t(m))
        got = tcore.solve_jit(A, _t(b), spec, states[0])
        want = tcore.solve(A, _t(b), spec, states[1])
        assert_bitwise(got, want)
        states = [got.state, want.state]
        assert_matches_reference(got, ref["solve"][i])
        np.testing.assert_array_equal(got.report.rung.numpy(), np.asarray(ref["solve"][i].report.rung))


def test_solve_sequence_jit(data, ref):
    kw = dict(k=K, ell=ELL, make_operator=tcore.from_matrix, tol=TOL, maxiter=400)
    got = trecycle.solve_sequence_jit(_t(data.mats), _t(data.bs), **kw)
    assert_bitwise(got, trecycle.solve_sequence(_t(data.mats), _t(data.bs), **kw))
    assert_matches_reference(got, ref["sequence"])


def test_recycled_solve_jit(data, ref):
    A = tcore.from_matrix(_t(data.a))
    kw = dict(k=K, ell=ELL, tol=TOL, maxiter=400)
    w_next, x, res = tcore.recycled_solve_jit(A, _t(data.bs[1]), None, _t(data.w0), **kw)
    w_eager, x_eager, res_eager = trecycle._recycled_solve(A, _t(data.bs[1]), None,
                                                           _t(data.w0), **kw)
    assert_bitwise((w_next, x, res), (w_eager, x_eager, res_eager))
    jw, jx, jres = ref["recycled"]
    assert_matches_reference(res, jres)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-10)
    # The extracted bases span the same space.
    q1, _ = np.linalg.qr(w_next.numpy().T)
    q2, _ = np.linalg.qr(np.asarray(jw).T)
    assert np.abs(q1 @ q1.T - q2 @ q2.T).max() <= 1e-8


def test_lsmr_jit(data, ref):
    R = tcore.from_matrix(_t(data.rect[0]))
    kw = dict(damp=0.1, ell=ELL, tol=TOL, maxiter=400)
    got = tlsmr.lsmr_jit(R, _t(data.brect[0]), **kw)
    assert_bitwise(got, tlsmr.lsmr(R, _t(data.brect[0]), **kw))
    assert_matches_reference(got, ref["lsmr"])


def test_solve_sequence_lsmr_jit(data, ref):
    kw = dict(k=K, ell=ELL, damp=0.1, make_operator=tcore.from_matrix, tol=TOL, maxiter=400)
    got = tlsmr.solve_sequence_lsmr_jit(_t(data.rect), _t(data.brect), **kw)
    assert_bitwise(got, tlsmr.solve_sequence_lsmr(_t(data.rect), _t(data.brect), **kw))
    assert_matches_reference(got, ref["lsmr_seq"])


def test_solve_batch_jit(data, ref):
    spec = tcore.SolveSpec(**SPEC)
    args = (_t(data.tenants), _t(data.btenants), spec, None)
    got = tcore.solve_batch_jit(*args, make_operator=tcore.from_matrix)
    assert_bitwise(got, tcore.solve_batch(*args, make_operator=tcore.from_matrix))
    assert_matches_reference(got, ref["batch"])


def test_solve_pool_step_jit(data, ref, stats):
    spec = tcore.SolveSpec(**SPEC)
    active = torch.tensor([True, False, True])
    args = (_t(data.tenants), _t(data.btenants), spec, None, active)
    got = tcore.solve_pool_step_jit(*args, make_operator=tcore.from_matrix)
    assert_bitwise(got, tcore.solve_pool_step(*args, make_operator=tcore.from_matrix))
    assert_matches_reference(got, ref["pool"])
    # A second tick with new tenants' data replays the same program.
    built = stats["built"]
    again = tcore.solve_pool_step_jit(_t(data.tenants[::-1].copy()), _t(data.btenants), spec,
                                      got.state, active, make_operator=tcore.from_matrix)
    want = tcore.solve_pool_step(_t(data.tenants[::-1].copy()), _t(data.btenants), spec,
                                 got.state, active, make_operator=tcore.from_matrix)
    assert_bitwise(again, want)
    assert stats["built"] == built


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------


def _toy_step(c, state, active, row):
    """A masked recurrence with an in-place recording buffer: enough of a
    solver loop to hold a program's buffers against the eager loop."""
    j, v, buf = state
    v_new = torch.where(active, c["mat"] @ v * c["scale"], v)
    if row is not None:
        buf[torch.where(active, row, buf.shape[0] - 1)] = v
    return (j + active.to(j.dtype), v_new, buf)


def _toy_active(state):
    return state[0] < 21


@pytest.mark.parametrize("ell", [0, 5])
def test_buffers_match_run_recording_loop(ell, stats):
    rng = np.random.default_rng(3)
    consts = {"mat": _t(rng.standard_normal((9, 9)) / 3), "scale": 0.9}

    def state0():
        return (torch.zeros((), dtype=torch.int32), _t(rng.standard_normal(9)),
                torch.zeros(ell + 1, 9, dtype=torch.float64))

    s0 = state0()
    want = engine.run_recording_loop(_toy_step, _toy_active, tuple(t.clone() for t in s0),
                                     ell=ell, consts=consts)
    with engine.compiled():
        got = engine.run_recording_loop(_toy_step, _toy_active, s0, ell=ell, consts=consts)
    assert_bitwise(got, want)
    assert int(got[0]) == 21
    # One program: the recording phase once, then a chunk per host read.
    assert stats["built"] == 1
    assert stats["buffered"] == (ell > 0) + -(-(21 - ell) // engine.CHUNK)
    # The caller's inputs are copied, never written.
    assert torch.equal(s0[2], torch.zeros(ell + 1, 9, dtype=torch.float64))


def test_compiled_refuses_a_closure_loop():
    def step(_, state, active, row):
        return state

    with engine.compiled(), pytest.raises(RuntimeError, match="cannot run as one compiled"):
        engine.run_recording_loop(step, lambda s: s[0], (torch.tensor(True),))


def test_program_cache_follows_the_newton_sequence(data, stats):
    """A new system's ``sqrt_h`` reuses the program; a new ``kernel_matvec``
    closure builds one; a dead closure's program is evicted."""
    engine.clear_programs()
    kmat = _t(data.a)
    rng = np.random.default_rng(5)

    def make_kmv(mat):
        return lambda v: mat @ v

    kmv = make_kmv(kmat)
    for i in range(3):
        op = tcore.KernelSystemOperator(kmv, _t(rng.uniform(0.1, 0.5, N)))
        b = _t(rng.standard_normal(N))
        assert_bitwise(tsolvers.cg_jit(op, b, tol=TOL, maxiter=400),
                       tsolvers.cg(op, b, tol=TOL, maxiter=400))
    assert (stats["built"], stats["reused"]) == (1, 2)
    kmv2 = make_kmv(kmat)
    tsolvers.cg_jit(tcore.KernelSystemOperator(kmv2, _t(rng.uniform(0.1, 0.5, N))),
                    _t(rng.standard_normal(N)), tol=TOL, maxiter=400)
    assert stats["built"] == 2 and len(engine._PROGRAMS) == 2
    # The two programs share their buffers (one layout); each run copies its
    # own inputs in, so the first closure's program still gives eager bits.
    first, second = engine._PROGRAMS.values()
    assert all(a is b for a, b in zip(first.c_buf + first.s_buf, second.c_buf + second.s_buf))
    op = tcore.KernelSystemOperator(kmv, _t(rng.uniform(0.1, 0.5, N)))
    b = _t(rng.standard_normal(N))
    assert_bitwise(tsolvers.cg_jit(op, b, tol=TOL, maxiter=400),
                   tsolvers.cg(op, b, tol=TOL, maxiter=400))
    del kmv2
    assert len(engine._PROGRAMS) == 1


def test_laplace_runs_its_newton_systems_on_one_program(stats):
    from repro_torch.data import make_infinite_digits
    from repro_torch.gp import RBFKernel, laplace_gpc

    x, y = make_infinite_digits(96, seed=1, noise=0.1)
    args = (torch.as_tensor(x, dtype=torch.float64), torch.as_tensor(y, dtype=torch.float64),
            RBFKernel(3.0, 3.0))
    res = laplace_gpc(*args, solver="defcg", solver_tol=TOL, dense_matvec=True)
    eager = laplace_gpc(*args, solver="defcg", solver_tol=TOL, dense_matvec=True,
                        recycle=tcore.RecycleManager(k=8, ell=12, tol=TOL, maxiter=2000,
                                                     use_jit=False))
    assert res.trace.solver_iterations == eager.trace.solver_iterations
    assert_bitwise(res.f, eager.f)
    systems = len(res.trace.solver_iterations)
    assert systems >= 3
    # The cold first system and the warm ones: two programs for the whole
    # sequence (plus the eager run's none).
    assert stats["built"] == 2 and stats["reused"] == systems - 2


def test_host_state_operator_runs_its_loop_eagerly(data, stats):
    """``FaultInjectingOperator`` counts its products on the host: a
    compiled door runs its loop eagerly (counted), with the eager door's
    results and product count."""
    runs = []
    for door in (tsolvers.defcg_jit, tsolvers.defcg):
        op = tcore.FaultInjectingOperator(tcore.from_matrix(_t(data.a)), at_matvec=10_000)
        res = door(op, _t(data.bs[0]), None, _t(data.w0), _t(data.w0 @ data.a), ell=ELL,
                   tol=TOL, maxiter=400)
        runs.append((res, op.executed_matvecs))
    assert_bitwise(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1] > int(runs[1][0].info.iterations)
    assert stats["host_state"] == 1 and stats["built"] == 0
