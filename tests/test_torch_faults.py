"""The port's failure handling against the live JAX reference.

Mirrors ``tests/test_faults.py`` case for case: the same numpy inputs go
through ``repro`` and ``repro_torch`` on the CPU.  Where both packages
compute the same quantity the port is held to the reference's
iterations, ``SolveInfo.matvecs`` (exactly), ``report.rung``,
``report.status`` and x to 1e-10; each test also keeps the reference
test's own claims.  The checkpoint and fault-operator units have no
reference counterpart to run (they are host code), so they hold the
port to the reference test's claims alone.
"""

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager,
    restore_pytree,
    save_pytree,
)
from repro_torch.checkpoint import manager as manager_mod  # noqa: E402
from tests.conftest import make_spd  # noqa: E402


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _spd(n=32, cond=1e2, seed=0):
    rng = np.random.default_rng(seed)
    mat, _, _ = make_spd(n, cond, rng)
    return mat, rng.standard_normal(n)


def _drifting_sequence(n=40, num=5, seed=0):
    rng = np.random.default_rng(seed)
    base, _, _ = make_spd(n, 1e2, rng)
    mats = np.stack([base + (1.0 + 0.05 * i) * np.eye(n) for i in range(num)])
    return mats, rng.standard_normal((num, n))


SPEC_KW = dict(k=4, ell=8, tol=1e-8, maxiter=400)
SPEC = tc.SolveSpec(**SPEC_KW)
J_SPEC = jc.SolveSpec(**SPEC_KW)


def _assert_same(ref, got, x_atol=1e-10):
    """Iterations, matvecs, rung, status and x: the port against the
    reference."""
    for field in ("iterations", "matvecs", "converged"):
        np.testing.assert_array_equal(_np(getattr(got.info, field)),
                                      np.asarray(getattr(ref.info, field)), err_msg=field)
    np.testing.assert_array_equal(_np(got.report.rung), np.asarray(ref.report.rung))
    np.testing.assert_array_equal(_np(got.report.status), np.asarray(ref.report.status))
    np.testing.assert_array_equal(_np(got.report.matvecs), np.asarray(ref.report.matvecs))
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=x_atol)


class TestBreakdownAndLadder:
    def test_transient_nan_matvec_recovers(self):
        """A NaN on one executed product mid-solve: the ladder re-solves
        and converges, with the failed attempt charged."""
        mat, b = _spd()
        clean = tc.solve(tc.from_matrix(_t(mat)), _t(b), SPEC)
        assert int(clean.report.status) == tc.SolveStatus.CONVERGED
        assert int(clean.report.rung) == 0

        op = tc.FaultInjectingOperator(tc.from_matrix(_t(mat)), at_matvec=3)
        res = tc.solve(op, _t(b), SPEC)
        ref = jc.solve(jc.FaultInjectingOperator(jc.from_matrix(jnp.asarray(mat)), at_matvec=3),
                       jnp.asarray(b), J_SPEC)
        _assert_same(ref, res)
        assert bool(res.info.converged)
        assert int(res.report.status) == tc.SolveStatus.CONVERGED
        assert int(res.report.rung) >= 1
        assert int(res.report.matvecs) > int(clean.report.matvecs)
        np.testing.assert_allclose(_np(res.x), np.linalg.solve(mat, b), rtol=1e-5, atol=1e-7)

    def test_persistent_corruption_retires_finitely(self):
        """Every product poisoned: the whole ladder fails, yet the front
        door returns finite coordinates, a truthful status and a zeroed
        (retired) state."""
        mat, b = _spd(seed=1)
        res = tc.solve(tc.FaultInjectingOperator(tc.from_matrix(_t(mat)), poison=float("nan")),
                       _t(b), SPEC)
        ref = jc.solve(jc.FaultInjectingOperator(jc.from_matrix(jnp.asarray(mat)),
                                                 poison=jnp.nan), jnp.asarray(b), J_SPEC)
        _assert_same(ref, res)
        assert not bool(res.info.converged)
        assert int(res.report.status) == tc.SolveStatus.BREAKDOWN_NONFINITE
        assert int(res.report.rung) == 3
        assert bool(torch.all(torch.isfinite(res.x)))
        assert bool(torch.all(res.state.W == 0)) and bool(torch.all(res.state.AW == 0))

    def test_indefinite_operator_is_classified(self):
        """pᵀAp < 0 reads BREAKDOWN_INDEFINITE, not MAXITER."""
        n = 16
        diag = np.ones(n)
        diag[-1] = -1.0
        b = np.zeros(n)
        b[-1] = 1.0
        res = tc.solve(tc.from_matrix(_t(np.diag(diag))), _t(b),
                       tc.SolveSpec(method="cg", tol=1e-10, maxiter=50))
        ref = jc.solve(jc.from_matrix(jnp.asarray(np.diag(diag))), jnp.asarray(b),
                       jc.SolveSpec(method="cg", tol=1e-10, maxiter=50))
        _assert_same(ref, res)
        assert not bool(res.info.converged)
        assert int(res.report.status) == tc.SolveStatus.BREAKDOWN_INDEFINITE
        assert tc.SolveStatus.describe(res.report.status) == "BREAKDOWN_INDEFINITE"

    def test_stagnation_detector_stops_early(self):
        """A bounded perturbation floors the residual; the armed detector
        stops with STAGNATED on the reference's step."""
        mat, b = _spd(seed=2)
        kw = dict(method="cg", tol=1e-12, maxiter=400, stagnation_window=10, recovery_rungs=0)
        res = tc.solve(tc.FaultInjectingOperator(tc.from_matrix(_t(mat)), poison=1e-3), _t(b),
                       tc.SolveSpec(**kw))
        ref = jc.solve(jc.FaultInjectingOperator(jc.from_matrix(jnp.asarray(mat)), poison=1e-3),
                       jnp.asarray(b), jc.SolveSpec(**kw))
        _assert_same(ref, res)
        assert int(res.report.status) == tc.SolveStatus.STAGNATED
        assert int(res.info.iterations) < 400

    def test_sequence_broken_system_is_isolated(self):
        """One persistently broken system in a sequence: retired with a
        truthful status while its neighbours, before and after, converge
        (the poison does not travel through the recycled basis)."""
        mats, bs = _drifting_sequence()
        poison = np.zeros(mats.shape[0])
        poison[2] = np.nan
        res = tc.solve_sequence(
            {"mat": _t(mats), "poison": _t(poison)}, _t(bs), SPEC,
            make_operator=lambda s: tc.FaultInjectingOperator(tc.from_matrix(s["mat"]),
                                                              s["poison"]))
        ref = jc.solve_sequence(
            {"mat": jnp.asarray(mats), "poison": jnp.asarray(poison)}, jnp.asarray(bs), J_SPEC,
            make_operator=lambda s: jc.FaultInjectingOperator(jc.from_matrix(s["mat"]),
                                                              s["poison"]))
        _assert_same(ref, res)
        conv, status = _np(res.info.converged), _np(res.report.status)
        assert not conv[2]
        assert status[2] == tc.SolveStatus.BREAKDOWN_NONFINITE
        assert int(res.report.rung[2]) == 3
        healthy = [0, 1, 3, 4]
        assert conv[healthy].all()
        assert (status[healthy] == tc.SolveStatus.CONVERGED).all()
        assert bool(torch.all(torch.isfinite(res.x)))
        mv, it = _np(res.report.matvecs), _np(res.info.iterations)
        assert mv[2] >= it[2] + 2

    def test_clean_path_pays_nothing(self):
        """Arming the ladder changes nothing on a healthy sequence: the
        same iterates, the same matvecs, rung 0 everywhere."""
        mats, bs = _drifting_sequence(seed=3)

        def mk(s):
            return tc.from_matrix(s["mat"])

        armed = tc.solve_sequence({"mat": _t(mats)}, _t(bs), SPEC, make_operator=mk)
        disarmed = tc.solve_sequence({"mat": _t(mats)}, _t(bs), SPEC, make_operator=mk,
                                     divergence_fallback=False)
        ref = jc.solve_sequence({"mat": jnp.asarray(mats)}, jnp.asarray(bs), J_SPEC,
                                make_operator=lambda s: jc.from_matrix(s["mat"]))
        _assert_same(ref, armed)
        np.testing.assert_array_equal(_np(armed.info.iterations), _np(disarmed.info.iterations))
        np.testing.assert_array_equal(_np(armed.info.matvecs), _np(disarmed.info.matvecs))
        assert (_np(armed.report.rung) == 0).all()
        assert torch.equal(armed.x, disarmed.x)


class _DyingManager(CheckpointManager):
    """Raises KeyboardInterrupt (a simulated preemption) after N saves."""

    def __init__(self, directory, die_after):
        super().__init__(directory)
        self.saves = 0
        self.die_after = die_after

    def save(self, tree, step, **kw):
        super().save(tree, step, **kw)
        self.saves += 1
        if self.saves >= self.die_after:
            raise KeyboardInterrupt("simulated preemption")


def _seq(pkg, conv, mgr=None, resume=False, method="defcg"):
    """The drifting sequence through ``solve_sequence`` (deflsmr: the same
    matrices as least-squares operators)."""
    mats, bs = _drifting_sequence()
    spec = pkg.SolveSpec(method=method, **SPEC_KW)
    make = pkg.DenseMatrixOperator if method == "deflsmr" else pkg.from_matrix
    return pkg.solve_sequence(
        {"mat": conv(mats)}, conv(bs), spec,
        make_operator=lambda s: make(s["mat"]),
        checkpoint=mgr, checkpoint_every=2 if mgr is not None else 0, resume=resume,
    )


def _assert_identical(a, b):
    """Two port runs: the same iterates bit for bit."""
    assert torch.equal(a.x, b.x)
    np.testing.assert_array_equal(_np(a.info.iterations), _np(b.info.iterations))
    np.testing.assert_array_equal(_np(a.info.matvecs), _np(b.info.matvecs))
    np.testing.assert_array_equal(_np(a.report.status), _np(b.report.status))
    assert torch.equal(a.state.W, b.state.W)


class TestResumableSequences:
    @pytest.mark.parametrize("method", ["defcg", "deflsmr"])
    def test_chunked_matches_unchunked(self, tmp_path, method):
        whole = _seq(tc, _t, method=method)
        chunked = _seq(tc, _t, CheckpointManager(str(tmp_path)), method=method)
        _assert_identical(chunked, whole)
        ref = _seq(jc, jnp.asarray, JCheckpointManager(str(tmp_path / "ref")), method=method)
        it, it_ref = _np(chunked.info.iterations), np.asarray(ref.info.iterations)
        if method == "defcg":
            np.testing.assert_array_equal(it, it_ref)
            np.testing.assert_array_equal(_np(chunked.info.matvecs), np.asarray(ref.info.matvecs))
            np.testing.assert_allclose(_np(chunked.x), np.asarray(ref.x), atol=1e-10)
        else:
            # LSMR on these systems (normal equations at cond 1e4) moves
            # with rounding past ~12 iterations: ROADMAP P5's bars (counts
            # within 8 a system, two products an iteration, x to 1e-5).
            assert np.all(np.abs(it - it_ref) <= 8), (it, it_ref)
            np.testing.assert_array_equal(_np(chunked.info.matvecs) - np.asarray(ref.info.matvecs),
                                          2 * (it - it_ref))
            xr = np.asarray(ref.x)
            err = np.linalg.norm(_np(chunked.x) - xr, axis=1) / np.linalg.norm(xr, axis=1)
            assert np.max(err) < 1e-5

    @pytest.mark.parametrize("method", ["defcg", "deflsmr"])
    def test_kill_and_resume_reproduces_iterates(self, tmp_path, method):
        """Killed after the first chunk's checkpoint, resumed with a fresh
        manager: bit for bit the uninterrupted run."""
        whole = _seq(tc, _t, CheckpointManager(str(tmp_path / "ref")), method=method)
        with pytest.raises(KeyboardInterrupt):
            _seq(tc, _t, _DyingManager(str(tmp_path / "ckpt"), die_after=1), method=method)
        resumed = _seq(tc, _t, CheckpointManager(str(tmp_path / "ckpt")), resume=True,
                       method=method)
        _assert_identical(resumed, whole)

    def test_resume_past_truncated_checkpoint(self, tmp_path):
        """A torn checkpoint (manifest intact, payload garbage) is skipped
        with a recorded reason, and the run still completes."""
        with pytest.raises(KeyboardInterrupt):
            _seq(tc, _t, _DyingManager(str(tmp_path), die_after=2))
        step = tc.truncate_latest_checkpoint(str(tmp_path))
        assert step is not None
        fresh = CheckpointManager(str(tmp_path))
        resumed = _seq(tc, _t, fresh, resume=True)
        _assert_identical(resumed, _seq(tc, _t))
        assert fresh.last_skipped
        assert fresh.last_skipped[0][0] == step


class TestCheckpointSatellites:
    def test_schema_migration_defaults_grown_leaf(self, tmp_path):
        """A template that grew a field since the checkpoint was written
        restores with a warning instead of being rejected."""
        save_pytree({"w": torch.arange(4.0, dtype=torch.float64)}, str(tmp_path), step=0)
        template = {"w": torch.zeros(4, dtype=torch.float64),
                    "drift": torch.tensor(7.5, dtype=torch.float64)}
        with pytest.warns(UserWarning, match="schema migration"):
            out = restore_pytree(template, str(tmp_path / "step_00000000"))
        np.testing.assert_array_equal(_np(out["w"]), np.arange(4.0))
        assert float(out["drift"]) == 7.5

    def test_unknown_checkpoint_leaf_still_rejected(self, tmp_path):
        """A checkpoint leaf with no home in the template is an error."""
        save_pytree({"w": torch.zeros(3), "extra": torch.ones(2)}, str(tmp_path), step=0)
        with pytest.raises(ValueError, match="no home"):
            restore_pytree({"w": torch.zeros(3)}, str(tmp_path / "step_00000000"))

    def test_async_save_error_reraises(self, tmp_path, monkeypatch):
        """A failed background write surfaces on the next wait(), once."""
        mgr = CheckpointManager(str(tmp_path))

        def boom(*a, **k):
            raise OSError("disk full")

        monkeypatch.setattr(manager_mod, "save_pytree", boom)
        mgr.save({"w": torch.zeros(2)}, step=0, blocking=False)
        with pytest.raises(RuntimeError, match="NOT committed"):
            mgr.wait()
        mgr.wait()

    def test_resume_kwargs_need_checkpoint(self, tmp_path):
        mats, bs = _drifting_sequence(num=2)

        def run(**kw):
            return tc.solve_sequence({"mat": _t(mats)}, _t(bs), SPEC,
                                     make_operator=lambda s: tc.from_matrix(s["mat"]), **kw)

        with pytest.raises(ValueError, match="CheckpointManager"):
            run(checkpoint_every=2)
        with pytest.raises(ValueError, match="CheckpointManager"):
            run(resume=True)
        with pytest.raises(ValueError, match="checkpoint_every >= 1"):
            run(checkpoint=CheckpointManager(str(tmp_path)))


class TestFaultOperatorUnit:
    def test_poison_arithmetic(self):
        mat, _ = _spd(n=8)
        v = torch.ones(8, dtype=torch.float64)
        op = tc.FaultInjectingOperator(tc.from_matrix(_t(mat)), poison=0.5)
        np.testing.assert_allclose(_np(op(v)), mat @ np.ones(8) + 0.5, rtol=1e-12)

    def test_poison_is_a_tensor_sliced_with_systems(self):
        """The reference's poison is a traced leaf that scans with the
        systems; the port's is a per-system tensor entry, sliced by
        ``system_at`` with the rest of the system."""
        from repro_torch.core.recycle import system_at

        mats, _ = _drifting_sequence(n=8, num=3)
        poison = torch.tensor([0.0, float("nan"), 0.0], dtype=torch.float64)
        systems = {"mat": _t(mats), "poison": poison}
        v = torch.ones(8, dtype=torch.float64)
        outs = []
        for i in range(3):
            s = system_at(systems, i)
            assert s["poison"].shape == ()
            outs.append(tc.FaultInjectingOperator(tc.from_matrix(s["mat"]), s["poison"])(v))
        assert [bool(torch.all(torch.isfinite(o))) for o in outs] == [True, False, True]
        assert system_at(systems, slice(1, 3))["poison"].shape == (2,)

    def test_host_counter_counts(self):
        mat, _ = _spd(n=8)
        op = tc.FaultInjectingOperator(tc.from_matrix(_t(mat)), at_matvec=1)
        v = torch.ones(8, dtype=torch.float64)
        out0, out1, out2 = op(v), op(v), op(v)  # the second is poisoned
        assert op.executed_matvecs == 3
        assert bool(torch.all(torch.isfinite(out0)))
        assert not bool(torch.all(torch.isfinite(out1)))
        assert bool(torch.all(torch.isfinite(out2)))
        op.reset()
        assert op.executed_matvecs == 0
