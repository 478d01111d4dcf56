"""The port's multi-tenant solve service (``repro_torch.serve``) against
``tests/test_serve.py`` and the live reference.

Mirrors ``tests/test_serve.py``'s 25 tests on the port at their sizes (f64,
n ≤ 80, B ≤ 4): ``solve_pool_step``'s masking semantics, the slot pool and
the spill store (bit-for-bit round trips), ``keep_last`` retention, the
service lifecycle (evict and warm re-admission, the B = 1 fence, busy
residents never evicted, the operator-family check), a poisoned tenant
retired into its own slot, the end-to-end scenario with eviction pressure,
and the public surface.

Parity, two ways.  On the CPU a batch lane IS its sequential solve, so a
3-tenant pool equals three sequential port ``solve_sequence`` runs
exactly: iterations, matvecs and x bit for bit.  Against the reference's
own ``SolveService`` on the same numpy inputs (one module-scoped run):
status, convergence, rungs and the matvec accounting exactly, x to
``2·tol·‖b‖/λ_min``, and the iterations equal too.  ROADMAP P1 would allow
a few (def-CG at tol 1e-8 runs 47–50 iterations on these cond-1e4 systems,
past the ≈ 10 where traces part with rounding, and the port's one-system
solve differs from the reference's by up to 3 on ``test_api.py``'s
tenants), but on these nine systems both packages stop at the same step.
One more test restores, bit for bit, a state the reference's
``TenantStateStore`` spilled to disk.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax.config.update("jax_enable_x64", True)

import repro.core as jc  # noqa: E402
import repro.serve as js  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DenseMatrixOperator,
    FaultInjectingOperator,
    KernelSystemOperator,
    RecycleState,
    SolveSpec,
    SolveStatus,
    solve,
    solve_batch,
    solve_pool_step,
    solve_sequence,
)
from repro_torch.serve import (  # noqa: E402
    PoolFullError,
    Session,
    SolveService,
    StatePool,
    TenantStateStore,
)

SPEC_KW = dict(k=6, ell=10, tol=1e-8, maxiter=2000)
SPEC = SolveSpec(**SPEC_KW)
_FIELDS = ("W", "AW", "theta", "systems_solved", "drift")


def _spd_family(n=64, k=6, seed=0):
    """A base SPD matrix with a deflatable tail (test_serve's recipe)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.concatenate([np.linspace(1.0, 5.0, n - k), np.logspace(3.0, 4.0, k)])
    return (q * eigs) @ q.T


def _newton_trace(base, seed, num=3, drift=0.01):
    """A drifting sequence of (matrix, rhs) pairs for one tenant (numpy)."""
    n = base.shape[0]
    rng = np.random.default_rng(seed)
    mats, bs = [], []
    for _ in range(num):
        pert = rng.standard_normal((n, n)) * drift
        mats.append(base + pert @ pert.T)
        bs.append(rng.standard_normal(n))
    return mats, bs


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _torch_trace(seed, num):
    mats, bs = _newton_trace(BASE, seed, num)
    return [_t(m) for m in mats], [_t(b) for b in bs]


def _states_equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in _FIELDS)


def _slot(state, i):
    return RecycleState(*(getattr(state, f)[i] for f in _FIELDS))


BASE = _spd_family()


# ---------------------------------------------------------------------------
# 1. solve_pool_step masking semantics
# ---------------------------------------------------------------------------


class TestSolvePoolStep:
    def _warm_batched_state(self, mats, bs):
        """A (B, k, n) state with genuinely nonzero bases in every slot."""
        return solve_batch(torch.stack(mats), torch.stack(bs), SPEC,
                           make_operator=DenseMatrixOperator).state

    def test_inactive_state_bit_untouched(self):
        mats, bs = _torch_trace(1, 3)
        state = self._warm_batched_state(mats, bs)
        res = solve_pool_step(DenseMatrixOperator(torch.stack(mats)), torch.stack(bs), SPEC,
                              state, torch.tensor([True, False, True]))
        assert _states_equal(_slot(state, 1), _slot(res.state, 1))
        # ... including the counter: the idle slot did NOT solve a system.
        assert int(res.state.systems_solved[1]) == int(state.systems_solved[1])
        assert int(res.state.systems_solved[0]) == int(state.systems_solved[0]) + 1

    def test_inactive_diagnostics_scrubbed(self):
        mats, bs = _torch_trace(2, 3)
        state = self._warm_batched_state(mats, bs)
        res = solve_pool_step(DenseMatrixOperator(torch.stack(mats)), torch.stack(bs), SPEC,
                              state, torch.tensor([True, False, True]))
        assert int(res.info.iterations[1]) == 0
        assert int(res.info.matvecs[1]) == 0
        assert int(res.report.matvecs[1]) == 0
        assert int(res.report.rung[1]) == 0
        assert int(res.report.status[1]) == SolveStatus.CONVERGED
        assert bool(res.info.converged[1])
        assert float(res.x[1].abs().max()) == 0.0

    def test_active_slots_match_solve_batch(self):
        """With all slots active the step IS solve_batch (plus a no-op
        merge): solutions, counts and outgoing states bit for bit."""
        mats, bs = _torch_trace(3, 3)
        state = self._warm_batched_state(mats, bs)
        plain = solve_batch(DenseMatrixOperator(torch.stack(mats)), torch.stack(bs), SPEC, state)
        masked = solve_pool_step(DenseMatrixOperator(torch.stack(mats)), torch.stack(bs), SPEC,
                                 state, torch.tensor([True, True, True]))
        assert torch.equal(plain.info.iterations, masked.info.iterations)
        assert torch.equal(plain.info.matvecs, masked.info.matvecs)
        assert _states_equal(plain.state, masked.state)
        assert torch.equal(plain.x, masked.x)

    def test_rejects_plain_cg(self):
        mats, bs = _torch_trace(4, 2)
        with pytest.raises(ValueError, match="defcg"):
            solve_pool_step(DenseMatrixOperator(torch.stack(mats[:1])), torch.stack(bs[:1]),
                            SolveSpec(method="cg"), None, torch.tensor([True]))


# ---------------------------------------------------------------------------
# 2. StatePool + TenantStateStore lifecycle
# ---------------------------------------------------------------------------


def _state(k, n, seed):
    rng = np.random.default_rng(seed)
    return RecycleState(W=_t(rng.standard_normal((k, n))), AW=_t(rng.standard_normal((k, n))),
                        theta=_t(rng.standard_normal(k)),
                        systems_solved=torch.tensor(7, dtype=torch.int32),
                        drift=torch.tensor(1e-9, dtype=torch.float64))


class TestStatePool:
    def test_admit_release_zeroes_slot(self):
        pool = StatePool(2, SPEC, n=16, dtype=torch.float64, device="cpu")
        warm = RecycleState(W=torch.ones((SPEC.k, 16), dtype=torch.float64),
                            AW=2.0 * torch.ones((SPEC.k, 16), dtype=torch.float64),
                            theta=torch.ones((SPEC.k,), dtype=torch.float64),
                            systems_solved=torch.tensor(5, dtype=torch.int32),
                            drift=torch.tensor(0.25, dtype=torch.float64))
        buffers = [getattr(pool.state, f).data_ptr() for f in _FIELDS]
        slot = pool.admit("a", warm, tick=3)
        assert pool.slot_of("a") == slot
        assert _states_equal(pool.slot_state(slot), warm)
        back = pool.release("a")
        assert _states_equal(back, warm)
        # The freed slot is genuinely cold again, written in place.
        assert float(pool.slot_state(slot).W.abs().max()) == 0.0
        assert not pool.resident("a")
        assert [getattr(pool.state, f).data_ptr() for f in _FIELDS] == buffers

    def test_pool_full_and_lru(self):
        pool = StatePool(2, SPEC, n=8, dtype=torch.float64, device="cpu")
        pool.admit("a", tick=1)
        pool.admit("b", tick=2)
        with pytest.raises(PoolFullError):
            pool.admit("c", n=8)
        assert pool.lru_tenant() == "a"
        pool.touch([pool.slot_of("a")], tick=9)
        assert pool.lru_tenant() == "b"
        assert pool.lru_tenant(exclude={"b"}) == "a"
        assert pool.lru_tenant(exclude={"a", "b"}) is None

    def test_fixed_n_enforced(self):
        pool = StatePool(2, SPEC, n=8, dtype=torch.float64, device="cpu")
        with pytest.raises(ValueError, match="allocated for n=8"):
            pool.admit("a", n=16)
        # A tenant in another dtype or on another device is refused, never
        # copied across into the allocated slots.
        with pytest.raises(ValueError, match="needs its own pool"):
            pool.admit("a", n=8, dtype=torch.float32, device="cpu")
        with pytest.raises(ValueError, match="needs its own pool"):
            pool.admit("a", dataclasses.replace(_state(SPEC.k, 8, 0),
                                                W=torch.zeros(SPEC.k, 8, device="meta")))
        assert not pool.resident("a")

    def test_slot_table(self):
        pool = StatePool(2, SPEC, n=8, dtype=torch.float64, device="cpu")
        pool.admit("a", tick=4)
        table = pool.slot_table()
        assert table[0]["tenant"] == "a" and table[0]["active"]
        assert table[0]["last_served_tick"] == 4
        assert table[1]["tenant"] is None and not table[1]["active"]

    def test_store_roundtrip_bit_for_bit(self, tmp_path):
        store = TenantStateStore(str(tmp_path), keep_last=2)
        state = _state(6, 16, 0)
        assert not store.has("t")
        store.spill("t", state)
        assert store.has("t")
        back = store.restore("t", RecycleState(*(torch.zeros_like(getattr(state, f))
                                                 for f in _FIELDS)))
        assert _states_equal(state, back)

    def test_store_memory_mode(self):
        store = TenantStateStore(None)
        state = RecycleState.zeros(4, 8, dtype=torch.float64, device="cpu")
        assert store.restore("t", state) is None
        store.spill("t", state)
        assert store.has("t") and _states_equal(store.restore("t", state), state)

    def test_store_retention_gc_observable(self, tmp_path):
        store = TenantStateStore(str(tmp_path), keep_last=2)
        state = RecycleState.zeros(4, 8, dtype=torch.float64, device="cpu")
        for _ in range(5):
            store.spill("t", state)
        mgr = store._manager("t")
        assert mgr.steps() == [4, 5]
        assert mgr.deleted_total == 3
        assert mgr.last_deleted == [3]
        assert store.gc_deleted_total == 3


def test_reference_spill_restores_bit_for_bit(tmp_path):
    """A state the reference's ``TenantStateStore(directory=…)`` spilled is
    restored by the port's store, from the same directory, bit for bit."""
    rng = np.random.default_rng(5)
    W, AW, theta = rng.standard_normal((6, 16)), rng.standard_normal((6, 16)), \
        rng.standard_normal(6)
    ref = js.TenantStateStore(str(tmp_path), keep_last=2)
    for solved in (3, 4):  # two spills: the newest is restored
        ref.spill("tenant/a", jc.RecycleState(W=jnp.asarray(W * solved), AW=jnp.asarray(AW),
                                              theta=jnp.asarray(theta),
                                              systems_solved=jnp.int32(solved),
                                              drift=jnp.float64(1e-9)))
    port = TenantStateStore(str(tmp_path), keep_last=2)
    assert port.has("tenant/a")
    back = port.restore("tenant/a", RecycleState.zeros(6, 16, dtype=torch.float64,
                                                       device="cpu"))
    assert torch.equal(back.W, _t(W * 4)) and torch.equal(back.AW, _t(AW))
    assert torch.equal(back.theta, _t(theta))
    assert int(back.systems_solved) == 4 and back.systems_solved.dtype == torch.int32
    assert float(back.drift) == 1e-9


class TestCheckpointRetention:
    """keep_last retention + ``last_deleted`` observability."""

    def test_keep_last_wins_over_keep(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=10, keep_last=2)
        tree = {"x": torch.arange(3.0)}
        for step in range(1, 6):
            mgr.save(tree, step=step)
        assert mgr.steps() == [4, 5]
        assert mgr.deleted_total == 3

    def test_unbounded_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=None)
        tree = {"x": torch.arange(3.0)}
        for step in range(1, 6):
            mgr.save(tree, step=step)
        assert mgr.steps() == [1, 2, 3, 4, 5]
        assert mgr.deleted_total == 0 and mgr.last_deleted == []

    def test_invalid_keep_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="keep_last"):
            CheckpointManager(str(tmp_path), keep_last=0)


# ---------------------------------------------------------------------------
# 3. Service lifecycle + parity
# ---------------------------------------------------------------------------

PARITY_T, PARITY_NUM = 3, 3


def _parity_traces():
    return {f"t{i}": _newton_trace(BASE, seed=20 + i, num=PARITY_NUM) for i in range(PARITY_T)}


def _serve_all(service, traces, operator, conv):
    """Submit every tenant's systems in rounds, drive to idle; the results
    by tenant, in submission order."""
    tickets = {t: [] for t in traces}
    sessions = {t: service.session(t) for t in traces}
    for j in range(PARITY_NUM):
        for t, (mats, bs) in traces.items():
            tickets[t].append(sessions[t].submit(operator(conv(mats[j])), conv(bs[j])))
    served = service.run_until_idle()
    return served, {t: [service.result(tk, drive=False) for tk in tks]
                    for t, tks in tickets.items()}


@pytest.fixture(scope="module")
def reference_pool():
    """The reference's SolveService over the parity traces (one run)."""
    svc = js.SolveService(jc.SolveSpec(**SPEC_KW), slots=PARITY_T)
    _, results = _serve_all(svc, _parity_traces(), jc.DenseMatrixOperator, jnp.asarray)
    return {t: [dict(iterations=r.iterations, matvecs=r.matvecs, status=r.status, rung=r.rung,
                     converged=r.converged, x=np.asarray(r.x)) for r in rs]
            for t, rs in results.items()}


class TestServiceLifecycle:
    def test_evict_readmit_restores_state_bit_for_bit(self, tmp_path):
        svc = SolveService(SPEC, slots=2, checkpoint_dir=str(tmp_path))
        traces = {t: _torch_trace(i + 10, 2) for i, t in enumerate(("a", "b", "c"))}

        def serve_one(t, j):
            mats, bs = traces[t]
            return svc.session(t).solve(DenseMatrixOperator(mats[j]), bs[j])

        serve_one("a", 0)
        serve_one("b", 0)
        state_a = svc.pool.slot_state(svc.pool.slot_of("a"))
        serve_one("c", 0)  # pool full -> evicts LRU idle (a)
        assert not svc.pool.resident("a")
        assert svc.store.has("a")
        restored = svc.store.restore("a", svc.pool.zero_slot_state())
        assert _states_equal(state_a, restored)

        r_warm = serve_one("a", 1)  # re-admission from the spilled state
        snap = svc.metrics_snapshot()
        assert snap["tenants"]["a"]["evictions"] == 1
        assert snap["tenants"]["a"]["restores"] == 1
        assert snap["pool"]["evictions"] == 2  # a's and the one a forced
        # The restored basis is warm: far fewer iterations than c's cold
        # first system over the same drifting family.
        assert r_warm.iterations < 0.6 * snap["tenants"]["c"]["iterations"]

    def test_pool_parity_with_sequential_solve_sequence(self, reference_pool):
        """T pooled tenants == T sequential solve_sequence runs, bit for bit
        on the CPU; against the reference's pool: status, rungs, iterations
        and matvecs exactly, x within the tolerance's bound."""
        traces = _parity_traces()
        svc = SolveService(SPEC, slots=PARITY_T)
        served, results = _serve_all(svc, traces, DenseMatrixOperator, _t)
        assert served == PARITY_T * PARITY_NUM
        # Every tick batched all T tenants (no single-dispatch fallback in
        # this saturated scenario).
        assert svc.metrics.batched_steps == PARITY_NUM
        assert svc.metrics.single_steps == 0
        for t, (mats, bs) in traces.items():
            seq = solve_sequence(_t(np.stack(mats)), _t(np.stack(bs)), SPEC,
                                 make_operator=DenseMatrixOperator)
            for j, r in enumerate(results[t]):
                assert r.iterations == int(seq.info.iterations[j]), (t, j)
                assert r.matvecs == int(seq.info.matvecs[j]), (t, j)
                assert r.converged and r.status == SolveStatus.CONVERGED
                assert torch.equal(r.x, seq.x[j]), (t, j)
                want = reference_pool[t][j]
                assert (r.status, r.rung, r.converged, r.iterations, r.matvecs) == (
                    want["status"], want["rung"], want["converged"], want["iterations"],
                    want["matvecs"]), (t, j)
                lam = np.linalg.eigvalsh(mats[j])[0]
                bound = 2 * SPEC.tol * np.linalg.norm(bs[j]) / lam
                assert np.linalg.norm(r.x.numpy() - want["x"]) <= bound, (t, j)

    def test_single_tenant_uses_plain_solve_dispatch(self):
        """B = 1 fence: one active slot bypasses the batched step and must
        bit-match the plain solve front door."""
        svc = SolveService(SPEC, slots=4)
        mats, bs = _torch_trace(30, 2)
        s = svc.session("only")
        r0 = s.solve(DenseMatrixOperator(mats[0]), bs[0])
        r1 = s.solve(DenseMatrixOperator(mats[1]), bs[1])
        assert svc.metrics.single_steps == 2
        assert svc.metrics.batched_steps == 0
        state = None
        for j, r in enumerate((r0, r1)):
            ref = solve(DenseMatrixOperator(mats[j]), bs[j], SPEC, state)
            state = ref.state
            assert r.iterations == int(ref.info.iterations)
            assert r.matvecs == int(ref.info.matvecs)
            assert torch.equal(r.x, ref.x)

    def test_busy_residents_never_evicted(self):
        """With every slot holding pending work, a newcomer waits (and its
        queue_wait_ticks accrue) instead of evicting a busy tenant."""
        svc = SolveService(SPEC, slots=2)
        traces = {t: _torch_trace(40 + i, 2) for i, t in enumerate(("a", "b", "c"))}
        tickets = []
        for t, (mats, bs) in traces.items():
            s = svc.session(t)
            for m, b in zip(mats, bs):
                tickets.append(s.submit(DenseMatrixOperator(m), b))
        svc.run_until_idle()
        results = [svc.result(tk, drive=False) for tk in tickets]
        assert all(r.converged for r in results)
        snap = svc.metrics_snapshot()
        # c could only be admitted after a or b drained (2 ticks each).
        assert snap["tenants"]["c"]["queue_wait_ticks"] > 0
        assert snap["pool"]["queue_depth_peak"] == 6

    def test_close_with_pending_refuses(self):
        svc = SolveService(SPEC, slots=2)
        mats, bs = _torch_trace(50, 1)
        s = svc.session("a")
        s.submit(DenseMatrixOperator(mats[0]), bs[0])
        with pytest.raises(RuntimeError, match="unserved"):
            s.close()
        s.result()
        s.close()
        with pytest.raises(RuntimeError, match="closed"):
            s.submit(DenseMatrixOperator(mats[0]), bs[0])

    def test_mixed_operator_family_rejected(self):
        svc = SolveService(SPEC, slots=2)
        mats, bs = _torch_trace(60, 2)
        sa, sb = svc.session("a"), svc.session("b")
        sa.submit(DenseMatrixOperator(mats[0]), bs[0])
        sb.submit(FaultInjectingOperator(DenseMatrixOperator(mats[1]), 0.0), bs[1])
        with pytest.raises(ValueError, match="operator family"):
            svc.tick()

    def test_service_requires_defcg(self):
        with pytest.raises(ValueError, match="defcg"):
            SolveService(SolveSpec(method="cg"))


# ---------------------------------------------------------------------------
# 4. Fault isolation under the pool
# ---------------------------------------------------------------------------


class TestPoisonedTenantIsolation:
    def test_neighbours_unharmed_and_tenant_recovers(self):
        svc = SolveService(SPEC, slots=3)
        traces = {t: _torch_trace(70 + i, 2) for i, t in enumerate(("good1", "bad", "good2"))}
        sessions = {t: svc.session(t) for t in traces}
        tickets = {}
        for t, (mats, bs) in traces.items():
            poison = float("nan") if t == "bad" else 0.0
            tickets[t] = sessions[t].submit(
                FaultInjectingOperator(DenseMatrixOperator(mats[0]), poison), bs[0])
        svc.run_until_idle()
        r_bad = svc.result(tickets["bad"], drive=False)
        assert r_bad.status >= SolveStatus.BREAKDOWN_NONFINITE
        assert not r_bad.converged
        assert torch.isfinite(r_bad.x).all()  # retired, not NaN
        for t in ("good1", "good2"):
            r = svc.result(tickets[t], drive=False)
            assert r.converged and r.status == SolveStatus.CONVERGED
            mats, bs = traces[t]
            assert float(torch.linalg.norm(mats[0] @ r.x - bs[0])) <= 1e-6 * float(
                torch.linalg.norm(bs[0]))
        # The poisoned slot's outgoing basis was zeroed by retirement, so the
        # tenant's next HEALTHY request bootstraps cold and converges.
        mats, bs = traces["bad"]
        r_next = sessions["bad"].solve(
            FaultInjectingOperator(DenseMatrixOperator(mats[1]), 0.0), bs[1])
        assert r_next.converged
        snap = svc.metrics_snapshot()
        assert snap["tenants"]["bad"]["breakdowns"] == 1
        assert snap["tenants"]["good1"]["breakdowns"] == 0


# ---------------------------------------------------------------------------
# 5. End-to-end scenario (GP Newton shape, eviction pressure)
# ---------------------------------------------------------------------------


class TestEndToEndScenario:
    def test_async_arrivals_departures_eviction_and_warm_resume(self, tmp_path):
        """Tenants arrive and depart asynchronously over drifting GP Newton
        sequences (A = I + H½KH½, one shared K), the pool smaller than the
        tenant population; evicted-then-readmitted tenants resume warm, and
        reports and metrics come back for everyone."""
        n, slots = 80, 2
        rng = np.random.default_rng(99)
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        kmat = _t((q * np.logspace(1.5, -2, n)) @ q.T)  # PSD "gram"

        def k_mv(v):  # one stable kernel closure for every tenant
            return kmat @ v

        def tenant_systems(i, num):
            r = np.random.default_rng(200 + i)
            f = r.standard_normal(n) * 0.5
            out = []
            for _ in range(num):
                pi = 1.0 / (1.0 + np.exp(-f))
                out.append((KernelSystemOperator(k_mv, _t(np.sqrt(pi * (1 - pi)))),
                            _t(r.standard_normal(n))))
                f = f + 0.05 * r.standard_normal(n)
            return out

        spec = SolveSpec(k=6, ell=10, tol=1e-7, maxiter=1000)
        svc = SolveService(spec, slots=slots, checkpoint_dir=str(tmp_path))

        # Phase 1: tenants 0 / 1 each serve two systems, then DEPART
        # (sessions close, warm bases spill).
        first_iters = {}
        for i in (0, 1):
            with svc.session(f"u{i}") as s:
                sys_i = tenant_systems(i, 2)
                r0 = s.solve(*sys_i[0])
                r1 = s.solve(*sys_i[1])
                first_iters[i] = (r0.iterations, r1.iterations)
                assert r0.converged and r1.converged
                assert r1.iterations < r0.iterations  # recycling works
        assert svc.pool.occupancy == 0

        # Phase 2: three NEW tenants churn through the 2-slot pool.
        sessions = {i: svc.session(f"u{i}") for i in (2, 3, 4)}
        tickets = {i: [] for i in (2, 3, 4)}
        systems = {i: tenant_systems(i, 2) for i in (2, 3, 4)}
        for j in range(2):
            for i in (2, 3, 4):
                tickets[i].append(sessions[i].submit(*systems[i][j]))
            svc.tick()
        svc.run_until_idle()
        for i in (2, 3, 4):
            for tk in tickets[i]:
                assert svc.result(tk, drive=False).converged

        # Phase 3: tenant 0 RETURNS (spilled to disk at close).  Its restored
        # basis must beat the cold starts of the phase-2 tenants.
        with svc.session("u0") as s0:
            r_back = s0.solve(*tenant_systems(0, 3)[2])
        assert r_back.converged
        snap = svc.metrics_snapshot()
        assert snap["tenants"]["u0"]["restores"] == 1
        cold_iters = [svc.metrics.tenants[f"u{i}"].iterations for i in (2, 3, 4)]
        assert r_back.iterations < first_iters[0][0]
        assert all(r_back.iterations < c for c in cold_iters)

        # Telemetry contract: one plain-dict snapshot, json-serializable.
        payload = json.dumps(snap)
        assert "u0" in payload and snap["pool"]["slots"] == slots
        assert snap["pool"]["served_total"] == 11
        assert snap["pool"]["evictions"] >= 2
        assert 0.0 < snap["pool"]["mean_occupancy"] <= 1.0


# ---------------------------------------------------------------------------
# Public surface
# ---------------------------------------------------------------------------


def test_serve_all_resolves():
    import repro_torch
    import repro_torch.serve as serve

    for name in serve.__all__:
        assert getattr(serve, name) is not None, name
    assert serve.Session is Session
    assert "serve" in repro_torch.__all__
    assert set(serve.__all__) == set(js.__all__)


def test_served_result_is_frozen():
    from repro_torch.serve.scheduler import ServedResult

    fields = {f.name for f in dataclasses.fields(ServedResult)}
    assert {"x", "iterations", "matvecs", "report", "tick", "queue_wait_ticks"} <= fields
    assert ServedResult.__dataclass_params__.frozen
