"""Host-side continuous-batching scheduler over the slot pool (the
counterpart of ``repro.serve.scheduler``).

One :class:`SolveService` = one admission queue + one :class:`StatePool`
+ one :class:`TenantStateStore` + one :class:`ServeMetrics` registry.
The event loop is synchronous and deterministic — a *tick* is one call to
:meth:`SolveService.tick`:

1. **Admit**: waiting tenants (pending work, not resident) bind to free
   slots in arrival order.  When no slot is free, the least-recently-
   served *idle* resident (no pending request) is evicted — its
   ``RecycleState`` spills through the store so its warm basis survives
   — and the newcomer takes the slot.  Busy residents are never evicted,
   so admitted work always completes.  A tenant that was evicted earlier
   re-admits from its spilled state (bit for bit), not cold.
2. **Serve**: every resident tenant with pending work contributes its
   next request.  With two or more active slots the whole pool runs ONE
   :func:`repro_torch.core.solve_pool_step_jit` (idle and empty slots
   masked inactive — zero rhs, state passed through untouched; the lane
   axis of the step kernels carries every slot); with exactly one active
   slot the scheduler gathers that slot and dispatches through
   :func:`repro_torch.core.solve_jit` instead (the reference's B = 1
   fence, counted in ``metrics.single_steps``).  Both are the compiled
   doors, as in the reference: on the card the pool's loop is captured
   once a shape and every later tick replays it.
3. **Scatter**: per-tenant solutions and masked
   :class:`repro_torch.core.SolveReport` diagnostics land in the ticket
   table (:meth:`result` collects them), slot last-served ticks and the
   metrics registry update.  The step's per-slot diagnostics are read to
   the host ONCE a tick (one copy), never slot by slot.

Nothing here runs on a background thread: "continuous batching" is a
property of the admission/eviction policy, not of concurrency — drive the
loop with ``tick()`` / ``run_until_idle()`` / ``result(drive=True)`` and
every run is exactly reproducible.

Batching contract: all tenants of one service share one operator family
— the same operator type and the same shared data (one ``kernel_matvec``
for every tenant of a shared-kernel GP service; one ``x`` and the same
hyperparameters for the matrix-free RBF operator), so that one tick's
operators stack into one batched product.  It is checked per tick with a
targeted ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, Optional, Tuple

import torch

from repro_torch.core import (
    KernelSystemOperator,
    RBFKernelSystemOperator,
    SolveReport,
    SolveSpec,
    solve_jit,
    solve_pool_step_jit,
)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.pool import PoolFullError, StatePool, TenantStateStore

# The per-slot diagnostics read to the host once a tick, in this order.
_DIAGNOSTICS = ("iterations", "matvecs", "converged", "residual_norm", "status", "rung",
                "guard_firings")


@dataclasses.dataclass(frozen=True)
class Ticket:
    """Claim check for one submitted system (tenant key + sequence no)."""

    tenant: str
    seq: int


@dataclasses.dataclass(frozen=True)
class ServedResult:
    """What a ticket redeems for: solution + per-tenant diagnostics."""

    tenant: str
    seq: int
    x: torch.Tensor
    iterations: int
    matvecs: int
    converged: bool
    residual_norm: float
    status: int
    rung: int
    guard_firings: int
    tick: int
    queue_wait_ticks: int
    report: SolveReport

    @property
    def ok(self) -> bool:
        return self.converged and self.status == 0


@dataclasses.dataclass
class _Request:
    ticket: Ticket
    A: Any
    b: torch.Tensor
    submitted_tick: int


def _same_family(a, b) -> bool:
    """Whether two tenants' operators stack into one batched product: the
    same type, and the same shared data where the type has any."""
    if type(a) is not type(b):
        return False
    if isinstance(a, RBFKernelSystemOperator):
        return a.x is b.x and (a.theta, a.lengthscale, a.block, a.backend) == (
            b.theta, b.lengthscale, b.block, b.backend)
    if isinstance(a, KernelSystemOperator):
        return a.kernel_matvec is b.kernel_matvec
    return True


def _host_diagnostics(info, report):
    """The step's per-slot diagnostics as host lists, ONE device read."""
    rows = [info.iterations, info.matvecs, info.converged, info.residual_norm, info.status,
            report.rung, report.guard_firings]
    it = torch.as_tensor(info.iterations)
    stacked = torch.stack([torch.as_tensor(r).to(it.device, torch.float64).expand(it.shape)
                           for r in rows])
    return dict(zip(_DIAGNOSTICS, stacked.cpu().reshape(len(rows), -1).tolist()))


class SolveService:
    """Multi-tenant solve service: submit systems, drive ticks, redeem
    tickets.  See the module docstring for the tick protocol.

    Args:
      spec: the one :class:`SolveSpec` every tenant is served under
        (``method='defcg'`` — the pool carries recycle state).
      slots: pool size B (slots, not tenants — tenants beyond B rotate
        through eviction).
      checkpoint_dir: where evicted tenants' states spill.  ``None`` keeps
        host copies (non-durable); a directory spills through
        :class:`repro_torch.checkpoint.CheckpointManager` with
        ``keep_last`` retention per tenant key.
      keep_last: spilled-checkpoint retention budget per tenant.
      max_drive_ticks: safety bound for ``result(drive=True)`` /
        ``run_until_idle`` loops.
    """

    def __init__(self, spec: Optional[SolveSpec] = None, *, slots: int = 8,
                 checkpoint_dir: Optional[str] = None, keep_last: int = 4,
                 max_drive_ticks: int = 100_000):
        spec = SolveSpec() if spec is None else spec
        if spec.method != "defcg":
            raise ValueError(
                "SolveService carries per-tenant RecycleState — it needs "
                f"spec.method='defcg', got {spec.method!r}"
            )
        self.spec = spec
        self.pool = StatePool(slots, spec)
        self.store = TenantStateStore(checkpoint_dir, keep_last=keep_last)
        self.metrics = ServeMetrics(slots=slots)
        self.max_drive_ticks = max_drive_ticks
        self.tick_count = 0
        # Tenant -> FIFO of unserved requests; OrderedDict so admission
        # considers waiting tenants in arrival order (first submit wins).
        self._pending: "OrderedDict[str, Deque[_Request]]" = OrderedDict()
        self._results: Dict[Tuple[str, int], ServedResult] = {}
        self._seq: Dict[str, int] = {}

    # -- tenant-facing API -------------------------------------------------
    def session(self, tenant: str):
        """A :class:`repro_torch.serve.Session` handle bound to ``tenant``."""
        from repro_torch.serve.session import Session

        return Session(self, tenant)

    def submit(self, tenant: str, A: Any, b: torch.Tensor) -> Ticket:
        """Enqueue one system for ``tenant``; returns its ticket."""
        tenant = str(tenant)
        seq = self._seq.get(tenant, 0)
        self._seq[tenant] = seq + 1
        ticket = Ticket(tenant=tenant, seq=seq)
        if tenant not in self._pending:
            self._pending[tenant] = deque()
        self._pending[tenant].append(
            _Request(ticket=ticket, A=A, b=b, submitted_tick=self.tick_count))
        self.metrics.tenant(tenant).submitted += 1
        return ticket

    def poll(self, ticket: Ticket) -> Optional[ServedResult]:
        """The ticket's result if served, else None (does not tick)."""
        return self._results.get((ticket.tenant, ticket.seq))

    def result(self, ticket: Ticket, *, drive: bool = True) -> ServedResult:
        """Redeem a ticket, driving ticks until it resolves.

        With ``drive=False`` the ticket must already be served (KeyError
        otherwise) — the mode for an external loop that owns ticking.
        """
        key = (ticket.tenant, ticket.seq)
        if key in self._results:
            return self._results.pop(key)
        if not drive:
            raise KeyError(f"ticket {ticket} not served yet (drive=False does not tick)")
        for _ in range(self.max_drive_ticks):
            self.tick()
            if key in self._results:
                return self._results.pop(key)
        raise RuntimeError(
            f"ticket {ticket} unresolved after {self.max_drive_ticks} ticks "
            "— was it submitted to this service?"
        )

    def close(self, tenant: str, *, spill: bool = True) -> None:
        """Depart: free the tenant's slot (spilling its warm state so a
        later session can resume) and forget its empty queue.

        Refuses to close a tenant with unserved requests — drain or redeem
        them first (dropping queued work silently would turn a scheduling
        bug into a hang at ``result``).
        """
        tenant = str(tenant)
        q = self._pending.get(tenant)
        if q:
            raise RuntimeError(
                f"tenant {tenant!r} still has {len(q)} unserved request(s) "
                "— drive them to completion before close()"
            )
        self._pending.pop(tenant, None)
        if self.pool.resident(tenant):
            state = self.pool.release(tenant)
            if spill:
                self.store.spill(tenant, state)

    # -- the event loop ----------------------------------------------------
    def run_until_idle(self) -> int:
        """Tick until no request is pending; returns systems served."""
        served = 0
        for _ in range(self.max_drive_ticks):
            if not any(self._pending.values()):
                return served
            served += self.tick()
        raise RuntimeError(f"work still pending after {self.max_drive_ticks} ticks")

    def tick(self) -> int:
        """One scheduler step: admit, serve, scatter.  Returns the number of
        systems served this tick (0 = idle tick)."""
        self.tick_count += 1
        tick = self.tick_count
        self._admit(tick)

        serving = []  # (slot, request)
        for tenant, q in self._pending.items():
            if not q:
                continue
            slot = self.pool.slot_of(tenant)
            if slot is not None:
                serving.append((slot, q.popleft()))
        self.metrics.record_tick(self.pool.occupancy, len(serving))
        self.metrics.record_queue_depth(
            sum(len(q) for q in self._pending.values()) + len(serving))
        if not serving:
            return 0

        if len(serving) == 1:
            # The B = 1 fence: one active slot runs the plain front door on
            # its gathered state.
            slot, req = serving[0]
            res = solve_jit(req.A, req.b, self.spec, self.pool.slot_state(slot))
            self.pool.write_slot(slot, res.state)
            self.metrics.single_steps += 1
            host = _host_diagnostics(res.info, res.report)
            self._scatter(req, res.x, {k: v[0] for k, v in host.items()}, tick)
        else:
            systems, b_batch, active = self._build_batch(serving)
            res = solve_pool_step_jit(systems, b_batch, self.spec, self.pool.state, active)
            self.pool.write_all(res.state)
            self.metrics.batched_steps += 1
            host = _host_diagnostics(res.info, res.report)
            for slot, req in serving:
                self._scatter(req, res.x[slot], {k: v[slot] for k, v in host.items()}, tick)
        self.pool.touch([slot for slot, _ in serving], tick)
        return len(serving)

    # -- internals ---------------------------------------------------------
    def _admit(self, tick: int) -> None:
        for tenant in list(self._pending):
            if not self._pending[tenant] or self.pool.resident(tenant):
                continue
            busy = {t for t, q in self._pending.items() if q}
            if not self.pool.free_slots():
                victim = self.pool.lru_tenant(exclude=busy)
                if victim is None:
                    # Every resident has pending work; the newcomer waits
                    # (queue_wait_ticks accrues until a slot drains).
                    continue
                self.store.spill(victim, self.pool.release(victim))
                self.metrics.record_eviction(victim)
            b = self._pending[tenant][0].b
            self.pool.ensure_allocated(b.shape[-1], b.dtype, b.device)
            restored = self.store.restore(tenant, self.pool.zero_slot_state())
            try:
                self.pool.admit(tenant, restored, tick=tick)
            except PoolFullError:  # pragma: no cover — guarded above
                continue
            self.metrics.record_admission(tenant, restored=restored is not None)

    def _build_batch(self, serving):
        """``(systems, b_batch, active)`` of the pool step: every slot's
        operator (an idle slot repeats the tick's first one) and right-hand
        side (zeros for an idle slot), and the ``(B,)`` slot mask."""
        fill = serving[0][1]
        for _, req in serving[1:]:
            if not _same_family(req.A, fill.A):
                raise ValueError(
                    "all tenants of one service must share one operator family: tenant "
                    f"{req.ticket.tenant!r} submitted a {type(req.A).__name__} but the "
                    f"tick's first operator is a {type(fill.A).__name__} (the same "
                    "operator type and the same shared data — one kernel_matvec, or one "
                    "x and the same hyperparameters — are required to stack into one "
                    "batched step)"
                )
        B = self.pool.slots
        ops = [fill.A] * B
        bs = [torch.zeros_like(fill.b)] * B
        active = [False] * B
        for slot, req in serving:
            ops[slot], bs[slot], active[slot] = req.A, req.b, True
        return ops, torch.stack(bs), torch.tensor(active, device=fill.b.device)

    def _scatter(self, req: _Request, x, host: dict, tick: int) -> None:
        waited = max(tick - 1 - req.submitted_tick, 0)
        served = ServedResult(
            tenant=req.ticket.tenant,
            seq=req.ticket.seq,
            x=x,
            iterations=int(host["iterations"]),
            matvecs=int(host["matvecs"]),
            converged=bool(host["converged"]),
            residual_norm=float(host["residual_norm"]),
            status=int(host["status"]),
            rung=int(host["rung"]),
            guard_firings=int(host["guard_firings"]),
            tick=tick,
            queue_wait_ticks=waited,
            report=SolveReport(*(torch.tensor(int(host[key]), dtype=torch.int32)
                                 for key in ("status", "rung", "guard_firings", "matvecs"))),
        )
        self._results[(req.ticket.tenant, req.ticket.seq)] = served
        self.metrics.record_served(
            req.ticket.tenant,
            iterations=served.iterations,
            matvecs=served.matvecs,
            guard_firings=served.guard_firings,
            rung=served.rung,
            status=served.status,
            waited_ticks=waited,
            tick=tick,
        )

    # -- telemetry ---------------------------------------------------------
    def metrics_snapshot(self) -> dict:
        """Pool + per-tenant counters as one nested plain dict."""
        self.metrics.spill_gc_deleted = self.store.gc_deleted_total
        return self.metrics.snapshot()
