"""Per-tenant and pool-level serving telemetry — plain-dict snapshots (the
counterpart of ``repro.serve.metrics``).

Everything here is host-side bookkeeping: the scheduler feeds it concrete
Python ints read off the device ONCE per tick (one copy of the step's
per-slot diagnostics), so recording costs no extra device round trips.
``snapshot()`` returns a nested plain dict (json-safe scalars only) — the
contract a bench records and any external scraper can consume without
importing torch.

Two levels:

* :class:`TenantMetrics` — one per tenant key, counting what THAT
  tenant consumed: systems served, iterations/matvecs (honest per-tenant
  accounting from the masked :class:`repro_torch.core.SolveReport`, so an idle
  neighbour's refresh overhead is never charged here), guard/rung
  firings, breakdowns, queue wait, evictions and warm restores.
* :class:`ServeMetrics` — the pool: ticks (busy/idle), batched vs
  single-dispatch steps, slot occupancy integrals (slot-ticks occupied /
  actively serving, from which the snapshot derives mean occupancy),
  admission/eviction/restore totals, peak queue depth, and checkpoint-GC
  deletions reported by the spill store.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class TenantMetrics:
    """Counters for one tenant key (all plain Python ints)."""

    submitted: int = 0
    served: int = 0
    iterations: int = 0
    matvecs: int = 0
    guard_firings: int = 0
    rung_retries: int = 0  # sum of adopted recovery-ladder rungs
    breakdowns: int = 0  # served systems with status >= BREAKDOWN
    queue_wait_ticks: int = 0  # ticks requests spent waiting pre-service
    evictions: int = 0
    restores: int = 0  # warm re-admissions from a spilled state
    last_status: int = 0
    last_served_tick: int = -1

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ServeMetrics:
    """Pool-level counters plus the per-tenant registry."""

    slots: int = 0
    ticks: int = 0
    idle_ticks: int = 0
    batched_steps: int = 0
    single_steps: int = 0  # B=1 fast-path dispatches through plain solve
    served_total: int = 0
    admissions: int = 0
    evictions: int = 0
    restores: int = 0
    occupied_slot_ticks: int = 0  # sum over ticks of resident tenants
    serving_slot_ticks: int = 0  # sum over ticks of actively served slots
    queue_depth_peak: int = 0
    spill_gc_deleted: int = 0  # checkpoint steps GC'd by the spill store
    tenants: Dict[str, TenantMetrics] = dataclasses.field(
        default_factory=dict
    )

    def tenant(self, key: str) -> TenantMetrics:
        if key not in self.tenants:
            self.tenants[key] = TenantMetrics()
        return self.tenants[key]

    # -- recording hooks (called by the scheduler) -------------------------
    def record_tick(self, occupied: int, serving: int) -> None:
        self.ticks += 1
        self.occupied_slot_ticks += occupied
        self.serving_slot_ticks += serving
        if serving == 0:
            self.idle_ticks += 1

    def record_queue_depth(self, depth: int) -> None:
        self.queue_depth_peak = max(self.queue_depth_peak, depth)

    def record_served(
        self,
        key: str,
        *,
        iterations: int,
        matvecs: int,
        guard_firings: int,
        rung: int,
        status: int,
        waited_ticks: int,
        tick: int,
    ) -> None:
        t = self.tenant(key)
        t.served += 1
        t.iterations += iterations
        t.matvecs += matvecs
        t.guard_firings += guard_firings
        t.rung_retries += rung
        if status >= 2:  # SolveStatus.BREAKDOWN_NONFINITE and above
            t.breakdowns += 1
        t.queue_wait_ticks += waited_ticks
        t.last_status = status
        t.last_served_tick = tick
        self.served_total += 1

    def record_admission(self, key: str, *, restored: bool) -> None:
        self.admissions += 1
        if restored:
            self.restores += 1
            self.tenant(key).restores += 1

    def record_eviction(self, key: str) -> None:
        self.evictions += 1
        self.tenant(key).evictions += 1

    def record_spill_gc(self, deleted_steps: int) -> None:
        self.spill_gc_deleted += deleted_steps

    # -- reading -----------------------------------------------------------
    def snapshot(self) -> dict:
        """The whole registry as one nested plain dict (json-safe)."""
        busy = max(self.ticks - self.idle_ticks, 1)
        return {
            "pool": {
                "slots": self.slots,
                "ticks": self.ticks,
                "idle_ticks": self.idle_ticks,
                "batched_steps": self.batched_steps,
                "single_steps": self.single_steps,
                "served_total": self.served_total,
                "admissions": self.admissions,
                "evictions": self.evictions,
                "restores": self.restores,
                "occupied_slot_ticks": self.occupied_slot_ticks,
                "serving_slot_ticks": self.serving_slot_ticks,
                "mean_occupancy": self.occupied_slot_ticks
                / max(self.ticks * max(self.slots, 1), 1),
                "mean_serving_occupancy": self.serving_slot_ticks
                / (busy * max(self.slots, 1)),
                "queue_depth_peak": self.queue_depth_peak,
                "spill_gc_deleted": self.spill_gc_deleted,
            },
            "tenants": {
                key: t.snapshot() for key, t in sorted(self.tenants.items())
            },
        }
