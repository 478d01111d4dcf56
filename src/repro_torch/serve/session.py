"""The tenant-facing handle: submit systems, redeem tickets, depart (the
counterpart of ``repro.serve.session``).

A :class:`Session` is a thin, stateless-on-device view over one tenant
key of a :class:`repro_torch.serve.SolveService` — all solver state lives in
the service's pool/store, so sessions are free to create, drop, and
re-create: a re-created session for the same key resumes the same warm
``RecycleState`` (from its slot if still resident, from the spill store
if it was evicted).

Deterministic synchronous mode is the default: ``result()`` drives the
service's tick loop until the ticket resolves, so single-threaded tests
and scripts get exact reproducibility with no extra plumbing.  A host
event loop that owns ticking itself passes ``drive=False`` and polls.

    with service.session("alice") as s:
        t = s.submit(A0, b0)
        r = s.result(t)          # drives ticks; r.x, r.report, r.ok
        x1 = s.solve(A1, b1).x   # submit + result in one call
    # __exit__ -> close(): slot freed, warm basis spilled for next time
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.serve.scheduler import ServedResult, SolveService, Ticket


class Session:
    """One tenant's handle on a :class:`SolveService` (see module doc)."""

    def __init__(self, service: SolveService, tenant: str):
        self.service = service
        self.tenant = str(tenant)
        self._last_ticket: Optional[Ticket] = None
        self._closed = False

    # -- submitting --------------------------------------------------------
    def submit(self, A: Any, b: torch.Tensor) -> Ticket:
        """Enqueue ``A x = b`` for this tenant; returns the ticket."""
        self._check_open()
        self._last_ticket = self.service.submit(self.tenant, A, b)
        return self._last_ticket

    # -- redeeming ---------------------------------------------------------
    def result(
        self, ticket: Optional[Ticket] = None, *, drive: bool = True
    ) -> ServedResult:
        """Redeem ``ticket`` (default: the most recent submit)."""
        self._check_open()
        ticket = self._last_ticket if ticket is None else ticket
        if ticket is None:
            raise ValueError("nothing submitted yet — no ticket to redeem")
        if ticket.tenant != self.tenant:
            raise ValueError(
                f"ticket belongs to tenant {ticket.tenant!r}, "
                f"not {self.tenant!r}"
            )
        return self.service.result(ticket, drive=drive)

    def poll(self, ticket: Optional[Ticket] = None) -> Optional[ServedResult]:
        """Non-driving probe: the result if served, else None."""
        ticket = self._last_ticket if ticket is None else ticket
        return None if ticket is None else self.service.poll(ticket)

    def solve(self, A: Any, b: torch.Tensor) -> ServedResult:
        """Submit and drive to completion in one call."""
        return self.result(self.submit(A, b))

    # -- telemetry ---------------------------------------------------------
    def metrics(self) -> dict:
        """This tenant's counter snapshot (plain dict)."""
        return self.service.metrics.tenant(self.tenant).snapshot()

    # -- departing ---------------------------------------------------------
    def close(self, *, spill: bool = True) -> None:
        """Depart: free the slot; ``spill=True`` keeps the warm basis in
        the store so a future session for this key resumes it."""
        if not self._closed:
            self.service.close(self.tenant, spill=spill)
            self._closed = True

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(
                f"session for tenant {self.tenant!r} is closed"
            )

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # Don't mask an in-flight exception with the unserved-work guard.
        if exc_type is None:
            self.close()
