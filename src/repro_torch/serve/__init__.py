"""repro_torch.serve — the multi-tenant solve service over the solver front
doors (the counterpart of ``repro.serve``).

The paper frames recycling as transfer learning of a low-rank
approximation across a series of numerical tasks; this package is that
framing as a serving system.  Each tenant (one user's GP / Laplace /
Newton sequence) carries an evolving
:class:`repro_torch.core.RecycleState`; the service keeps B of them
resident on the device in a :class:`StatePool`, serves every resident
tenant's next system with ONE :func:`repro_torch.core.solve_pool_step` per
tick (continuous batching on the lane axis of the step kernels), spills
least-recently-served tenants through
:class:`repro_torch.checkpoint.CheckpointManager` so their warm bases
survive eviction, and exposes per-tenant and pool telemetry as plain
dicts.

Layering (each module's docstring carries its contract):

* :mod:`repro_torch.serve.pool`      — device-resident slots + the spill store
* :mod:`repro_torch.serve.scheduler` — admission/eviction/serve event loop
* :mod:`repro_torch.serve.session`   — the tenant-facing handle
* :mod:`repro_torch.serve.metrics`   — per-tenant and pool-level counters
"""

from repro_torch.serve.metrics import ServeMetrics, TenantMetrics
from repro_torch.serve.pool import PoolFullError, StatePool, TenantStateStore
from repro_torch.serve.scheduler import ServedResult, SolveService, Ticket
from repro_torch.serve.session import Session

__all__ = [
    "PoolFullError",
    "ServeMetrics",
    "ServedResult",
    "Session",
    "SolveService",
    "StatePool",
    "TenantMetrics",
    "TenantStateStore",
    "Ticket",
]
