"""Device-resident ``RecycleState`` slot pool + the tenant spill store (the
counterpart of ``repro.serve.pool``).

B fixed slots hold one stacked :class:`repro_torch.core.RecycleState`
(leading axis B on every leaf, resident on the device for the whole
service lifetime) plus host-side per-slot metadata — bound tenant key,
last-served tick.  A tenant's recycled subspace lives in its slot between
requests; the scheduler serves every resident tenant's next system with
ONE :func:`repro_torch.core.solve_pool_step`, so an idle or poisoned slot
never stalls its neighbours (masking semantics live in the step entry,
per-slot breakdown retirement in the recycled-solve step).

Two classes:

* :class:`StatePool` — the slots.  ``admit`` binds a tenant to a free
  slot (writing its state — cold zeros or a restored basis — into the
  stacked buffers in place, ``copy_``), ``release`` reads the tenant's
  state back out (a copy) and zeroes the slot in place (``zero_``).  The
  buffers are allocated once, from the first tenant's n, dtype and
  device, and never reallocated.  The pool is policy-free: WHO to evict
  is the scheduler's call (:meth:`lru_tenant` just answers the
  least-recently-served question).
* :class:`TenantStateStore` — where evicted states go.  With a directory
  it spills through :class:`repro_torch.checkpoint.CheckpointManager` (one
  manager per tenant key on the reference's on-disk layout, ``keep_last``
  retention, atomic writes — an evicted tenant's warm basis survives a
  process death); without one it keeps host copies (same interface, no
  durability) and restores them onto the pool's device.  Either way
  re-admission restores the exact bytes that were evicted: the round trip
  is bit for bit, so a returning tenant's first solve deflates with the
  basis it left behind.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import RecycleState, SolveSpec

_FIELDS = tuple(f.name for f in dataclasses.fields(RecycleState))


class PoolFullError(RuntimeError):
    """Raised by ``admit`` when no slot is free (the scheduler evicts and
    retries)."""


def _tenant_dirname(key: str) -> str:
    """Filesystem-safe per-tenant directory name (collision-disambiguated),
    the reference's."""
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", str(key))[:64]
    if safe != str(key):
        safe += "-" + hashlib.sha256(str(key).encode()).hexdigest()[:8]
    return f"tenant_{safe}"


def _map_state(fn, *states: RecycleState) -> RecycleState:
    """``fn`` applied leaf by leaf across ``states``."""
    return RecycleState(*(fn(*(getattr(s, f) for s in states)) for f in _FIELDS))


class TenantStateStore:
    """Spill / restore per-tenant ``RecycleState`` by tenant key.

    ``directory=None`` keeps host copies (fast, non-durable); otherwise
    each tenant key owns a :class:`CheckpointManager` under
    ``<directory>/tenant_<key>/`` with ``keep_last`` retention — every
    eviction writes a NEW step (monotonic per tenant), old steps are
    deleted, and :attr:`gc_deleted_total` sums the managers'
    ``deleted_total`` for the pool metrics.
    """

    def __init__(self, directory: Optional[str] = None, *, keep_last: int = 4):
        self.directory = directory
        self.keep_last = keep_last
        self._managers: Dict[str, CheckpointManager] = {}
        self._memory: Dict[str, RecycleState] = {}
        self._steps: Dict[str, int] = {}

    def _manager(self, key: str) -> CheckpointManager:
        if key not in self._managers:
            self._managers[key] = CheckpointManager(
                os.path.join(self.directory, _tenant_dirname(key)), keep_last=self.keep_last)
            existing = self._managers[key].steps()
            self._steps[key] = max(existing) if existing else 0
        return self._managers[key]

    @property
    def gc_deleted_total(self) -> int:
        return sum(m.deleted_total for m in self._managers.values())

    def spill(self, key: str, state: RecycleState) -> None:
        """Persist ``state`` for ``key`` (a new step; old steps deleted)."""
        if self.directory is None:
            self._memory[key] = _map_state(lambda t: t.detach().to("cpu", copy=True), state)
            return
        mgr = self._manager(key)
        self._steps[key] += 1
        mgr.save(state, step=self._steps[key], extra={"tenant": str(key)}, blocking=True)

    def restore(self, key: str, template: RecycleState) -> Optional[RecycleState]:
        """The newest spilled state for ``key`` on ``template``'s device and
        in its dtypes, or None if never spilled."""
        if self.directory is None:
            got = self._memory.get(key)
            if got is None:
                return None
            return _map_state(lambda t, like: t.to(device=like.device, dtype=like.dtype),
                              got, template)
        restored = self._manager(key).restore_latest(template)
        return None if restored is None else restored[1]

    def has(self, key: str) -> bool:
        if self.directory is None:
            return key in self._memory
        return bool(self._manager(key).steps())


class StatePool:
    """B fixed device-resident ``RecycleState`` slots + host metadata.

    The stacked state (leading axis B on every leaf) is allocated lazily on
    the first :meth:`admit` — the pool learns ``n``, the dtype and the
    device from the first tenant — and then NEVER reallocated: every
    write is in place.  It lives where the tenants' tensors live (the card,
    unless they are on the CPU).  ``n=`` (with ``dtype=``, ``device=``;
    f64 on the card by default) allocates it up front; a tenant whose n,
    dtype or device differs from the allocated pool's is refused.
    """

    def __init__(self, slots: int, spec: Optional[SolveSpec] = None, *,
                 n: Optional[int] = None, dtype=torch.float64, device="cuda"):
        if slots < 1:
            raise ValueError(f"a pool needs slots >= 1, got {slots}")
        self.slots = slots
        self.spec = SolveSpec() if spec is None else spec
        self.state: Optional[RecycleState] = None
        self.tenants: List[Optional[str]] = [None] * slots
        self.last_served = [0] * slots
        self._slot_of: Dict[str, int] = {}
        if n is not None:
            self.ensure_allocated(n, dtype, device)

    # -- allocation --------------------------------------------------------
    @property
    def n(self) -> Optional[int]:
        return None if self.state is None else self.state.W.shape[-1]

    @property
    def dtype(self):
        return None if self.state is None else self.state.W.dtype

    @property
    def device(self):
        return None if self.state is None else self.state.W.device

    def ensure_allocated(self, n: int, dtype=torch.float64, device="cuda") -> None:
        if self.state is None:
            zero = RecycleState.zeros(self.spec.k, n, dtype=dtype, device=device)
            self.state = _map_state(
                lambda leaf: torch.zeros((self.slots,) + tuple(leaf.shape), dtype=leaf.dtype,
                                         device=leaf.device), zero)
            return
        device = torch.device(device)
        if self.n != n:
            raise ValueError(
                f"pool is allocated for n={self.n}; a tenant with n={n} "
                "needs its own pool (serving shape is fixed per pool)"
            )
        if self.dtype != dtype or self.device.type != device.type or (
                device.index is not None and device.index != self.device.index):
            raise ValueError(
                f"pool is allocated in {self.dtype} on {self.device}; a tenant in "
                f"{dtype} on {device} needs its own pool"
            )

    def zero_slot_state(self) -> RecycleState:
        """A cold single-slot state template (pool must be allocated)."""
        if self.state is None:
            raise RuntimeError("pool not allocated yet — admit a tenant first")
        return RecycleState.zeros(self.spec.k, self.n, dtype=self.dtype, device=self.device)

    # -- membership --------------------------------------------------------
    @property
    def occupancy(self) -> int:
        return len(self._slot_of)

    def free_slots(self) -> List[int]:
        return [i for i, t in enumerate(self.tenants) if t is None]

    def slot_of(self, key: str) -> Optional[int]:
        return self._slot_of.get(key)

    def resident(self, key: str) -> bool:
        return key in self._slot_of

    def lru_tenant(self, exclude=()) -> Optional[str]:
        """Least-recently-served resident tenant not in ``exclude``."""
        best_key, best_tick = None, None
        for slot, key in enumerate(self.tenants):
            if key is None or key in exclude:
                continue
            if best_tick is None or self.last_served[slot] < best_tick:
                best_key, best_tick = key, self.last_served[slot]
        return best_key

    # -- admit / release ---------------------------------------------------
    def admit(self, key: str, state: Optional[RecycleState] = None, *,
              n: Optional[int] = None, dtype=torch.float64, device="cuda",
              tick: int = 0) -> int:
        """Bind ``key`` to a free slot; write its state (or stay cold).

        Raises :class:`PoolFullError` when no slot is free — the scheduler
        owns the eviction policy, so it catches this, spills a victim, and
        retries.
        """
        if key in self._slot_of:
            raise ValueError(f"tenant {key!r} is already resident")
        free = self.free_slots()
        if not free:
            raise PoolFullError(f"all {self.slots} slots are bound; evict a tenant first")
        if state is not None:
            self.ensure_allocated(state.W.shape[-1], state.W.dtype, state.W.device)
        elif n is not None:
            self.ensure_allocated(n, dtype, device)
        if self.state is None:
            raise RuntimeError(
                "cold admission into an unallocated pool needs n= (and "
                "optionally dtype=, device=) to size the slots"
            )
        slot = free[0]
        self.tenants[slot] = key
        self._slot_of[key] = slot
        self.last_served[slot] = tick
        if state is not None:
            self.write_slot(slot, state)
        # A freed slot is zeroed on release, so a cold admit is genuinely
        # cold without another device write.
        return slot

    def release(self, key: str) -> RecycleState:
        """Unbind ``key``; return (a copy of) its slot state and zero the
        slot in place."""
        slot = self._slot_of.pop(key, None)
        if slot is None:
            raise KeyError(f"tenant {key!r} is not resident")
        state = self.slot_state(slot)
        self.tenants[slot] = None
        self.last_served[slot] = 0
        for f in _FIELDS:
            getattr(self.state, f)[slot].zero_()
        return state

    # -- slot state I/O ----------------------------------------------------
    def slot_state(self, slot: int) -> RecycleState:
        """A copy of slot ``slot``'s state (later writes to the pool leave
        it as it is)."""
        return _map_state(lambda buf: buf[slot].clone(), self.state)

    def write_slot(self, slot: int, state: RecycleState) -> None:
        for f in _FIELDS:
            getattr(self.state, f)[slot].copy_(getattr(state, f))

    def write_all(self, state: RecycleState) -> None:
        """Every slot from a stacked state (a pool step's), in place."""
        for f in _FIELDS:
            getattr(self.state, f).copy_(getattr(state, f))

    def touch(self, slots, tick: int) -> None:
        for slot in slots:
            self.last_served[slot] = tick

    # -- introspection -----------------------------------------------------
    def slot_table(self) -> List[dict]:
        """Host-side per-slot metadata snapshot (one dict per slot)."""
        solved = (self.state.systems_solved.tolist() if self.state is not None
                  else [0] * self.slots)
        return [
            {
                "slot": i,
                "tenant": self.tenants[i],
                "active": self.tenants[i] is not None,
                "last_served_tick": int(self.last_served[i]),
                "systems_solved": int(solved[i]),
            }
            for i in range(self.slots)
        ]
