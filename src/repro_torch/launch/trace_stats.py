"""Counts of a step traced on the meta device, for the dry-run.

The port's counterpart of ``repro.launch.hlo_stats``.  The reference reads
FLOPs, bytes and collectives from the compiled HLO; the port runs the step
itself on meta tensors (shapes and dtypes, no data, nothing allocated)
under :class:`TraceStats`, a ``TorchDispatchMode`` that sees every op the
step issues, in order, forward and backward alike.  There is no while loop
to correct for: PyTorch runs a loop's body once an iteration.  Per op it
counts

* **FLOPs** — ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``
  reads the same registry); the kernels' custom ops (K3, K8, K9, K10)
  carry the operations behind their bounds
  (:mod:`repro_torch.kernels.work`), not those of their plain versions;
* **bytes** — each op's tensor inputs read once and outputs written once; a
  kernel's own count where it has one; views, aliases and empty
  allocations move nothing;
* **the op census** — the launches the step would issue: one per op that
  moves bytes, by op name;
* **peak live bytes** — every storage the step makes, from its creation
  until the last tensor on it is gone (a weak reference on the storage),
  beside the tensors the caller holds (``live``), each rounded up to the
  CUDA caching allocator's 512 bytes; a kernel's scratch is live during
  its call.  This is what ``torch.cuda.max_memory_allocated()`` reads on
  the card for the same step.
"""

from __future__ import annotations

import collections
import weakref
from typing import Callable, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work

BLOCK = 512  # the CUDA caching allocator's rounding
_EMPTY = {torch.ops.aten.empty, torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
          torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}


def _rounded(nbytes: int) -> int:
    return max(BLOCK, -(-nbytes // BLOCK) * BLOCK) if nbytes else 0


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class TraceStats(TorchDispatchMode):
    """Counts the ops run while it is active (see the module docstring).
    ``live``: tensors (or trees of them) the caller holds through the step,
    counted live from the start."""

    def __init__(self, live: Iterable = ()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.census = collections.Counter()
        self.current = 0
        self.peak = 0
        self._sizes = {}  # id(storage) -> rounded bytes
        self._refs = {}  # id(storage) -> weak reference (its callback frees)
        for t in _tensors(list(live)):
            self._hold(t)
        self.held = self.current

    def _hold(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._sizes:
            return
        size = _rounded(storage.nbytes())
        self._sizes[key] = size
        self._refs[key] = weakref.ref(storage, lambda _, key=key: self._free(key))
        self.current += size
        self.peak = max(self.peak, self.current)

    def _free(self, key) -> None:
        self.current -= self._sizes.pop(key)
        del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_storages = {id(t.untyped_storage()) for t in ins}
        fresh = [t for t in outs if id(t.untyped_storage()) not in in_storages]
        for t in fresh:
            self._hold(t)
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if packet in work.COUNTED:
            _, nbytes, scratch = work.COUNTED[packet](*args, **kwargs)
            self.peak = max(self.peak, self.current + _rounded(scratch))
        elif not outs or packet in _EMPTY or (len(fresh) < len(outs)
                                              and not func._schema.is_mutable):
            return out  # an allocation, a view or an alias: nothing moves
        else:
            nbytes = sum(work.nbytes(t) for t in ins + outs)
        if nbytes:
            self.bytes += nbytes
            self.census[str(packet)] += 1
        return out

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes, "launches": sum(self.census.values()),
                "op_census": dict(self.census.most_common()), "peak_bytes": self.peak,
                "held_bytes": self.held}


def trace(fn: Callable, *args, live: Iterable = (), **kwargs):
    """``(fn(*args, **kwargs), counts)``: ``fn`` run under a
    :class:`TraceStats` holding ``live`` and ``args``; ``counts`` is its
    :meth:`TraceStats.summary`."""
    stats = TraceStats(live=[*live, args, kwargs])
    with stats:
        out = fn(*args, **kwargs)
    return out, stats.summary()
