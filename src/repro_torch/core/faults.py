"""Fault injection for the solve runtime — proof that the ladder works
(the counterpart of ``repro.core.faults``).

* :class:`FaultInjectingOperator` wraps any operator and corrupts its
  products on demand:

  - ``poison``: an additive scalar folded into every product (a 0-d
    tensor or a Python number).  ``nan`` / ``inf`` model hard numerical
    corruption, a small finite value a bounded perturbation.  In a
    sequence it is one entry of a per-system ``(N,)`` tensor, sliced with
    the systems (``systems={"mat": mats, "poison": poison}``, each
    operator built from its own slice), so "system i is broken" is
    ``poison[i] = nan``.
  - ``at_matvec``: poison exactly the t-th *executed* product with NaN,
    counted by a plain Python counter in ``__call__`` across every
    application of this instance (basis refreshes included).

  That counter lives on the host, where a replayed CUDA graph never
  reaches it: the operator declares ``host_state``, and a compiled door
  (``solve_jit``, ``defcg_jit``, …) runs a loop that takes it as an input
  with its eager steps (``engine.GRAPHS["host_state"]`` counts them).
  Hidden inside a closure the door cannot see it, and a capture that
  calls it raises.

* :func:`truncate_latest_checkpoint` damages the newest checkpoint on
  disk as a torn write would (manifest intact, arrays unreadable), to
  prove that ``CheckpointManager.restore_latest`` falls back and records
  the skip.

Nothing here is on the solver hot path: it is test and benchmark
instrumentation that lives beside the code it attacks.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Union

import torch


@dataclasses.dataclass
class FaultInjectingOperator:
    """Wrap an operator ``base`` and corrupt selected products.

    Attributes:
      base: the wrapped operator (any callable on ``(n,)`` tensors).
      poison: the additive scalar applied to EVERY product: ``0.0`` is a
        bit-exact no-op on the values, ``nan`` / ``inf`` hard corruption.
      at_matvec: 0-based index of the single executed product to poison
        with NaN, counted across all applications of this instance;
        ``None`` disables the counter.
    """

    base: Any
    poison: Union[torch.Tensor, float] = 0.0
    at_matvec: Optional[int] = None
    count: int = 0
    # A compiled program runs this operator's loops eagerly (engine.flatten).
    host_state = True

    def reset(self) -> None:
        """Re-arm the ``at_matvec`` trigger."""
        self.count = 0

    @property
    def executed_matvecs(self) -> int:
        """Products executed so far (0 without an ``at_matvec`` trigger)."""
        return self.count if self.at_matvec is not None else 0

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        if v.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("FaultInjectingOperator counts its products on the host and "
                               "cannot be captured into a CUDA graph")
        out = self.base(v)
        bad = torch.as_tensor(self.poison, dtype=out.dtype, device=out.device)
        if self.at_matvec is not None:
            self.count += 1
            if self.count - 1 == self.at_matvec:
                bad = bad + float("nan")
        return out + bad


def truncate_latest_checkpoint(directory: str) -> Optional[int]:
    """Damage the newest checkpoint like a crash mid-write would.

    Replaces its ``arrays.npz`` with garbage bytes and leaves the manifest
    intact: the step looks committed but its payload is unreadable.
    Returns the damaged step number, or ``None`` when the directory holds
    no checkpoint.
    """
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                continue
    if not steps:
        return None
    step = max(steps)
    payload = os.path.join(directory, f"step_{step:08d}", "arrays.npz")
    with open(payload, "wb") as f:
        f.write(b"not an npz: torn write")
    return step
