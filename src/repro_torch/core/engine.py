"""Krylov iteration harness (the counterpart of ``repro.core.engine``).

The reference runs a whole solve as one XLA program: a fixed-length
masked recording scan over the first ``ell`` iterations, then a
``while_loop``.  PyTorch runs eagerly, and a loop that reads its
convergence test back to the host every iteration waits on the card every
iteration.  So every step here is the MASKED step: ``active`` is computed
on the device, and a frozen step leaves the state untouched — the
iterates, iteration counts and matvec counts come out identical to the
reference's.  The host reads the convergence test once per
:data:`CHUNK` steps only, and never during the ``ell`` recording steps.

A frozen step still launches its product, and :func:`gated_matvec` hands
it the step's device ``active`` flag: an operator with a device gate (the
matrix-free RBF operator, whose K3 / K8 kernels read the flag vector
themselves) then skips the Gram tiles and returns zeros, as the
reference's gated ``cond`` does, with no host read.  An operator without
one (the dense ``torch.mv``, a callable) computes the product anyway and
the masked step discards it.  Either way a solve launches up to ``CHUNK
− 1`` products after convergence, none counted in ``matvecs``.

On the card the scalar recurrence of a step and its frozen-step mask run
inside the step's fused kernel: def-CG's from ``pᵀAp`` on is one
``fused_cg_update`` launch (``kernels.ops.fused_cg_step``), LSMR's after
``‖w‖²`` one ``lsmr_update`` launch (``kernels.ops.lsmr_step``).  Each
writes the next step's ``active`` flag, so ``active_fn`` there reads the
carried flag instead of launching the test.  The stall detector
(``stagnation_window > 0``) rides in the same launches: its ``(best,
stall)`` state is carried beside ``[j, fail]`` (:func:`stagnation_init`);
the sharded loops, whose tails run as eager ops, step it with
:func:`stagnation_update`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import pytree as pt
# The breakdown and stall rules live beside the kernels whose step tails
# apply them.
from repro_torch.kernels import cg_fused
from repro_torch.kernels.cg_fused import STAGNATION_RTOL, classify_breakdown  # noqa: F401

# Masked steps between two host reads of the convergence test.
CHUNK = 8


class SolveStatus:
    """Terminal status codes of an iterative solve (int32, as the reference)."""

    CONVERGED = 0
    MAXITER = 1
    BREAKDOWN_NONFINITE = 2
    BREAKDOWN_INDEFINITE = 3
    STAGNATED = 4

    @classmethod
    def describe(cls, code) -> str:
        """The status name of an int32 code (a Python int or 0-d tensor)."""
        code = int(code)
        for name in ("CONVERGED", "MAXITER", "BREAKDOWN_NONFINITE",
                     "BREAKDOWN_INDEFINITE", "STAGNATED"):
            if getattr(cls, name) == code:
                return name
        return f"UNKNOWN({code})"


class SolveInfo(NamedTuple):
    """Diagnostics of an iterative solve (0-d tensors on the solve's device)."""

    iterations: torch.Tensor
    converged: torch.Tensor
    residual_norm: torch.Tensor
    matvecs: torch.Tensor
    residual_norms: Optional[torch.Tensor] = None
    breakdown: torch.Tensor | bool = False
    status: torch.Tensor | int = 0
    guard_fired: torch.Tensor | bool = False


def exit_status(converged, fail):
    return torch.where(
        converged,
        SolveStatus.CONVERGED,
        torch.where(fail > 0, fail, SolveStatus.MAXITER),
    ).to(torch.int32)


def tolerances(b, tol, atol):
    bnorm = pt.tree_norm(b)
    return torch.clamp(tol * bnorm, min=atol), bnorm


def initial_fail(rnorm0):
    """A non-finite initial residual never enters the loop: flag it."""
    return torch.where(
        torch.isfinite(rnorm0), 0, SolveStatus.BREAKDOWN_NONFINITE
    ).to(torch.int32)


def trace_init(rnorm0, maxiter: int, record: bool):
    """NaN-tailed residual trace with slot 0 filled; ``None`` when off.

    One spare slot past ``maxiter + 1`` takes the writes of frozen steps
    at ``j == maxiter`` (the reference drops them); callers slice it off.
    A lane axis (``rnorm0`` ``(B,)``) gives one trace a lane.
    """
    if not record:
        return None
    trace = torch.full(
        rnorm0.shape + (maxiter + 2,), float("nan"), dtype=rnorm0.dtype, device=rnorm0.device
    )
    trace[..., 0] = rnorm0
    return trace


def stagnation_init(norm0, window: int):
    """The stall detector's ``(best, stall)`` before the first step —
    ``None`` when disarmed, so the clean path carries no extra state."""
    if window <= 0:
        return None
    return norm0, torch.zeros(norm0.shape, dtype=torch.int32, device=norm0.device)


def stagnation_update(stag, norm_new, fail, active, window: int):
    """One stall-detector step: ``(stag', fail')`` with STAGNATED latched
    into the sticky ``fail`` when the best residual has not improved by
    1 % for ``window`` consecutive active iterations (both unchanged when
    ``stag`` is None, the detector disarmed)."""
    if stag is None:
        return None, fail
    best, stall, fail = cg_fused.stagnation_update(*stag, norm_new, fail, active, window)
    return (best, stall), fail


def gated_matvec(apply, v, active):
    """A step's product behind its frozen-step gate, with no host read.

    ``active`` is the step's device flag (0-d), or the ``(B,)`` flags of a
    tenant batch whose ``v`` is ``(B, n)``: the product is skipped only
    once EVERY lane is frozen (the reference's cross-tenant ``psum``
    gate).  An operator offering ``gated_matvec(v, gate)`` is handed the
    flags and returns zeros when none is set; any other runs its product
    (the masked step discards a frozen one)."""
    gated = getattr(apply, "gated_matvec", None)
    if gated is None:
        return apply(v)
    return gated(v, active)


def run_recording_loop(
    step: Callable, active_fn: Callable, state: Tuple, *, ell: int = 0
):
    """Drive a method's masked steps.

    ``step(state, active, row)`` runs one masked iteration; ``row`` is the
    recording slot ``0 … ell−1`` during the first ``ell`` steps and
    ``None`` after.  Phase 1 runs those ``ell`` steps with no host read;
    phase 2 runs chunks of :data:`CHUNK` steps while the host-read
    ``active_fn(state)`` holds (for a batch's ``(B,)`` flags: while any
    lane is active).
    """
    for row in range(ell):
        state = step(state, active_fn(state), row)
    while _any_active(active_fn(state)):
        for _ in range(CHUNK):
            state = step(state, active_fn(state), None)
    return state


def _any_active(active) -> bool:
    """The host read of a chunk: the flag, or any lane's of a batch."""
    return bool(active) if active.ndim == 0 else bool(torch.any(active))


def psum_merged(parts, mesh):
    """Batch several small reductions into ONE ``all_reduce``.

    ``parts`` are per-rank partial reductions (0-d or 1-d tensors, e.g.
    ``[pᵀap, rᵀap, apᵀap, AW@ap]``): packed into one flat buffer of their
    common dtype, summed over ``mesh``'s ranks by one collective
    (:meth:`repro_torch.launch.SolveMesh.all_reduce`, which counts it), and
    unpacked to their own shapes and dtypes.  Every in-loop reduction of
    the sharded engine rides this one call: one all-reduce per cg / def-CG
    iteration, two per LSMR iteration (DESIGN.md §5).
    """
    dtype = parts[0].dtype
    for p in parts[1:]:
        dtype = torch.promote_types(dtype, p.dtype)
    flats = [p.reshape(-1).to(dtype) for p in parts]
    red = mesh.all_reduce(torch.cat(flats))
    out, off = [], 0
    for p, f in zip(parts, flats):
        out.append(red[off : off + f.numel()].reshape(p.shape).to(p.dtype))
        off += f.numel()
    return out
