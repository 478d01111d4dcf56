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

The price: a frozen step still runs its matvec (skipping it would need a
host read).  A solve therefore computes up to ``CHUNK − 1`` discarded
products after convergence; they are not counted in ``matvecs``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import pytree as pt

# Masked steps between two host reads of the convergence test.
CHUNK = 8


class SolveStatus:
    """Terminal status codes of an iterative solve (int32, as the reference)."""

    CONVERGED = 0
    MAXITER = 1
    BREAKDOWN_NONFINITE = 2
    BREAKDOWN_INDEFINITE = 3
    STAGNATED = 4


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


def classify_breakdown(d, rnorm, diverged_at):
    """``(bad, code)`` from the ``pᵀAp`` reduction: non-finite, indefinite,
    or a residual past the divergence ceiling (classed STAGNATED)."""
    nonfinite = ~torch.isfinite(d)
    indefinite = (~nonfinite) & (d <= 0.0)
    diverging = rnorm > diverged_at
    bad = nonfinite | indefinite | diverging
    code = torch.where(
        nonfinite,
        SolveStatus.BREAKDOWN_NONFINITE,
        torch.where(
            indefinite, SolveStatus.BREAKDOWN_INDEFINITE, SolveStatus.STAGNATED
        ),
    )
    return bad, torch.where(bad, code, 0).to(torch.int32)


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
    """
    if not record:
        return None
    trace = torch.full(
        (maxiter + 2,), float("nan"), dtype=rnorm0.dtype, device=rnorm0.device
    )
    trace[0] = rnorm0
    return trace


def run_recording_loop(
    step: Callable, active_fn: Callable, state: Tuple, *, ell: int = 0
):
    """Drive a method's masked steps.

    ``step(state, active, row)`` runs one masked iteration; ``row`` is the
    recording slot ``0 … ell−1`` during the first ``ell`` steps and
    ``None`` after.  Phase 1 runs those ``ell`` steps with no host read;
    phase 2 runs chunks of :data:`CHUNK` steps while the host-read
    ``active_fn(state)`` holds.
    """
    for row in range(ell):
        state = step(state, active_fn(state), row)
    while bool(active_fn(state)):
        for _ in range(CHUNK):
            state = step(state, active_fn(state), None)
    return state
