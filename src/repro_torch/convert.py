"""Carry the reference's state into the port and back.

The reference holds no weights: what a sequence carries from one solve to
the next is its ``RecycleState`` plus the ``SolveSpec`` it runs under, and
a Nyström sketch ``(U, Λ)`` where it preconditions.  With these helpers a
sequence started in ``repro`` continues in ``repro_torch`` (and back) and
gives the same numbers.  Arrays cross as numpy, so neither package
imports the other.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.api import SolveSpec
from repro_torch.core.recycle import RecycleState


def recycle_state_from_numpy(
    W, AW, theta, systems_solved, drift, *, dtype: torch.dtype, device="cuda"
) -> RecycleState:
    """A :class:`RecycleState` on ``device`` from the reference's arrays."""

    def tensor(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return RecycleState(
        W=tensor(W),
        AW=tensor(AW),
        theta=tensor(theta),
        systems_solved=torch.as_tensor(
            int(np.asarray(systems_solved)), dtype=torch.int32, device=device
        ),
        drift=tensor(drift).reshape(()),
    )


def recycle_state_to_numpy(state: RecycleState) -> Dict[str, np.ndarray]:
    """The inverse: ``{W, AW, theta, systems_solved, drift}`` as numpy."""
    return {
        name: getattr(state, name).detach().cpu().numpy()
        for name in ("W", "AW", "theta", "systems_solved", "drift")
    }


def nystrom_sketch_from_numpy(
    U, lam, *, dtype: torch.dtype, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A reference Nyström sketch (``randomized_nystrom``'s ``(U, lam)``:
    ``(rank, n)`` rows in descending eigenvalue order) on ``device``, ready
    for :func:`repro_torch.core.nystrom_preconditioner` or
    :func:`repro_torch.core.kernel_nystrom_preconditioner`."""
    return (
        torch.as_tensor(np.array(U), dtype=dtype, device=device),
        torch.as_tensor(np.array(lam), dtype=dtype, device=device),
    )


def spec_from_fields(fields: dict) -> SolveSpec:
    """A :class:`SolveSpec` from the reference's ``dataclasses.asdict(spec)``
    without its ``strategy`` (the port's default strategy is the
    reference's, :class:`HarmonicRitz`)."""
    if "strategy" in fields:
        raise ValueError(
            "pass the spec's fields without 'strategy': strategies are "
            "objects of each package, not data"
        )
    return SolveSpec(**fields)
