"""Carry the reference's state into the port and back.

The reference holds no weights: what a sequence carries from one solve to
the next is its ``RecycleState`` plus the ``SolveSpec`` it runs under, a
Nyström sketch ``(U, Λ)`` where it preconditions, and the Hessian-free
optimizer's ``HFState`` (its recycle state, previous step and LM damping).
With these helpers a sequence started in ``repro`` continues in
``repro_torch`` (and back) and gives the same numbers.  Arrays cross as
numpy, so neither package imports the other.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.api import SolveSpec
from repro_torch.core.recycle import RecycleState
from repro_torch.optim.hessian_free import HFState


def recycle_state_from_numpy(
    W, AW, theta, systems_solved, drift, *, dtype: torch.dtype, device="cuda"
) -> RecycleState:
    """A :class:`RecycleState` on ``device`` from the reference's arrays.

    A ``deflsmr`` state carries as it is: its ``AW`` slot holds the
    normal-operator products ``NW = (AᵀA + λI)W`` in both packages.
    """

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


def hf_state_from_numpy(
    recycle: dict, delta_prev, damping, step, last_cg_iters, *,
    dtype: torch.dtype, device="cuda",
) -> HFState:
    """An :class:`repro_torch.optim.HFState` on ``device`` from the
    reference's: ``recycle`` is ``{W, AW, theta, systems_solved, drift}``
    (its bootstrap basis included), ``delta_prev`` an array or a dict of
    arrays shaped like the parameters.  The LM damping stays float32 and
    the counters int32, as in the reference."""

    def tree(a):
        if isinstance(a, dict):
            return {key: tree(val) for key, val in a.items()}
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    def i32(a):
        return torch.as_tensor(int(np.asarray(a)), dtype=torch.int32, device=device)

    return HFState(
        recycle=recycle_state_from_numpy(**recycle, dtype=dtype, device=device),
        delta_prev=tree(delta_prev),
        damping=torch.as_tensor(np.float32(np.asarray(damping)), device=device),
        step=i32(step),
        last_cg_iters=i32(last_cg_iters),
    )


def hf_state_to_numpy(state: HFState) -> dict:
    """The inverse: the keyword arguments of :func:`hf_state_from_numpy`."""

    def tree(a):
        if isinstance(a, dict):
            return {key: tree(val) for key, val in a.items()}
        return a.detach().cpu().numpy()

    return {
        "recycle": recycle_state_to_numpy(state.recycle),
        "delta_prev": tree(state.delta_prev),
        "damping": tree(state.damping),
        "step": tree(state.step),
        "last_cg_iters": tree(state.last_cg_iters),
    }
