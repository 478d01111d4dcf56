"""AdamW, the first-order baseline (the counterpart of ``repro.optim.adam``).

Functional over a tree of tensors (a tensor, or a dict, list or tuple of
them): the moments are f32 whatever the parameters' dtype, the bias
correction comes from the step ``count``, the weight decay is decoupled
and applied to the f32 parameter, and each new parameter is cast back to
its own dtype, as in the reference.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import pytree as pt

Tree = Any


class AdamState(NamedTuple):
    mu: Tree
    nu: Tree
    count: torch.Tensor  # int32 0-d


def adam_init(params: Tree) -> AdamState:
    def zeros(p):
        return pt.tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), p)

    device = pt.tree_leaves(params)[0].device
    return AdamState(mu=zeros(params), nu=zeros(params),
                     count=torch.zeros((), dtype=torch.int32, device=device))


def adam_update(
    grads: Tree,
    state: AdamState,
    params: Tree,
    *,
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
):
    """One AdamW step; returns ``(new_params, new_state)``."""
    count = state.count + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - b1**cf
    bc2 = 1.0 - b2**cf
    mu = pt.tree_map(lambda m, g: b1 * m + (1.0 - b1) * g.to(torch.float32), state.mu, grads)
    nu = pt.tree_map(lambda v, g: b2 * v + (1.0 - b2) * torch.square(g.to(torch.float32)),
                     state.nu, grads)

    def step(p, m, v):
        s = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            s = s + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * s).to(p.dtype)

    return pt.tree_map(step, params, mu, nu), AdamState(mu=mu, nu=nu, count=count)
