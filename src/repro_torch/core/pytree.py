"""Flat-tensor vector-space helpers (the counterpart of ``repro.core.pytree``).

The reference engine flattens every pytree once at entry and is flat
inside; the port's solvers take flat tensors only: a vector is an
``(n,)`` tensor and a basis an ``(m, n)`` tensor of stacked rows.
:func:`ravel` / :func:`ravel_vector` flatten the parameters of a model
(a tensor of any shape, or a dict of them, nested or not) the way
``jax.flatten_util.ravel_pytree`` does: dict keys in SORTED order, each
leaf row-major.  So a flat vector, and a recycled basis, mean the same
coordinates in both packages.  General pytrees beyond dicts come with
ROADMAP queue 1, pytree inputs to the solvers.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

Tree = Union[torch.Tensor, dict]


def _leaves(tree: Tree):
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    return [tree]


def ravel(tree: Tree) -> torch.Tensor:
    """A tensor or a dict of tensors as one flat ``(n,)`` tensor."""
    leaves = _leaves(tree)
    if len(leaves) == 1:
        return leaves[0].reshape(-1)
    return torch.cat([leaf.reshape(-1) for leaf in leaves])


def ravel_vector(tree: Tree) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Tree]]:
    """``(flat, unravel)``: :func:`ravel` and its inverse, which rebuilds
    ``tree``'s structure and leaf shapes from a flat ``(n,)`` tensor."""

    def build(t, flat, start):
        if isinstance(t, dict):
            out = {}
            for key in sorted(t):
                out[key], start = build(t[key], flat, start)
            return {key: out[key] for key in t}, start
        end = start + t.numel()
        return flat[start:end].reshape(t.shape), end

    def unravel(flat: torch.Tensor) -> Tree:
        return build(tree, flat, 0)[0]

    return ravel(tree), unravel


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: keep f64 as f64, promote everything real to f32+."""
    if dtype == torch.float64:
        return torch.float64
    return torch.promote_types(dtype, torch.float32)


def tree_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product ``<a, b>`` in at least f32 (0-d tensor, on device)."""
    acc = torch.promote_types(_acc_dtype(a.dtype), _acc_dtype(b.dtype))
    return torch.dot(a.reshape(-1).to(acc), b.reshape(-1).to(acc))


def tree_norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a))


def gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A Bᵀ`` for two row-stacked bases — the small ``(ma, mb)`` Gram."""
    acc = torch.promote_types(_acc_dtype(a.dtype), _acc_dtype(b.dtype))
    return a.to(acc) @ b.to(acc).T


def basis_dot(basis: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``B v`` — shape ``(m,)``: each stacked row against ``v``."""
    acc = torch.promote_types(_acc_dtype(basis.dtype), _acc_dtype(v.dtype))
    return basis.to(acc) @ v.to(acc)


def basis_combine(basis: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """``coefᵀ B`` — a linear combination of the stacked rows, one vector."""
    acc = _acc_dtype(basis.dtype)
    return (coef.to(acc) @ basis.to(acc)).to(basis.dtype)
