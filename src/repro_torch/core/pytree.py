"""Flat-tensor vector-space helpers (the counterpart of ``repro.core.pytree``).

The reference engine flattens every pytree once at entry and is flat
inside; this slice of the port takes flat tensors only: a vector is an
``(n,)`` tensor and a basis an ``(m, n)`` tensor of stacked rows.  General
pytree inputs come with a later slice.
"""

from __future__ import annotations

import torch


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
