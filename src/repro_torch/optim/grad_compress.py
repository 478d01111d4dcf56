"""PowerSGD gradient compression with recycled power-iteration bases (the
counterpart of ``repro.optim.grad_compress``).

Each gradient of two or more dimensions ``M`` (m × n, its trailing
dimensions flattened) is compressed to rank r by one power iteration,
``P = orth(M Q)``, ``Q' = Mᵀ P``, starting from the previous step's ``Q``:
consecutive gradients share their dominant subspace, so one recycled
iteration tracks it.  Error feedback (``e ← M − P Q'ᵀ``, added to the
next gradient) keeps the compression unbiased over steps.  Vectors pass
through uncompressed.  A data-parallel caller all-reduces ``P`` and ``Q'``
between :func:`compress` and :func:`decompress`.

Trees are a tensor or a dict, list or tuple of them.  The starting bases
are drawn from a ``torch.Generator`` (the reference draws from a JAX key:
the numbers differ; carry the reference's ``Q`` over to compare).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core import pytree as pt

Tree = Any


class PowerSGDState(NamedTuple):
    q: Tree  # per leaf the (n, r) recycled basis; an empty (0,) tensor for vectors
    error: Tree  # error-feedback memory, f32, shaped like the gradients


def _as_matrix(x: torch.Tensor):
    return None if x.ndim == 1 else x.reshape(x.shape[0], -1)


def powersgd_init(params: Tree, rank: int, generator: torch.Generator) -> PowerSGDState:
    """Orthonormal Gaussian ``(n, rank)`` bases drawn from ``generator``,
    leaf by leaf in leaf order, and zero error memories."""

    def mk_q(p):
        m = _as_matrix(p)
        if m is None:
            return torch.zeros((0,), dtype=torch.float32, device=p.device)
        g = torch.randn((m.shape[1], rank), generator=generator, dtype=torch.float32,
                        device=p.device)
        return torch.linalg.qr(g).Q

    return PowerSGDState(
        q=pt.tree_map(mk_q, params),
        error=pt.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
    )


def _unflatten(template: Tree, leaves) -> Tree:
    """``leaves`` (in leaf order) in ``template``'s structure."""
    it = iter(leaves)
    return pt.tree_map(lambda _: next(it), template)


def compress(grads: Tree, state: PowerSGDState) -> Tuple[Tree, Tree, Tree]:
    """``(P, Q', M)`` trees: P and Q' are what a data-parallel caller
    all-reduces (means) before :func:`decompress`; M is the gradient plus
    its error memory, in f32 (a vector leaf passes through as P and M)."""
    out = []
    for g, q, e in zip(pt.tree_leaves(grads), pt.tree_leaves(state.q), pt.tree_leaves(state.error)):
        m = _as_matrix(g)
        if m is None:
            out.append((g.to(torch.float32), q, g.to(torch.float32)))
            continue
        mf = m.to(torch.float32) + e.reshape(m.shape)
        p = torch.linalg.qr(mf @ q).Q  # (m, r), orthonormal
        out.append((p, mf.T @ p, mf))  # Q' (n, r): the recycled basis for the next step
    return tuple(_unflatten(grads, [t[i] for t in out]) for i in range(3))


def decompress(grads: Tree, p_tree: Tree, q_tree: Tree, m_tree: Tree) -> Tuple[Tree, PowerSGDState]:
    """``M̂ = P Q'ᵀ`` shaped like each gradient, the new error memory
    ``M − M̂``, and the new state."""
    ghat, err = [], []
    for g, p, q, mf in zip(*(pt.tree_leaves(t) for t in (grads, p_tree, q_tree, m_tree))):
        if g.ndim == 1:
            ghat.append(g.to(torch.float32))
            err.append(torch.zeros_like(g, dtype=torch.float32))
            continue
        approx = p @ q.T
        ghat.append(approx.reshape(g.shape))
        err.append((mf - approx).reshape(g.shape))
    return _unflatten(grads, ghat), PowerSGDState(q=q_tree, error=_unflatten(grads, err))


def compress_decompress(grads: Tree, state: PowerSGDState) -> Tuple[Tree, PowerSGDState, dict]:
    """One process, no collective: :func:`compress` then
    :func:`decompress`; the metrics hold the ratio of dense to compressed
    element counts."""
    p_tree, q_tree, m_tree = compress(grads, state)
    ghat, new_state = decompress(grads, p_tree, q_tree, m_tree)

    def count(t):
        return sum(x.numel() for x in pt.tree_leaves(t))

    return ghat, new_state, {"compression_ratio": count(grads) / max(count(p_tree) + count(q_tree), 1)}
