"""Vector-space helpers over pytrees (the counterpart of ``repro.core.pytree``).

A vector is a tensor or a pytree of tensors: nested dicts, lists and
tuples with tensor leaves (``None`` holds no leaf).  Leaves are taken in
JAX's order: dict keys SORTED, lists and tuples in order, so a flat
vector, and a recycled basis, mean the same coordinates in both packages.
A *basis* has a vector's structure with one extra leading axis of size
``m`` on every leaf: ``m`` stacked vectors.

The solvers iterate on flat tensors: a vector is an ``(n,)`` tensor and a
basis an ``(m, n)`` tensor of stacked rows.  They flatten a pytree once
at entry (:func:`ravel_vector`, :func:`ravel_basis`) and unflatten once
at exit, as ``jax.flatten_util.ravel_pytree`` does for the reference.
On a plain tensor every helper runs the flat arithmetic it always ran.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Sequence, Tuple

import torch

Tree = Any


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple)) or tree is None


def _leaves(tree: Tree):
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    if tree is None:
        return []
    return [tree]


def tree_leaves(tree: Tree) -> list:
    """The leaves of ``tree`` in leaf order (dict keys sorted)."""
    return _leaves(tree)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` on the leaves of ``tree`` (and the matching leaves of
    ``rest``), rebuilt in ``tree``'s structure.  Leaves are visited in
    leaf order (dict keys sorted), so a stateful ``fn`` sees them as
    :func:`ravel` lays them out."""
    if isinstance(tree, dict):
        out = {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in sorted(tree)}
        return {key: out[key] for key in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, item, *(r[i] for r in rest)) for i, item in enumerate(tree)]
        return type(tree)(out) if not hasattr(tree, "_fields") else type(tree)(*out)
    if tree is None:
        return None
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# Elementary vector-space ops
# ---------------------------------------------------------------------------


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_scale(alpha, a: Tree) -> Tree:
    return tree_map(lambda x: alpha * x, a)


def tree_axpy(alpha, x: Tree, y: Tree) -> Tree:
    """``y + alpha * x`` (the BLAS axpy, leaf by leaf)."""
    return tree_map(lambda xl, yl: yl + alpha * xl, x, y)


def tree_zeros_like(a: Tree) -> Tree:
    return tree_map(torch.zeros_like, a)


def tree_random_like(generator: torch.Generator, a: Tree, dtype=None) -> Tree:
    """A standard-normal pytree with ``a``'s structure and shapes, drawn
    from ``generator`` leaf by leaf in leaf order."""
    return tree_map(
        lambda leaf: torch.randn(leaf.shape, generator=generator, dtype=dtype or leaf.dtype,
                                 device=leaf.device), a)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: keep f64 as f64, promote everything real to f32+."""
    if dtype == torch.float64:
        return torch.float64
    return torch.promote_types(dtype, torch.float32)


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    """Inner product ``<a, b>`` over every leaf, in at least f32 (0-d
    tensor, on device)."""
    if isinstance(a, torch.Tensor):
        acc = torch.promote_types(_acc_dtype(a.dtype), _acc_dtype(b.dtype))
        return torch.dot(a.reshape(-1).to(acc), b.reshape(-1).to(acc))
    parts = [tree_dot(x, y) for x, y in zip(_leaves(a), _leaves(b))]
    return functools.reduce(torch.add, parts)


def tree_norm(a: Tree) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a))


# ---------------------------------------------------------------------------
# Flat-vector packing (the solvers' representation)
# ---------------------------------------------------------------------------


def _common_dtype(leaves) -> torch.dtype:
    return functools.reduce(torch.promote_types, [leaf.dtype for leaf in leaves[1:]],
                            leaves[0].dtype)


def ravel(tree: Tree) -> torch.Tensor:
    """A tensor or a pytree of tensors as one flat ``(n,)`` tensor (mixed
    dtypes promoted)."""
    leaves = _leaves(tree)
    if len(leaves) == 1:
        return leaves[0].reshape(-1)
    dtype = _common_dtype(leaves)
    return torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])


def ravel_vector(tree: Tree) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Tree]]:
    """``(flat, unravel)``: :func:`ravel` and its inverse, which rebuilds
    ``tree``'s structure, leaf shapes and leaf dtypes from a flat
    ``(n,)`` tensor."""
    leaves = _leaves(tree)
    sizes = [leaf.numel() for leaf in leaves]

    def unravel(flat: torch.Tensor) -> Tree:
        if not _is_node(tree):
            return flat.reshape(tree.shape)
        parts = iter(torch.split(flat, sizes))
        return tree_map(lambda leaf: next(parts).reshape(leaf.shape).to(leaf.dtype), tree)

    return ravel(tree), unravel


def ravel_basis(basis: Tree) -> torch.Tensor:
    """A stacked basis as one ``(m, n)`` tensor; row ``i`` is
    ``ravel(basis_vector(basis, i))``."""
    leaves = _leaves(basis)
    m = leaves[0].shape[0]
    if len(leaves) == 1:
        return leaves[0].reshape(m, -1)
    dtype = _common_dtype(leaves)
    return torch.cat([leaf.reshape(m, -1).to(dtype) for leaf in leaves], dim=1)


def unravel_basis(flat: torch.Tensor, unravel) -> Tree:
    """Inverse of :func:`ravel_basis` given a vector's ``unravel``."""
    return basis_from_vectors([unravel(row) for row in flat])


def is_flat(tree: Tree) -> bool:
    """Whether ``tree`` is a plain tensor (the solvers' own representation)."""
    return isinstance(tree, torch.Tensor)


# ---------------------------------------------------------------------------
# Stacked bases
# ---------------------------------------------------------------------------


def basis_from_vectors(vectors: Sequence[Tree]) -> Tree:
    """Stack a list of vectors into a basis (new leading axis)."""
    return tree_map(lambda *ls: torch.stack(ls, dim=0), *vectors)


def basis_size(basis: Tree) -> int:
    """Number of stacked vectors ``m``."""
    return _leaves(basis)[0].shape[0]


def basis_vector(basis: Tree, i) -> Tree:
    """Vector ``i`` of a basis."""
    return tree_map(lambda leaf: leaf[i], basis)


def basis_dot(basis: Tree, v: Tree) -> torch.Tensor:
    """``B v`` — shape ``(m,)``: each stacked vector against ``v``."""
    if isinstance(basis, torch.Tensor):
        acc = torch.promote_types(_acc_dtype(basis.dtype), _acc_dtype(v.dtype))
        return basis.reshape(basis.shape[0], -1).to(acc) @ v.reshape(-1).to(acc)
    parts = [basis_dot(bl, vl) for bl, vl in zip(_leaves(basis), _leaves(v))]
    return functools.reduce(torch.add, parts)


def basis_combine(basis: Tree, coef: torch.Tensor) -> Tree:
    """``coefᵀ B`` — a linear combination of the stacked vectors, one vector."""

    def leaf(bl):
        acc = _acc_dtype(bl.dtype)
        flat = coef.to(acc) @ bl.reshape(bl.shape[0], -1).to(acc)
        return flat.reshape(bl.shape[1:]).to(bl.dtype)

    return tree_map(leaf, basis)


def basis_matmul(basis: Tree, mat: torch.Tensor) -> Tree:
    """``B @ mat`` for ``mat`` of shape ``(m, j)``: a basis of ``j`` vectors."""

    def leaf(bl):
        acc = _acc_dtype(bl.dtype)
        flat = mat.T.to(acc) @ bl.reshape(bl.shape[0], -1).to(acc)
        return flat.reshape((mat.shape[1],) + tuple(bl.shape[1:])).to(bl.dtype)

    return tree_map(leaf, basis)


def gram(a: Tree, b: Tree) -> torch.Tensor:
    """``A Bᵀ`` for two stacked bases — the small ``(ma, mb)`` Gram."""
    if isinstance(a, torch.Tensor):
        acc = torch.promote_types(_acc_dtype(a.dtype), _acc_dtype(b.dtype))
        return a.reshape(a.shape[0], -1).to(acc) @ b.reshape(b.shape[0], -1).to(acc).T
    parts = [gram(al, bl) for al, bl in zip(_leaves(a), _leaves(b))]
    return functools.reduce(torch.add, parts)


def basis_concat(a: Tree, b: Tree) -> Tree:
    """``[A, B]``: two bases concatenated along the stacking axis."""
    return tree_map(lambda al, bl: torch.cat([al, bl], dim=0), a, b)


def basis_zeros(template: Tree, m: int) -> Tree:
    """An all-zero basis of ``m`` vectors shaped like ``template``."""
    return tree_map(lambda leaf: leaf.new_zeros((m,) + tuple(leaf.shape)), template)


def basis_set(basis: Tree, v: Tree, i) -> Tree:
    """A copy of ``basis`` with stacked vector ``i`` set to ``v``."""

    def leaf(bl, vl):
        out = bl.clone()
        out[i] = vl.to(bl.dtype)
        return out

    return tree_map(leaf, basis, v)


def basis_slice(basis: Tree, m: int) -> Tree:
    """The first ``m`` vectors of a basis."""
    return tree_map(lambda leaf: leaf[:m], basis)


def basis_scale_columns(basis: Tree, scales: torch.Tensor) -> Tree:
    """Stacked vector ``i`` scaled by ``scales[i]``."""

    def leaf(bl):
        shape = (bl.shape[0],) + (1,) * (bl.ndim - 1)
        return bl * scales.reshape(shape).to(bl.dtype)

    return tree_map(leaf, basis)


def basis_map_vectors(fn: Callable[[Tree], Tree], basis: Tree) -> Tree:
    """``fn`` on every stacked vector, restacked."""
    return basis_from_vectors([fn(basis_vector(basis, i)) for i in range(basis_size(basis))])


def flat_operator(op, unravel) -> Callable[[torch.Tensor], torch.Tensor]:
    """A pytree matvec or preconditioner lifted to flat ``(n,)`` vectors."""

    def mv(v_flat):
        return ravel(op(unravel(v_flat)))

    return mv
