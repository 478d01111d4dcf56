"""Pytree solves: the port's ``core/pytree.py`` helpers and the front doors
on pytree right-hand sides, against the flat solves and the live JAX
reference.

Mirrors ``tests/test_cg_fused.py``'s structure invariance (a flat ``(n,)``
vector and a dict pytree of the same coordinates give the same numbers at
a fixed iteration count, the recorded window in the vector's structure)
and ``tests/test_lsmr.py::test_pytree_rhs_and_domain`` (LSMR across a
ravel / unravel pair on both sides).  Leaves are in JAX's order: dict keys
sorted, lists and tuples in order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax.config.update("jax_enable_x64", True)

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro.core import pytree as jpt  # noqa: E402
from repro_torch.core import pytree as tpt  # noqa: E402
from tests.conftest import make_spd  # noqa: E402


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _tree(flat, h):
    return {"b": flat[h:], "a": flat[:h].reshape(2, -1)}


def _flat(tree):
    return torch.cat([tree["a"].reshape(-1), tree["b"]])


def test_ravel_order_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"z": rng.standard_normal(3), "a": [rng.standard_normal((2, 2)),
                                             (rng.standard_normal(1), rng.standard_normal(2))]}
    flat_j, _ = jpt.ravel_vector(jax.tree_util.tree_map(jnp.asarray, tree))
    t_tree = {"z": _t(tree["z"]), "a": [_t(tree["a"][0]), (_t(tree["a"][1][0]),
                                                           _t(tree["a"][1][1]))]}
    flat_t, unravel = tpt.ravel_vector(t_tree)
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    back = unravel(flat_t)
    assert isinstance(back["a"], list) and isinstance(back["a"][1], tuple)
    assert torch.equal(back["a"][1][1], t_tree["a"][1][1]) and list(back) == ["z", "a"]


def test_tree_and_basis_helpers_match_flat():
    rng = np.random.default_rng(1)
    n, m, h = 24, 4, 10
    v, w = _t(rng.standard_normal(n)), _t(rng.standard_normal(n))
    B = _t(rng.standard_normal((m, n)))
    tv, tw = _tree(v, h), _tree(w, h)
    tb = {"b": B[:, h:], "a": B[:, :h].reshape(m, 2, -1)}
    assert torch.allclose(tpt.tree_dot(tv, tw), torch.dot(v, w), rtol=1e-14)
    assert torch.allclose(tpt.tree_norm(tv), torch.linalg.norm(v), rtol=1e-14)
    assert torch.allclose(_flat(tpt.tree_axpy(2.0, tv, tw)), w + 2.0 * v)
    assert torch.allclose(_flat(tpt.tree_sub(tv, tw)), v - w)
    assert torch.allclose(_flat(tpt.tree_add(tv, tw)), v + w)
    assert torch.allclose(_flat(tpt.tree_scale(3.0, tv)), 3.0 * v)
    assert not _flat(tpt.tree_zeros_like(tv)).any()
    assert torch.allclose(tpt.basis_dot(tb, tv), B @ v, rtol=1e-14)
    c = _t(rng.standard_normal(m))
    assert torch.allclose(_flat(tpt.basis_combine(tb, c)), c @ B)
    assert torch.allclose(tpt.gram(tb, tb), B @ B.T, rtol=1e-14)
    assert torch.equal(tpt.ravel_basis(tb), torch.cat([B[:, :h], B[:, h:]], 1))
    mat = _t(rng.standard_normal((m, 3)))
    assert torch.allclose(tpt.ravel_basis(tpt.basis_matmul(tb, mat)), mat.T @ B)
    assert tpt.basis_size(tb) == m
    assert torch.equal(_flat(tpt.basis_vector(tb, 2)), B[2])
    both = tpt.basis_concat(tb, tpt.basis_zeros(tv, 2))
    assert tpt.basis_size(both) == m + 2 and not tpt.ravel_basis(both)[m:].any()
    set1 = tpt.basis_set(tb, tv, 1)
    assert torch.equal(tpt.ravel_basis(set1)[1], v) and torch.equal(tpt.ravel_basis(tb)[1], B[1])
    assert tpt.basis_size(tpt.basis_slice(tb, 2)) == 2
    s = _t(rng.standard_normal(m))
    assert torch.allclose(tpt.ravel_basis(tpt.basis_scale_columns(tb, s)), s[:, None] * B)
    mapped = tpt.basis_map_vectors(lambda t: tpt.tree_scale(2.0, t), tb)
    assert torch.allclose(tpt.ravel_basis(mapped), 2.0 * B)
    stacked = tpt.basis_from_vectors([tv, tw])
    assert torch.equal(tpt.ravel_basis(stacked), torch.stack([v, w]))
    g = torch.Generator().manual_seed(0)
    rand = tpt.tree_random_like(g, tv)
    assert rand["a"].shape == tv["a"].shape and rand["b"].dtype == torch.float64


def test_defcg_structure_invariance():
    """Flat and dict-pytree def-CG of one system at a fixed iteration
    count: the same numbers (1e-10), the window in the vector's structure,
    and the reference's pytree run (to rounding)."""
    n, k, ell, iters, h = 96, 5, 10, 40, 48
    rng = np.random.default_rng(23)
    amat, _, _ = make_spd(n, 1e2, rng)
    b = rng.standard_normal(n)
    wq = np.linalg.qr(rng.standard_normal((n, k)))[0].T
    A = _t(amat)
    # The flat run's operator applies A vector by vector, as the pytree
    # run's does (a dense operator's one-GEMM basis product would sum the
    # setup's A·W in another order).
    flat = tc.defcg(tc.from_callable(lambda v: A @ v), _t(b), W=_t(wq).contiguous(), ell=ell,
                    tol=0.0, maxiter=iters)

    def tree_matvec(tree):
        out = A @ _flat(tree)
        return _tree(out, h)

    w_tree = {"b": _t(wq[:, h:]), "a": _t(wq[:, :h]).reshape(k, 2, -1)}
    tree = tc.defcg(tree_matvec, _tree(_t(b), h), W=w_tree, ell=ell, tol=0.0, maxiter=iters)
    assert int(flat.info.iterations) == int(tree.info.iterations) == iters
    np.testing.assert_allclose(flat.x.numpy(), _flat(tree.x).numpy(), rtol=1e-10, atol=1e-10)
    assert tuple(tree.recycle.P["a"].shape) == (ell, 2, h // 2)
    np.testing.assert_allclose(flat.recycle.P.numpy(), tpt.ravel_basis(tree.recycle.P).numpy(),
                               rtol=1e-10, atol=1e-10)
    Aj = jnp.asarray(amat)

    def j_matvec(t):
        out = Aj @ jnp.concatenate([t["a"].ravel(), t["b"]])
        return {"a": out[:h].reshape(2, -1), "b": out[h:]}

    bj = jnp.asarray(b)
    ref = jc.defcg(j_matvec, {"a": bj[:h].reshape(2, -1), "b": bj[h:]},
                   W={"a": jnp.asarray(wq[:, :h]).reshape(k, 2, -1), "b": jnp.asarray(wq[:, h:])},
                   ell=ell, tol=0.0, maxiter=iters)
    # Across packages the 40 fixed steps (tol 0, far past convergence) sum
    # in another order: the two agree to rounding amplified by the steps.
    np.testing.assert_allclose(_flat(tree.x).numpy(),
                               np.concatenate([np.ravel(ref.x["a"]), np.asarray(ref.x["b"])]),
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("precond", [False, True])
def test_cg_structure_invariance(precond):
    n, h = 64, 30
    rng = np.random.default_rng(5)
    A = _t(make_spd(n, 1e2, rng)[0])
    b = _t(rng.standard_normal(n))
    d = torch.diagonal(A).clone()
    M = (lambda r: r / d) if precond else None
    flat = tc.cg(tc.from_matrix(A), b, tol=0.0, maxiter=30, M=M)
    tree = tc.cg(lambda t: _tree(A @ _flat(t), h), _tree(b, h), tol=0.0, maxiter=30,
                 M=None if M is None else (lambda t: _tree(M(_flat(t)), h)),
                 x0=_tree(torch.zeros(n, dtype=torch.float64), h))
    np.testing.assert_allclose(flat.x.numpy(), _flat(tree.x).numpy(), rtol=1e-10, atol=1e-12)


def test_lsmr_pytree_rhs_and_domain():
    """LSMR across ravel / unravel pairs on both sides: dict-structured b
    and x round-trip to the flat solve's answer."""
    m, n = 40, 25
    rng = np.random.default_rng(16)
    A = _t(rng.standard_normal((m, n)))
    b = _t(rng.standard_normal(m))

    def mv(v):
        out = A @ torch.cat([v["a"], v["b"]])
        return {"top": out[:25], "bot": out[25:]}

    def rmv(u):
        flat = A.T @ torch.cat([u["top"], u["bot"]])
        return {"a": flat[:10], "b": flat[10:]}

    op = tc.LinearOperator(matvec=mv, rmatvec=rmv)
    res = tc.lsmr(op, {"top": b[:25], "bot": b[25:]}, tol=1e-12, maxiter=300)
    flat = tc.lsmr(tc.from_matrix(A), b, tol=1e-12, maxiter=300)
    np.testing.assert_allclose(torch.cat([res.x["a"], res.x["b"]]).numpy(), flat.x.numpy(),
                               atol=1e-10)
    assert set(res.x) == {"a", "b"} and res.x["a"].shape == (10,)


def test_front_doors_take_pytrees():
    """solve (defcg, cg) and solve_sequence on dict right-hand sides give
    the flat solves' answers in the input's structure."""
    n, h = 64, 20
    rng = np.random.default_rng(9)
    A = _t(make_spd(n, 1e2, rng)[0])
    bs = _t(rng.standard_normal((3, n)))
    op = lambda t: _tree(A @ _flat(t), h)  # noqa: E731
    spec = tc.SolveSpec(k=4, ell=8, tol=1e-10, maxiter=500)
    flat = tc.solve(tc.from_matrix(A), bs[0], spec)
    tree = tc.solve(op, _tree(bs[0], h), spec)
    np.testing.assert_allclose(_flat(tree.x).numpy(), flat.x.numpy(), rtol=1e-10, atol=1e-12)
    assert int(tree.info.iterations) == int(flat.info.iterations)
    tree2 = tc.solve(op, _tree(bs[1], h), spec, tree.state)
    flat2 = tc.solve(tc.from_matrix(A), bs[1], spec, flat.state)
    assert int(tree2.info.iterations) == int(flat2.info.iterations)
    cg = tc.solve(op, _tree(bs[0], h), tc.SolveSpec(method="cg", tol=1e-10))
    np.testing.assert_allclose(_flat(cg.x).numpy(), flat.x.numpy(), rtol=1e-8, atol=1e-10)
    mats = A.expand(3, n, n)
    seq_flat = tc.solve_sequence(mats, bs, spec, make_operator=tc.from_matrix)
    seq_tree = tc.solve_sequence(mats, {"b": bs[:, h:], "a": bs[:, :h].reshape(3, 2, -1)},
                                 spec, make_operator=lambda m: (lambda t: _tree(m @ _flat(t), h)))
    assert tuple(seq_tree.x["a"].shape) == (3, 2, h // 2)
    np.testing.assert_allclose(
        torch.cat([seq_tree.x["a"].reshape(3, -1), seq_tree.x["b"]], 1).numpy(),
        seq_flat.x.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(seq_tree.info.iterations.numpy(),
                                  seq_flat.info.iterations.numpy())
