"""The port's public ``repro_torch.core`` surface against the reference's.

Mirrors ``tests/test_api_surface.py`` (the ``__all__`` snapshot, the
``SolveSpec`` / ``SolveReport`` schemas, the one jitter default) and
``tests/test_recycle_numerics.py`` (the harmonic-Ritz numerics, the
recycled solve's κ_eff bound, prefill + decode against the forward), and
holds the names this surface added against the reference:
``harmonic_ritz`` on pytree and flat bases (f64: θ to 1e-10, span(W) by
its projector to 1e-10), ``materialize`` (the dense matrix exactly) and
``random_orthonormal_basis`` (orthonormal to 1e-12, the same for the same
seed).

``__all__`` is the reference's list plus ``PORT_ONLY``; ``NOT_PORTED``
is empty since the compiled doors (the ``*_jit`` names) are in.
``RecycleManager``'s fields are the reference's, ``use_jit=True`` among
them.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax.config.update("jax_enable_x64", True)

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core import pytree as jpt  # noqa: E402
from repro_torch.core import pytree as tpt  # noqa: E402
from repro_torch.core import recycle as trecycle  # noqa: E402
from repro_torch.core.solvers import DEFAULT_WAW_JITTER  # noqa: E402

# Names of the reference's surface the port lacks: none (the compiled
# entry points run each masked loop as CUDA graphs, core/engine.py).
NOT_PORTED = ()
# The matrix-free RBF system operator: the reference builds it inside
# repro.gp; the port exports it beside the other operators.
PORT_ONLY = ("RBFKernelSystemOperator",)

EXPECTED_SOLVESPEC_FIELDS = {
    "method": "defcg", "k": 8, "ell": 12, "tol": 1e-5, "atol": 0.0, "maxiter": 1000,
    "select": "largest", "waw_jitter": DEFAULT_WAW_JITTER, "refresh_aw": "exact",
    "precond": "none", "precond_rank": 16, "precond_sigma": 1.0,
    "strategy": tcore.HarmonicRitz(), "recovery_rungs": 3, "recovery_shift": 1e-6,
    "stagnation_window": 0, "lsq_shift": 0.0,
}


def test_solvereport_field_schema():
    assert tcore.SolveReport._fields == jcore.SolveReport._fields == (
        "status", "rung", "guard_firings", "matvecs")


def test_core_all_snapshot():
    assert set(NOT_PORTED) <= set(jcore.__all__)
    want = sorted((set(jcore.__all__) - set(NOT_PORTED)) | set(PORT_ONLY))
    assert sorted(tcore.__all__) == want


def test_core_all_resolves():
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name


EXPECTED_MANAGER_FIELDS = {
    "k": dataclasses.MISSING, "ell": dataclasses.MISSING, "select": "largest", "tol": 1e-5,
    "maxiter": 1000, "waw_jitter": DEFAULT_WAW_JITTER, "refresh_aw": "exact",
    "strategy": tcore.HarmonicRitz(), "use_jit": True, "state": None, "systems_solved": 0,
    "_has_aw": False,
}


def test_recycle_manager_field_schema():
    fields = {f.name: f.default for f in dataclasses.fields(tcore.RecycleManager)}
    assert fields == EXPECTED_MANAGER_FIELDS
    ref = [f.name for f in dataclasses.fields(jcore.RecycleManager)]
    assert [f.name for f in dataclasses.fields(tcore.RecycleManager)] == ref
    assert tcore.RecycleManager(k=2, ell=4).use_jit is True


def test_solvespec_field_schema():
    fields = {f.name: f.default for f in dataclasses.fields(tcore.SolveSpec)}
    assert fields == EXPECTED_SOLVESPEC_FIELDS
    ref = {f.name: f.default for f in dataclasses.fields(jcore.SolveSpec)}
    assert {k: v for k, v in ref.items() if k != "strategy"} == {
        k: v for k, v in fields.items() if k != "strategy"}


def test_solvespec_frozen_and_hashable():
    spec = tcore.SolveSpec()
    assert hash(spec) == hash(tcore.SolveSpec())
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.k = 5  # type: ignore[misc]


def test_waw_jitter_never_forks():
    assert DEFAULT_WAW_JITTER == jcore.DEFAULT_WAW_JITTER == 1e-12
    assert tcore.SolveSpec().waw_jitter == DEFAULT_WAW_JITTER
    assert inspect.signature(tcore.defcg).parameters["waw_jitter"].default == DEFAULT_WAW_JITTER
    assert (inspect.signature(trecycle.solve_sequence).parameters["waw_jitter"].default
            == DEFAULT_WAW_JITTER)
    assert tcore.RecycleManager(k=2, ell=4).waw_jitter == DEFAULT_WAW_JITTER


def _spd(n, k, span, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.concatenate([np.linspace(1.0, 10.0, n - k), np.logspace(3, 3 + span, k)])
    return (q * eigs) @ q.T, eigs, rng


@pytest.mark.parametrize("n, k, span, seed", [(64, 2, 2.0, 0), (120, 5, 3.5, 11),
                                              (200, 8, 5.0, 4242)])
def test_theta_positive_and_outliers_found(n, k, span, seed):
    """``tests/test_recycle_numerics.py``'s property at fixed draws: the
    extraction from a long recording window returns positive Ritz values,
    the top one near the top eigenvalue."""
    a, eigs, rng = _spd(n, k, span, seed)
    res = tcore.defcg(tcore.from_matrix(torch.as_tensor(a)),
                      torch.as_tensor(rng.standard_normal(n)), tol=1e-10, maxiter=20 * n,
                      ell=3 * k)
    m = int(res.recycle.stored)
    W, AW, theta = tcore.harmonic_ritz(res.recycle.P[:m], res.recycle.AP[:m], k)
    th = np.sort(theta.numpy())[::-1]
    assert (th > 0).all()
    np.testing.assert_allclose(th[0], eigs[-1], rtol=0.05)


def test_recycled_solve_meets_kappa_eff_bound():
    n, k = 256, 8
    a, _, rng = _spd(n, k, 2.0, 3)
    A = tcore.from_matrix(torch.as_tensor(a))
    mgr = tcore.RecycleManager(k=k, ell=3 * k, tol=1e-5, maxiter=10000)
    mgr.solve(A, torch.as_tensor(rng.standard_normal(n)))
    b2 = torch.as_tensor(rng.standard_normal(n))
    rec = mgr.solve(A, b2)
    fresh = tcore.cg(A, b2, tol=1e-5, maxiter=10000)
    bound = 1.5 * 0.5 * np.sqrt(10.0) * np.log(2.0 / 1e-5)
    assert int(rec.info.iterations) <= bound
    assert int(rec.info.iterations) < 0.5 * int(fresh.info.iterations)
    np.testing.assert_allclose((torch.as_tensor(a) @ rec.x).numpy(), b2.numpy(),
                               atol=1e-4 * float(torch.linalg.vector_norm(b2)))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-1.3b"])
def test_prefill_then_decode_matches_forward(arch):
    from repro_torch import models
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.layers import lm_head_weights

    cfg = get_smoke_config(arch)
    b, s = 2, 24
    model = models.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        hidden, _ = models.forward_hidden(model, {"tokens": tokens}, cfg)
        full = hidden @ lm_head_weights(model.embed, cfg)
        state = models.init_decode_state(cfg, b, max_len=s, device="cpu")
        state, pre = models.prefill(model, {"tokens": tokens[:, : s - 1]}, state, cfg)
        dec, state = models.decode_step(model, tokens[:, s - 1 :], state, cfg)
    v = full.shape[-1]
    np.testing.assert_allclose(pre[:, 0, :v].float().numpy(), full[:, s - 2].float().numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(dec[:, 0, :v].float().numpy(), full[:, s - 1].float().numpy(),
                               rtol=2e-2, atol=2e-2)


def _window(n=90, m=16, seed=5):
    """A recording window of def-CG on an SPD matrix with outliers: (A, Z,
    AZ) as numpy, m rows of n."""
    a, _, rng = _spd(n, 4, 3.0, seed)
    res = tcore.defcg(tcore.from_matrix(torch.as_tensor(a)),
                      torch.as_tensor(rng.standard_normal(n)), tol=1e-12, maxiter=10 * n, ell=m)
    return a, res.recycle.P[:m].numpy(), res.recycle.AP[:m].numpy()


def _projector(w):
    q, _ = np.linalg.qr(np.asarray(w, np.float64).T)
    return q @ q.T


@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("select", ["largest", "smallest"])
def test_harmonic_ritz_matches_reference(tree, select):
    a, z, az = _window()
    k = 4
    split = 50  # the pytree case: two leaves, {"a": (50,), "b": (8, 5)}

    def as_tree(rows, lib):
        if not tree:
            return lib(rows)
        return {"a": lib(rows[:, :split]), "b": lib(rows[:, split:].reshape(-1, 8, 5))}

    jW, jAW, jtheta = jcore.harmonic_ritz(as_tree(z, jnp.asarray),
                                          as_tree(az, jnp.asarray), k, select=select)
    tW, tAW, ttheta = tcore.harmonic_ritz(as_tree(z, torch.as_tensor),
                                          as_tree(az, torch.as_tensor), k, select=select)
    if tree:
        assert set(tW) == {"a", "b"} and tuple(tW["b"].shape) == (k, 8, 5)
    flat_t = lambda b: tpt.ravel_basis(b).numpy()  # noqa: E731
    flat_j = lambda b: np.asarray(jpt.ravel_basis(b))  # noqa: E731
    np.testing.assert_allclose(np.sort(ttheta.numpy()), np.sort(np.asarray(jtheta)),
                               rtol=1e-10, atol=0)
    assert np.abs(_projector(flat_t(tW)) - _projector(flat_j(jW))).max() <= 1e-10
    # Unit rows, and AW the A-products of W's rows.
    for name, w, aw in (("port", flat_t(tW), flat_t(tAW)), ("ref", flat_j(jW), flat_j(jAW))):
        assert np.allclose(np.linalg.norm(w, axis=1), 1.0, atol=1e-12), name
        assert np.abs(aw - w @ a).max() <= 1e-8 * np.abs(aw).max(), name
    with pytest.raises(ValueError, match="cannot extract"):
        tcore.harmonic_ritz(torch.as_tensor(z[:3]), torch.as_tensor(az[:3]), k)


def test_materialize_is_the_dense_matrix():
    a, _, _ = _spd(30, 3, 2.0, 7)
    at = torch.as_tensor(a)
    assert torch.equal(tcore.materialize(tcore.from_matrix(at), torch.zeros(30, dtype=at.dtype)),
                       at)
    # A pytree operator: {"u": (10,), "v": (4, 5)} raveled in leaf order.
    template = {"u": torch.zeros(10, dtype=at.dtype), "v": torch.zeros(4, 5, dtype=at.dtype)}
    _, unravel = tpt.ravel_vector(template)
    op = lambda t: unravel(at @ tpt.ravel(t))  # noqa: E731
    assert torch.equal(tcore.materialize(op, template), at)
    want = np.asarray(jcore.materialize(lambda v: jnp.asarray(a) @ v, jnp.zeros(30)))
    np.testing.assert_array_equal(tcore.materialize(tcore.from_matrix(at),
                                                    torch.zeros(30, dtype=at.dtype)).numpy(), want)


@pytest.mark.parametrize("tree", [False, True])
def test_random_orthonormal_basis(tree):
    template = ({"w": torch.zeros(6, 7, dtype=torch.float64),
                 "b": torch.zeros(9, dtype=torch.float64)} if tree
                else torch.zeros(51, dtype=torch.float64))
    basis = tcore.random_orthonormal_basis(torch.Generator().manual_seed(3), template, 5)
    again = tcore.random_orthonormal_basis(torch.Generator().manual_seed(3), template, 5)
    other = tcore.random_orthonormal_basis(torch.Generator().manual_seed(4), template, 5)
    flat = tpt.ravel_basis(basis)
    assert flat.shape == (5, 51)
    if tree:
        assert tuple(basis["w"].shape) == (5, 6, 7) and tuple(basis["b"].shape) == (5, 9)
    assert float((flat @ flat.T - torch.eye(5, dtype=flat.dtype)).abs().max()) <= 1e-12
    assert torch.equal(flat, tpt.ravel_basis(again))
    assert not torch.equal(flat, tpt.ravel_basis(other))
