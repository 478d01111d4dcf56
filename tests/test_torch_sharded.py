"""The port's sharded Krylov engine against the live JAX reference.

Mirrors ``tests/test_sharded_engine.py``.  The port's ranks are processes
on ``torch.distributed`` with gloo on the CPU, started by
:func:`repro_torch.launch.run_ranks`: one spawn per world size (1, 4 and
8 ranks) runs every case of ``tests/torch_sharded_cases.py`` (which
imports no JAX), each spawn under its own time limit.  The reference is
the UNSHARDED ``repro.core.solve`` fed the same numpy inputs, because the
sharded reference has fault R3 (ROADMAP).  Bars, from the reference's own
test: x to 1e-10 (the n = 64 system and the RBF operator; 1e-9 where a
state crosses group sizes, R3), cg and def-CG iterations within one and
matvecs within two, LSMR iterations within five and matvecs within ten,
equal statuses, def-CG bases sign-aligned and θ to 1e-10, every rank
reporting the same count.  The collective contract is measured by
difference: at tol 0, runs of N and N + 8 iterations differ by exactly 8
all-reduces and 8 all-gathers (cg, def-CG) or 16 of each (LSMR).

K8's plain version is held here too, against
``repro.kernels.ops.rbf_matvec_rect`` (``impl="reference"`` and the Pallas
kernel in interpret mode) at ragged shapes: f64 against the oracle to
1e-12; f32, and anything against the Pallas kernel (which accumulates in
f32), to 2e-4 relative / 5e-4 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_sharded_cases as cases  # noqa: E402
from conftest import make_spd  # noqa: E402
from repro.core.api import SolveSpec, solve  # noqa: E402
from repro.core.operators import (  # noqa: E402
    DenseMatrixOperator,
    RBFKernelSystemOperator,
)
from repro.core.recycle import RecycleState  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _runtime  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import make_solve_mesh, run_ranks  # noqa: E402

WORLD_SIZES = [1, 4, 8]
SPAWN_TIMEOUT_S = 90.0  # per collective; the whole spawn gets twice it


def _dense_inputs():
    """``tests/test_sharded_engine.py::_system()`` and its next draw."""
    rng = np.random.default_rng(0)
    a_np, _, _ = make_spd(64, cond=50.0, rng=rng)
    b = rng.standard_normal(64)
    return a_np, b, rng.standard_normal(64)


def _rbf_inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((256, 3))
    sqrt_h = 0.5 + rng.random(256)
    return x, sqrt_h, rng.standard_normal(256)


@pytest.fixture(scope="module", params=WORLD_SIZES, ids=lambda ws: f"world{ws}")
def world(request):
    """Every case of one world size, from one spawn of that many ranks."""
    out = run_ranks(
        cases.all_cases, request.param, backend="gloo", device="cpu",
        args=(_dense_inputs(), _rbf_inputs()), timeout_s=SPAWN_TIMEOUT_S,
    )
    out["world_size"] = request.param
    return out


@pytest.fixture(scope="module")
def ref():
    """The unsharded JAX reference on the same inputs."""
    a_np, b_np, b2_np = _dense_inputs()
    A = DenseMatrixOperator(mat=jnp.asarray(a_np))
    b, b2 = jnp.asarray(b_np), jnp.asarray(b2_np)
    cold = RecycleState.zeros(4, 64, jnp.float64)
    out = {"parity": {}}
    for method in ("cg", "defcg", "lsmr"):
        spec = SolveSpec(method=method, k=4, ell=6, tol=1e-12, maxiter=300)
        out["parity"][method] = solve(A, b, spec, cold)
    out["state"] = solve(
        A, b, SolveSpec(method="defcg", k=4, ell=6, tol=1e-10, maxiter=200), cold
    ).state
    spec = SolveSpec(method="defcg", k=4, ell=8, tol=1e-8, maxiter=200)
    first = solve(A, b, spec, cold)
    out["recycle"] = (first, solve(A, b2, spec, first.state))
    for key, tol in (("damped", 1e-10), ("damped_tight", 1e-12)):
        out[key] = solve(A, b, SolveSpec(method="lsmr", tol=tol, maxiter=300, lsq_shift=1e-2))
    out["x0_trace"] = solve(
        A, b, SolveSpec(method="defcg", k=4, ell=6, tol=1e-8, maxiter=200), cold,
        x0=b2, record_residuals=True,
    )
    x, sqrt_h, b_rbf = _rbf_inputs()
    A_rbf = RBFKernelSystemOperator(
        x=jnp.asarray(x), sqrt_h=jnp.asarray(sqrt_h), theta=1.3, lengthscale=1.1,
        impl="chunked", block=64,
    )
    out["rbf"] = solve(
        A_rbf, jnp.asarray(b_rbf),
        SolveSpec(method="defcg", k=4, ell=6, tol=1e-9, maxiter=400),
        RecycleState.zeros(4, 256, jnp.float64),
    )
    return out


def _counts_close(got, want, slack):
    assert abs(got["iterations"] - int(want.info.iterations)) <= slack
    assert abs(got["matvecs"] - int(want.info.matvecs)) <= 2 * slack
    assert got["converged"] and bool(want.info.converged)
    assert got["status"] == int(want.info.status)
    assert len(set(got["rank_iterations"])) == 1, got["rank_iterations"]


# ---------------------------------------------------------------------------
# the solve group
# ---------------------------------------------------------------------------


def test_mesh_takes_the_whole_world(world):
    m = world["mesh"]
    assert m["size"] == world["world_size"]
    assert (m["rank"], m["device"], m["backend"]) == (0, "cpu", "gloo")


def test_mesh_explicit_counts(world):
    ws = world["world_size"]
    assert world["mesh"]["explicit"] == list(range(1, ws + 1))
    assert world["mesh"]["members"] == [True] + [False] * (ws - 1)


def test_mesh_out_of_range_counts_raise(world):
    for raised in world["mesh"]["out_of_range"]:
        assert raised is not None and raised[0] == "ValueError"
        assert "out of range" in raised[1]


def test_non_member_rank_refuses_to_solve(world):
    got = world["mesh"]["non_member"]
    assert got[0] is None  # rank 0 is the subgroup's member and solves
    for raised in got[1:]:
        assert raised[0] == "ValueError" and "not a member" in raised[1]


def test_mesh_layout_helpers(world):
    h = world["mesh"]["helpers"]
    assert h["vector_roundtrip"] == 0.0 and h["state_roundtrip"] == 0.0
    assert h["local_shape"] == (4, 8)
    assert h["convert_matches"]


def test_mesh_needs_an_initialized_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_solve_mesh(device="cpu")


# ---------------------------------------------------------------------------
# parity with the unsharded reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["cg", "defcg", "lsmr"])
def test_sharded_matches_unsharded(world, ref, method):
    got, want = world["dense"]["parity"][method], ref["parity"][method]
    np.testing.assert_allclose(got["x"], np.asarray(want.x), rtol=0, atol=1e-10)
    _counts_close(got, want, 5 if method == "lsmr" else 1)


def test_sharded_defcg_state_matches_up_to_row_sign(world, ref):
    got, want = world["dense"]["state"], ref["state"]
    w_r = np.asarray(want.W)
    signs = np.sign(np.sum(w_r * got["W"], axis=1))
    np.testing.assert_allclose(got["W"] * signs[:, None], w_r, atol=1e-10)
    np.testing.assert_allclose(got["AW"] * signs[:, None], np.asarray(want.AW), atol=1e-10)
    np.testing.assert_allclose(got["theta"], np.asarray(want.theta), atol=1e-10)
    assert got["systems_solved"] == int(want.systems_solved) == 1


def test_recycling_win_survives_sharding(world, ref):
    got = world["dense"]["recycle"]
    ref1, ref2 = ref["recycle"]
    assert got["second"]["iterations"] < got["first"]["iterations"]
    _counts_close(got["first"], ref1, 1)
    _counts_close(got["second"], ref2, 1)
    np.testing.assert_allclose(got["second"]["x"], np.asarray(ref2.x), rtol=0, atol=1e-10)


def test_state_reshards_across_group_sizes(world, ref):
    """A state made at this world size, gathered whole, feeds a one-rank
    group and an unsharded solve; both land on the unsharded reference's
    second solve (whose state came from its own first solve) at 1e-9."""
    got, ref2 = world["dense"]["reshard"], ref["recycle"][1]
    want = np.asarray(ref2.x)
    np.testing.assert_allclose(got["size_1"]["x"], want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["unsharded"], want, rtol=0, atol=1e-9)
    assert abs(got["size_1"]["iterations"] - world["dense"]["recycle"]["second"]["iterations"]) <= 1
    assert abs(got["size_1"]["iterations"] - int(ref2.info.iterations)) <= 1


def test_sharded_lsmr_damped_parity(world, ref):
    """Ridge λ = 1e-2 at the reference test's tol 1e-10.  LSMR stops on the
    normal residual, ‖N x − Aᵀb‖ ≤ tol·‖Aᵀb‖ with N = AᵀA + λI, so each
    iterate lies within tol·‖Aᵀb‖/λ_min(N) of the ridge solution and two
    of them within twice that.  At this tol the reference itself is 1.9e-9
    from the solution, and the port's world-4 iterate 1.8e-9 from the
    reference (1e-9 missed: ROADMAP P6, with the numbers); at tol 1e-12
    both agree to 1e-10."""
    a_np, b_np, _ = _dense_inputs()
    atb = a_np.T @ b_np
    lam_min = np.linalg.eigvalsh(a_np.T @ a_np).min() + 1e-2
    got, want = world["dense"]["damped"], ref["damped"]
    gap = np.linalg.norm(got["x"] - np.asarray(want.x))
    assert gap <= 2 * 1e-10 * np.linalg.norm(atb) / lam_min, gap
    _counts_close(got, want, 5)
    got, want = world["dense"]["damped_tight"], ref["damped_tight"]
    np.testing.assert_allclose(got["x"], np.asarray(want.x), rtol=0, atol=1e-10)
    _counts_close(got, want, 5)


def test_sharded_x0_and_trace_parity(world, ref):
    got, want = world["dense"]["x0_trace"], ref["x0_trace"]
    np.testing.assert_allclose(got["x"], np.asarray(want.x), rtol=0, atol=1e-6)
    j = min(got["iterations"], int(want.info.iterations))
    prefix = min(j, 25)
    np.testing.assert_allclose(
        got["trace"][:prefix], np.asarray(want.info.residual_norms)[:prefix], rtol=1e-6
    )
    _counts_close(got, want, 1)


def test_rbf_operator_sharded_parity(world, ref):
    got, want = world["rbf"], ref["rbf"]
    np.testing.assert_allclose(got["x"], np.asarray(want.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got["unsharded_x"], np.asarray(want.x), rtol=0, atol=1e-10)
    _counts_close(got, want, 1)
    assert abs(got["matvecs"] - int(want.info.matvecs)) <= 1


def test_rbf_operator_runs_k8_plain_on_every_rank(world):
    """On the CPU each rank's products take K8's plain version; nothing
    counts as a launch or as a plain version run on the card."""
    for launches, plain in zip(world["rbf"]["launches"], world["rbf"]["plain_on_cuda"]):
        assert not any(launches.values()) and not any(plain.values())


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "case, kind, match",
    [
        ("deflsmr", "NotImplementedError", "no sharded path"),
        ("M", "ValueError", "no preconditioner"),
        ("precond", "ValueError", "no preconditioner"),
        ("not_a_mesh", "ValueError", "SolveMesh"),
        ("operator", "TypeError", "shards the operator"),
        ("state_shape", "ValueError", "state and spec must agree"),
    ],
)
def test_front_door_refuses(world, case, kind, match):
    raised = world["dense"]["errors"][case]
    assert raised is not None and raised[0] == kind and match in raised[1]


def test_indivisible_n_raises(world):
    raised = world["dense"]["errors"]["indivisible"]
    if world["world_size"] == 1:
        assert raised is None
    else:
        assert raised[0] == "ValueError" and "not divisible" in raised[1]


# ---------------------------------------------------------------------------
# communication: collectives counted per iteration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method, reduces, gathers",
                         [("cg", 1, 1), ("defcg", 1, 1), ("lsmr", 2, 2)])
def test_collectives_per_iteration(world, method, reduces, gathers):
    """cg and def-CG: one all-reduce (the merged psum) and one all-gather
    (the product's input) per iteration; LSMR: two of each."""
    (its_a, count_a), (its_b, count_b) = world["dense"]["contract"][method]
    step = cases.CONTRACT_ITERS
    assert (its_a, its_b) == (step, 2 * step)
    assert count_b["all_reduce"] - count_a["all_reduce"] == reduces * step
    assert count_b["all_gather"] - count_a["all_gather"] == gathers * step


# ---------------------------------------------------------------------------
# K8: the plain version against the reference's kernel
# ---------------------------------------------------------------------------

K8_SHAPES = [(37, 91, 5, 1), (64, 200, 3, 8), (13, 129, 17, 3)]


@pytest.mark.parametrize("impl", ["reference", "interpret"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("m, n, d, r", K8_SHAPES)
def test_rbf_matvec_rect_plain_matches_reference(impl, dtype, m, n, d, r):
    rng = np.random.default_rng(m * n + d)
    xr = rng.random((m, d)).astype(dtype)
    xc = rng.random((n, d)).astype(dtype)
    v = rng.standard_normal((n, r)).astype(dtype)
    v = v[:, 0] if r == 1 else v
    want = np.asarray(jops.rbf_matvec_rect(
        jnp.asarray(xr), jnp.asarray(xc), jnp.asarray(v), 1.7, 0.9, impl=impl, block=16
    ))
    got = tops.rbf_matvec_rect(
        torch.from_numpy(xr), torch.from_numpy(xc), torch.from_numpy(v), 1.7, 0.9, block=16
    ).numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    if dtype == "float64" and impl == "reference":
        np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-12)
    else:
        # The Pallas kernel accumulates in f32 whatever its input's dtype
        # (rbf_matvec.py:_rbf_matvec_kernel), so in interpret mode it is
        # held, as tests/test_kernels.py holds it, to the f32 bars.
        np.testing.assert_allclose(got / scale, want / scale, rtol=2e-4, atol=5e-4)


def test_rbf_matvec_rect_row_blocks_make_the_square_product():
    """The identity the sharded operator rests on: the ranks' row blocks
    K(X_rows, X) v, stacked, are the square K(X, X) v (plain versions)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((96, 5)))
    v = torch.from_numpy(rng.standard_normal((96, 2)))
    full = tops.rbf_matvec(x, v, 1.1, 0.8, block=16)
    blocks = torch.cat([tops.rbf_matvec_rect(x[i : i + 24], x, v, 1.1, 0.8, block=16)
                        for i in range(0, 96, 24)])
    torch.testing.assert_close(blocks, full, rtol=0, atol=1e-14)


def test_rbf_matvec_rect_backends_on_cpu():
    """``auto`` takes the plain version on CPU tensors and counts nothing;
    ``cuda`` refuses a CPU tensor; the oracle agrees."""
    g = torch.Generator().manual_seed(0)
    xr = torch.rand(21, 4, generator=g, dtype=torch.float64)
    xc = torch.rand(50, 4, generator=g, dtype=torch.float64)
    v = torch.randn(50, 2, generator=g, dtype=torch.float64)
    before = (dict(_runtime.LAUNCHES), dict(_runtime.PLAIN_ON_CUDA))
    got = tops.rbf_matvec_rect(xr, xc, v, 1.2, 0.8, block=8)
    want = tops.rbf_matvec_rect(xr, xc, v, 1.2, 0.8, backend="reference")
    assert (dict(_runtime.LAUNCHES), dict(_runtime.PLAIN_ON_CUDA)) == before
    torch.testing.assert_close(got, want, rtol=0, atol=1e-13)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.rbf_matvec_rect(xr, xc, v, 1.2, 0.8, backend="cuda")


def _damped_witness():
    """ROADMAP P6: damped LSMR at tol 1e-10 and 1e-12 — the reference, the
    port unsharded and sharded at 1, 4 and 8 ranks, each against the exact
    ridge solution and against the reference (max abs)."""
    a_np, b_np, _ = _dense_inputs()
    exact = np.linalg.solve(a_np.T @ a_np + 1e-2 * np.eye(64), a_np.T @ b_np)
    tols = (1e-10, 1e-12)
    A = DenseMatrixOperator(mat=jnp.asarray(a_np))
    for tol in tols:
        ref = solve(A, jnp.asarray(b_np), SolveSpec(method="lsmr", tol=tol, maxiter=300,
                                                   lsq_shift=1e-2))
        x_ref = np.asarray(ref.x)
        print(f"tol {tol:g}: reference {int(ref.info.iterations)} iterations, "
              f"{np.abs(x_ref - exact).max():.2e} from the ridge solution")
        for ws in WORLD_SIZES:
            got = run_ranks(cases.damped_lsmr_case, ws, backend="gloo", device="cpu",
                            args=(a_np, b_np, (tol,)), timeout_s=SPAWN_TIMEOUT_S)[tol]
            for name, (x, its) in got.items():
                if name == "unsharded" and ws > 1:
                    continue
                label = name if name == "unsharded" else f"sharded x{ws}"
                print(f"  port {label:11s} {its} iterations, {np.abs(x - exact).max():.2e} "
                      f"from the solution, {np.abs(x - x_ref).max():.2e} from the reference")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_enable_x64", True)
    _damped_witness()

