"""The step arms of K6 and K2, and K6's pair arm, on the CPU.

K6 (``fused_rz_reduce``) and K2 (``fused_deflate_direction``) each gained
an arm that carries a piece of the solver loops' tail in the same launch:
``fused_rz_step`` (the preconditioned def-CG and cg tail after
``z = M⁻¹r``: ``rᵀz``, β, μ and the recorded α / β) and
``fused_direction_step`` (the direction update with the ``p`` select and
the recording slot); K6's ``fused_rz_pair`` gives the sharded def-CG's four
fresh reductions in one read.  On the CPU their wrappers run the plain
versions.  Here:

1. the plain versions against the loops' former inline lines, bit for
   bit, f32 and f64, k ∈ {0, 1, 8}, in live, frozen, breakdown, spare-row
   (a frozen recording step) and ``rs = 0`` states;
2. a torch emulation of K6's one-launch reduction order
   (``tests/torch_reduction_order.py``, shared with K1): bit for bit the
   same for any block completion order, the pair's columns those of two
   one-vector grids, and the sums within 1e-13 of the plain ones;
3. whole preconditioned ``defcg`` (Jacobi and Nyström, deflated, with a
   window) and ``cg(M=…)`` solves against the live JAX reference on the
   same numpy inputs: x to 1e-10 (``tests/test_cg_fused.py:316``);
   iterations, statuses, ``SolveInfo.matvecs`` and the recorded window
   equal (the window to 1e-10);
4. the sharded def-CG on one rank: one pair call a step, and the solve
   bit for bit the one with the two one-vector calls it replaced;
5. the new entry points run the plain versions on CPU tensors, and
   ``backend="cuda"`` refuses them.

The card holds the kernels to these plain versions
(``tests/test_torch_cuda.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import torch_reduction_order as ro  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.kernels import cg_fused as cf  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from tests.conftest import make_spd  # noqa: E402

sharded = importlib.import_module("repro_torch.core.sharded")
DTYPES = [torch.float64, torch.float32]
ELL = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread for the module: its products are vector
    reductions, and beside the suite's other workers (six, of eight threads
    each, on eight cores) a pool of all cores waits on every parallel region."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(a, b):
    """Bit for bit, NaN where NaN."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.dtype.is_floating_point:
        return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
            torch.nan_to_num(a), torch.nan_to_num(b))
    return torch.equal(a, b)


# ---------------------------------------------------------------------------
# 1. The plain step arms against the loops' former inline lines
# ---------------------------------------------------------------------------

CASES = ["live", "frozen", "breakdown", "spare-row", "rs0"]


def _state(dtype, k, case, seed):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=dtype)

    n = 29
    r, z, p, ap = (rnd(n) for _ in range(4))
    aw = rnd(k, n) if k else None
    w, mu = (rnd(k, n), rnd(k)) if k else (None, None)
    waw_inv = rnd(k, k) if k else None
    rs = torch.zeros((), dtype=dtype) if case == "rs0" else torch.dot(r, r)
    alpha, beta = rnd(()), rnd(())
    active = torch.tensor(case not in ("frozen", "spare-row"))
    keep = torch.tensor(case not in ("frozen", "spare-row", "breakdown"))
    row = 1 if case in ("live", "spare-row", "breakdown") else None
    return dict(r=r, z=z, p=p, ap=ap, aw=aw, w=w, mu=mu, waw_inv=waw_inv, rs=rs, alpha=alpha,
                beta=beta, active=active, keep=keep, row=row)


def _former_rz_tail(r, z, rs, aw, waw_inv, alpha, active, row, rows):
    """The preconditioned def-CG loop's lines after ``z = M(r)``, as the
    loop ran them inline (``fused_rz_reduce``, the μ GEMV, β, the slot and
    the two row writes)."""
    rs_new, awr = tref.fused_rz_reduce(r, z, aw)
    mu = waw_inv @ awr if aw is not None else None
    beta = rs_new / torch.where(rs == 0.0, 1.0, rs)
    if row is not None:
        slot = torch.where(active, row, ELL).to(torch.int64)
        rows[0].index_copy_(0, slot.reshape(1), alpha.reshape(1))
        rows[1].index_copy_(0, slot.reshape(1), beta.reshape(1))
    return rs_new, beta, mu


def _former_direction(z, p, beta, keep, w, mu, ap, active, row, bufs):
    """The loops' direction lines, as they ran them inline: the slot, the
    direction update (recording into the buffers) and the ``p`` select."""
    if row is None:
        p_new, _, _ = cf.fused_deflate_direction_plain(z, p, beta, w, mu)
    else:
        slot = torch.where(active, row, ELL).to(torch.int64)
        p_new, _, _ = cf.fused_deflate_direction_plain(z, p, beta, w, mu, ap, slot, *bufs)
    return torch.where(keep, p_new, p)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [0, 1, 8])
@pytest.mark.parametrize("case", CASES)
def test_fused_rz_step_plain_is_the_former_loop_lines(dtype, k, case):
    s = _state(dtype, k, case, 11 * k + len(case))
    rows_a = (torch.zeros(ELL + 1, dtype=dtype), torch.zeros(ELL + 1, dtype=dtype))
    rows_b = tuple(t.clone() for t in rows_a)
    kw = {} if s["row"] is None else dict(row=s["row"], a_rows=rows_a[0], b_rows=rows_a[1])
    so = kops.fused_rz_step(s["r"], s["z"], s["rs"], s["aw"], s["waw_inv"], alpha=s["alpha"],
                            active=s["active"], **kw)
    rs_new, beta, mu = _former_rz_tail(s["r"], s["z"], s["rs"], s["aw"], s["waw_inv"],
                                       s["alpha"], s["active"], s["row"], rows_b)
    assert so.shape == (2 + k,) and so.dtype == dtype
    assert _same(so[0], rs_new) and _same(so[1], beta)
    assert _same(so[2:], mu if mu is not None else so.new_zeros(0))
    assert _same(rows_a[0], rows_b[0]) and _same(rows_a[1], rows_b[1])
    if case == "spare-row":
        assert _same(rows_a[0][ELL], s["alpha"]) and not bool(rows_a[0][:ELL].any())
    # cg's former line: rᵀz by pytree.tree_dot.
    assert _same(so[0], tc.pytree.tree_dot(s["r"], s["z"]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [0, 1, 8])
@pytest.mark.parametrize("case", CASES)
def test_fused_direction_step_plain_is_the_former_loop_lines(dtype, k, case):
    s = _state(dtype, k, case, 13 * k + len(case))
    g = torch.Generator().manual_seed(k)
    bufs_a = [torch.randn(ELL + 1, 29, generator=g, dtype=dtype) for _ in range(2)]
    bufs_b = [t.clone() for t in bufs_a]
    kw = ({} if s["row"] is None else
          dict(ap=s["ap"], active=s["active"], row=s["row"], p_buf=bufs_a[0], ap_buf=bufs_a[1]))
    po = kops.fused_direction_step(s["z"], s["p"], s["beta"], s["keep"], s["w"], s["mu"], **kw)
    want = _former_direction(s["z"], s["p"], s["beta"], s["keep"], s["w"], s["mu"], s["ap"],
                             s["active"], s["row"], bufs_b)
    assert _same(po, want)
    assert po.data_ptr() != s["p"].data_ptr()  # a fresh po, as the kernel writes
    assert _same(bufs_a[0], bufs_b[0]) and _same(bufs_a[1], bufs_b[1])
    if not bool(s["keep"]):
        assert _same(po, s["p"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [0, 1, 8])
def test_fused_rz_pair_plain_is_two_one_vector_calls(dtype, k):
    g = torch.Generator().manual_seed(k)
    r, ap = torch.randn(31, generator=g, dtype=dtype), torch.randn(31, generator=g, dtype=dtype)
    aw = torch.randn(k, 31, generator=g, dtype=dtype) if k else None
    got = kops.fused_rz_pair(r, ap, aw)
    want = kops.fused_rz_reduce(r, ap, aw) + kops.fused_rz_reduce(r, r, aw)
    for a, b in zip(got, want):
        assert (a is None and b is None) or _same(a, b)


# ---------------------------------------------------------------------------
# 2. K6's one-launch reduction, emulated
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 1000, 36551])
@pytest.mark.parametrize("grid", [1, 3, 143])
@pytest.mark.parametrize("vec", [None, 2])
@pytest.mark.parametrize("k", [0, 8, 16])
def test_k6_reduction_order(n, grid, vec, k):
    """The sums and pair arms' columns: the same bits for any block
    completion order, the pair's columns those of the two one-vector
    grids (the launcher gives every arm the pair arm's grid), and within
    1e-13 of the plain sums."""
    g = torch.Generator().manual_seed(n + grid + k)
    r, ap = torch.randn(n, generator=g, dtype=torch.float64), torch.randn(
        n, generator=g, dtype=torch.float64)
    aw = torch.randn(k, n, generator=g, dtype=torch.float64)
    by_z = torch.cat([(r * ap)[None], aw * ap[None]])
    by_r = torch.cat([(r * r)[None], aw * r[None]])
    pair_prods = torch.cat([by_z, by_r])
    wide = k > 8
    orders = [torch.randperm(grid, generator=torch.Generator().manual_seed(s)).tolist()
              for s in range(3)]
    pairs = [ro.emulate_sums(pair_prods, grid, vec, o, wide) for o in orders]
    assert all(torch.equal(pairs[0], p) for p in pairs[1:])
    one_z = ro.emulate_sums(by_z, grid, vec, orders[1], wide)
    one_r = ro.emulate_sums(by_r, grid, vec, orders[2], wide)
    assert torch.equal(pairs[0], torch.cat([one_z, one_r]))
    want = torch.cat([torch.dot(r, ap)[None], aw @ ap, torch.dot(r, r)[None], aw @ r])
    scale = pair_prods.abs().sum(dim=1)
    assert bool(((pairs[0] - want).abs() <= 1e-13 * scale).all())


# ---------------------------------------------------------------------------
# 3. Whole preconditioned solves against the JAX reference
# ---------------------------------------------------------------------------


# Condition number of the whole-solve systems.  Counts are held equal, so
# the systems converge in about half n iterations: near n and past it a
# preconditioned count at tol 1e-10 moves with rounding in either package
# (ROADMAP P1; R4: the reference's own count moves by 3 with how M is
# written), and tests/test_torch_precond.py holds such counts to ±3.
COND = 10.0


def _nystrom_pair(A, rank, mu):
    """The reference's Nyström sketch of ``A`` and the port's preconditioner
    on the same sketch (a sketch is random: ``tests/test_torch_precond.py``)."""
    import jax

    Aj = jnp.asarray(A)
    U, lam = jc.randomized_nystrom(lambda v: Aj @ v, jnp.zeros(A.shape[0]), rank,
                                   jax.random.PRNGKey(4))
    Ut, lamt = convert.nystrom_sketch_from_numpy(U, lam, dtype=torch.float64, device="cpu")
    return jc.nystrom_preconditioner(U, lam, mu), tc.nystrom_preconditioner(Ut, lamt, mu)


def _preconditioners(kind, A):
    if kind == "jacobi":
        diag = np.diag(A).copy()
        return jc.jacobi(jnp.asarray(diag)), tc.jacobi(_t(diag))
    return _nystrom_pair(A, 8, 1.0)


def _assert_info_equal(ji, ti):
    for field in ("iterations", "matvecs", "status", "converged"):
        np.testing.assert_array_equal(
            _np(getattr(ti, field)), np.asarray(getattr(ji, field)), err_msg=field)


@pytest.mark.parametrize("kind", ["jacobi", "nystrom"])
@pytest.mark.parametrize("case", ["deflated-window", "cold-window", "deflated"])
def test_preconditioned_defcg_matches_reference(kind, case):
    rng = np.random.default_rng(5 + len(case) + len(kind))
    n, k = 60, 4
    A, _, _ = make_spd(n, COND, rng)
    b = rng.standard_normal(n)
    kw = dict(tol=1e-10, maxiter=600, record_residuals=True, ell=0 if case == "deflated" else 6)
    jargs = targs = (None, None)
    if case != "cold-window":
        W = np.linalg.qr(rng.standard_normal((n, k)))[0].T
        jargs = (jnp.asarray(W), jnp.asarray(W @ A))
        targs = (_t(W).contiguous(), _t(W @ A).contiguous())
    jm, tm = _preconditioners(kind, A)
    ref = jc.defcg(jc.from_matrix(jnp.asarray(A)), jnp.asarray(b), None, *jargs,
                   flat_recycle=True, M=jm, **kw)
    got = tc.defcg(tc.from_matrix(_t(A)), _t(b), None, *targs, M=tm, **kw)
    _assert_info_equal(ref.info, got.info)
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)
    if kw["ell"]:
        assert int(got.recycle.stored) == int(ref.recycle.stored)
        for field in ("P", "AP", "alpha", "beta"):
            np.testing.assert_allclose(_np(getattr(got.recycle, field)),
                                       np.asarray(getattr(ref.recycle, field)), atol=1e-10,
                                       err_msg=field)


@pytest.mark.parametrize("kind", ["jacobi", "nystrom"])
def test_preconditioned_cg_matches_reference(kind):
    rng = np.random.default_rng(21 + len(kind))
    n = 50
    A, _, _ = make_spd(n, COND, rng)
    b = rng.standard_normal(n)
    jm, tm = _preconditioners(kind, A)
    ref = jc.cg(jc.from_matrix(jnp.asarray(A)), jnp.asarray(b), tol=1e-10, maxiter=400, M=jm)
    got = tc.cg(tc.from_matrix(_t(A)), _t(b), tol=1e-10, maxiter=400, M=tm)
    _assert_info_equal(ref.info, got.info)
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), atol=1e-10)


def test_preconditioned_loops_end_in_the_step_arms(monkeypatch):
    """Every step of the preconditioned loops, live or frozen, is one
    ``fused_rz_step`` and one ``fused_direction_step`` call, and nothing
    else of K6 or K2."""
    calls = {"fused_rz_step": 0, "fused_direction_step": 0, "fused_rz_reduce": 0,
             "fused_deflate_direction": 0}
    for name in calls:
        fn = getattr(kops, name)

        def counting(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(kops, name, counting)
    rng = np.random.default_rng(8)
    A, _, _ = make_spd(40, 1e2, rng)
    b = rng.standard_normal(40)
    W = np.linalg.qr(rng.standard_normal((40, 3)))[0].T
    M = tc.jacobi(_t(np.diag(A).copy()))
    got = tc.defcg(tc.from_matrix(_t(A)), _t(b), None, _t(W).contiguous(),
                   _t(W @ A).contiguous(), ell=5, tol=1e-10, maxiter=300, M=M)
    its = int(got.info.iterations)
    steps = 5 + engine.CHUNK * -(-(its - 5) // engine.CHUNK)
    assert calls == {"fused_rz_step": steps, "fused_direction_step": steps,
                     "fused_rz_reduce": 0, "fused_deflate_direction": 0}


# ---------------------------------------------------------------------------
# 4. The sharded def-CG on one rank
# ---------------------------------------------------------------------------


class _OneRank:
    """A solve mesh of one rank: every collective is the identity."""

    size = 1

    def all_reduce(self, t):
        return t


def _sharded_solve(A, b, W, ell):
    return sharded._sharded_defcg(
        lambda v: A @ v, lambda w: w @ A.T, _OneRank(), b, torch.zeros_like(b), W, W @ A,
        k=W.shape[0], ell=ell, tol=1e-10, atol=0.0, maxiter=300, select="largest",
        waw_jitter=1e-12, refresh_aw="stale", record_residuals=True)


@pytest.mark.parametrize("ell", [0, 6])
def test_sharded_defcg_pair_is_the_two_reductions(monkeypatch, ell):
    rng = np.random.default_rng(12 + ell)
    A, _, _ = make_spd(48, 1e2, rng)
    At, b = _t(A), _t(rng.standard_normal(48))
    W = _t(np.linalg.qr(rng.standard_normal((48, 4)))[0].T).contiguous()
    pair = kops.fused_rz_pair
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return pair(*args, **kwargs)

    monkeypatch.setattr(kops, "fused_rz_pair", counting)
    got = _sharded_solve(At, b, W, ell)
    steps = len(calls)
    assert steps >= int(got[1].iterations) > 0

    def two_calls(r, ap, aw):  # the loop's former two K6 calls
        return kops.fused_rz_reduce(r, ap, aw) + kops.fused_rz_reduce(r, r, aw)

    monkeypatch.setattr(kops, "fused_rz_pair", two_calls)
    want = _sharded_solve(At, b, W, ell)
    assert int(got[1].iterations) == int(want[1].iterations)
    assert int(got[1].status) == int(want[1].status)
    for a, w in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        assert _same(a, w)
    # ... and the unsharded def-CG on the same system.
    ref = tc.defcg(tc.from_matrix(At), b, None, W, W @ At, ell=ell, tol=1e-10, maxiter=300)
    assert int(got[1].iterations) == int(ref.info.iterations)
    np.testing.assert_allclose(_np(got[0]), _np(ref.x), atol=1e-10)


# ---------------------------------------------------------------------------
# 5. The entry points dispatch by device and never fall back
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["auto", "plain", "reference"])
def test_new_entry_points_run_the_plain_version_on_the_cpu(backend):
    s = _state(torch.float64, 3, "live", 3)
    rows = dict(row=1, a_rows=torch.zeros(ELL + 1, dtype=torch.float64),
                b_rows=torch.zeros(ELL + 1, dtype=torch.float64))
    got = kops.fused_rz_step(s["r"], s["z"], s["rs"], s["aw"], s["waw_inv"], alpha=s["alpha"],
                             active=s["active"], backend=backend, **rows)
    want = cf.fused_rz_step_plain(s["r"], s["z"], s["rs"], s["aw"], s["waw_inv"])
    assert _same(got, want) and _same(rows["b_rows"][1], got[1])
    got = kops.fused_direction_step(s["z"], s["p"], s["beta"], s["keep"], s["w"], s["mu"],
                                    backend=backend)
    assert _same(got, cf.fused_direction_step_plain(s["z"], s["p"], s["beta"], s["keep"],
                                                    s["w"], s["mu"]))
    got = kops.fused_rz_pair(s["r"], s["ap"], s["aw"], backend=backend)
    assert all(_same(a, b) for a, b in zip(got, cf.fused_rz_pair_plain(s["r"], s["ap"], s["aw"])))


def test_new_entry_points_refuse_cuda_on_cpu_tensors():
    s = _state(torch.float64, 3, "live", 4)
    with pytest.raises(ValueError, match="CUDA"):
        kops.fused_rz_step(s["r"], s["z"], s["rs"], s["aw"], s["waw_inv"], backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        kops.fused_direction_step(s["z"], s["p"], s["beta"], s["keep"], backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        kops.fused_rz_pair(s["r"], s["ap"], s["aw"], backend="cuda")
    # The wrappers themselves refuse a CPU tensor: no fallback.
    for call in (lambda: cf.fused_rz_step_cuda(s["r"], s["z"], s["rs"], s["aw"], s["waw_inv"]),
                 lambda: cf.fused_direction_step_cuda(s["z"], s["p"], s["beta"], s["keep"]),
                 lambda: cf.fused_rz_pair_cuda(s["r"], s["ap"], s["aw"]),
                 lambda: cf.fused_rz_reduce_cuda(s["r"], s["z"], s["aw"])):
        with pytest.raises(ValueError, match="CUDA kernel called on a cpu tensor"):
            call()
