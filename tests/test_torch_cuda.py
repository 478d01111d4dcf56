"""The port's Hopper kernels against their plain versions, on the card.

Marked ``cuda``: here, without a card, every test skips.  On a machine
with an H100 run them with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the GPU
machine does not need to have).  Tolerances: f64 1e-12 relative, f32
2e-4 (the Pallas tolerance of ``tests/test_cg_fused.py``); the f32 RBF
Gram matvec 2e-4 relative / 5e-4 absolute (``tests/test_kernels.py``).
``self_gram`` and ``recombine_blocks`` are held up to 128 stacked rows,
the windows of the least-squares path (lsq_bench's k + ℓ = 56 gives 112);
``self_gram`` must also be exactly symmetric and repeat bit for bit.
``rbf_matvec_rect`` (K8) is held at ``chip_smoke.py``'s shapes (the
sharded main path's per-rank blocks at 4 and 8 ranks, the paper's n at
4 ranks, a ragged block), and one sharded def-CG solve runs on one rank
over NCCL against the unsharded solve on the card.  ``flash_attention``
(K9) and ``ssd_scan`` (K10) are held against their plain versions in f32
(2e-4 / 5e-4) and bf16 (2e-2 / 5e-2), the tolerances of
``tests/test_kernels.py`` (relative to the output's scale for the SSD
scan), on GQA, causal decode with ``q_offset``, ragged lengths and the
serving path's shapes, K9 at head dims 16 to 160 (stablelm-12b's);
both must repeat bit for bit.  The MoE layer's dispatch and combine
(``models/moe.py``, gathers both ways) give the same gradients bit for bit
on two backward passes on the card.  The step arms of
K1, K6, K2 and K7 and K6's pair arm are held against their plain versions
(the scalars bit for bit), and each arm must be one device kernel a call;
K1's and K7's armed with the stall detector (``window > 0``) in stalling
states too: the window-0 outputs unchanged, STAGNATED latched on the
plain version's step.  The lane axis of K1's, K6's, K2's and K7's step
arms (``tests/torch_lane_cases.py``): at B = 1, 8 and 64 every lane bit
for bit the one-lane arm on that lane's data, against the lane-by-lane
plain versions, one device kernel a call; K3 and K8 behind a gate of device
flags: zeros with every flag off, the ungated product bit for bit with
any one on.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_sharded_cases as cases  # noqa: E402
from repro_torch.kernels import _runtime, cg_fused  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import rbf_matvec as rbf  # noqa: E402
from repro_torch.launch import run_ranks  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-12, torch.float32: 2e-4}
DTYPES = [torch.float64, torch.float32]
SIZES = [36551, 1000, 1]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen(device, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return lambda *shape: torch.randn(*shape, generator=g, device=device, dtype=dtype)


def _assert_close(got, want, dtype):
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max()) / scale
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k", [0, 1, 8])
def test_fused_cg_update(device, dtype, n, k):
    rnd = _gen(device, dtype, n + k)
    x, r, p, ap = (rnd(n) for _ in range(4))
    aw = rnd(k, n) if k else None
    alpha = rnd(())
    got = cg_fused.fused_cg_update_cuda(x, r, p, ap, alpha, aw)
    want = cg_fused.fused_cg_update_plain(x, r, p, ap, alpha, aw)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            _assert_close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k", [0, 1, 8, 16])
def test_fused_rz_reduce(device, dtype, n, k):
    rnd = _gen(device, dtype, 3 * n + k)
    r, z = rnd(n), rnd(n)
    aw = rnd(k, n) if k else None
    got = cg_fused.fused_rz_reduce_cuda(r, z, aw)
    want = cg_fused.fused_rz_reduce_plain(r, z, aw)
    _assert_close(got[0], want[0], dtype)
    if k:
        _assert_close(got[1], want[1], dtype)
    else:
        assert got[1] is None


STEP_SIZES = [1, 1000, 36551, 36552]  # odd n: element loads; 36 552: 16-byte groups


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", STEP_SIZES)
@pytest.mark.parametrize("k", [0, 1, 8, 16])
def test_fused_rz_pair(device, dtype, n, k):
    """K6's pair arm: bit for bit two calls of the one-vector arm (the same
    grid and order), to the kernel bar against its plain version, two
    launches bit for bit, one counted launch per call."""
    rnd = _gen(device, dtype, 5 * n + k)
    r, ap = rnd(n), rnd(n)
    aw = rnd(k, n) if k else None
    got = cg_fused.fused_rz_pair_cuda(r, ap, aw)
    one_ap = cg_fused.fused_rz_reduce_cuda(r, ap, aw)
    one_r = cg_fused.fused_rz_reduce_cuda(r, r, aw)
    want = cg_fused.fused_rz_pair_plain(r, ap, aw)
    assert torch.equal(got[0], one_ap[0]) and torch.equal(got[2], one_r[0])
    if k:
        assert torch.equal(got[1], one_ap[1]) and torch.equal(got[3], one_r[1])
        _assert_close(got[1], want[1], dtype)
        _assert_close(got[3], want[3], dtype)
    else:
        assert got[1] is None and got[3] is None
    _assert_close(got[0], want[0], dtype)
    _assert_close(got[2], want[2], dtype)
    again = cg_fused.fused_rz_pair_cuda(r, ap, aw)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))
    before = cg_fused.LAUNCHES["fused_rz_reduce"]
    kops.fused_rz_pair(r, ap, aw)
    assert cg_fused.LAUNCHES["fused_rz_reduce"] == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", STEP_SIZES)
@pytest.mark.parametrize("k", [0, 1, 8, 16])
@pytest.mark.parametrize("case", ["live", "recording", "frozen-recording", "rs0"])
def test_fused_rz_step(device, dtype, n, k, case):
    """K6's step arm against its plain version (the preconditioned loops'
    former eager lines): rs' bit for bit the one-vector arm's rᵀz, β bit for
    bit rs' / safe(rs), μ bit for bit in its fixed order from the
    one-vector arm's sums and to the kernel bar against the plain GEMV,
    the recorded α / β rows bit for bit, two launches bit for bit, one
    counted launch per call."""
    rnd = _gen(device, dtype, 23 * n + k + len(case))
    r, z = rnd(n), rnd(n)
    aw = rnd(k, n) if k else None
    waw_inv = rnd(k, k) if k else None
    rs = torch.zeros((), dtype=dtype, device=device) if case == "rs0" else torch.dot(r, r)
    alpha = rnd(())
    active = torch.tensor(case != "frozen-recording", device=device)
    ell = 4

    def run(step):
        rows = {}
        if "recording" in case:
            rows = dict(row=1, a_rows=torch.zeros(ell + 1, dtype=dtype, device=device),
                        b_rows=torch.zeros(ell + 1, dtype=dtype, device=device))
        return step(r, z, rs, aw, waw_inv, alpha=alpha, active=active, **rows), rows

    so, rows_k = run(cg_fused.fused_rz_step_cuda)
    sw, rows_p = run(cg_fused.fused_rz_step_plain)
    rz, awz = cg_fused.fused_rz_reduce_cuda(r, z, aw)
    assert so.shape == (2 + k,)
    assert torch.equal(so[0], rz)
    assert torch.equal(so[1], so[0] / torch.where(rs == 0.0, 1.0, rs))
    _assert_close(so, sw, dtype)
    if k:
        mu = torch.zeros(k, dtype=dtype, device=device)
        for j in range(k):
            mu = mu + waw_inv[:, j] * awz[j]
        assert torch.equal(so[2:], mu)
    if rows_k:
        slot = 1 if bool(active) else ell
        assert torch.equal(rows_k["a_rows"], rows_p["a_rows"])
        assert torch.equal(rows_k["b_rows"][slot], so[1])
        assert torch.equal(rows_k["b_rows"] != 0, rows_p["b_rows"] != 0)
    again, _ = run(cg_fused.fused_rz_step_cuda)
    assert torch.equal(so, again)
    before = cg_fused.LAUNCHES["fused_rz_reduce"]
    kops.fused_rz_step(r, z, rs, aw, waw_inv)
    assert cg_fused.LAUNCHES["fused_rz_reduce"] == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ndr", [(4000, 784, 1), (4000, 784, 8), (1000, 50, 24),
                                 (1000, 50, 33), (257, 13, 3), (1, 5, 1),
                                 (36551, 784, 1), (36551, 784, 8), (36551, 784, 24)])
def test_rbf_matvec(device, dtype, ndr):
    n, d, r = ndr
    rnd = _gen(device, dtype, n + d + r)
    x, v = rnd(n, d), rnd(n, r)
    got = rbf.rbf_matvec_cuda(x, v, 3.0, 3.0 * d**0.5 / 6.0)
    want = rbf.rbf_matvec_plain(x, v, 3.0, 3.0 * d**0.5 / 6.0)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=5e-4)
    else:
        _assert_close(got, want, dtype)
    assert torch.equal(got, rbf.rbf_matvec_cuda(x, v, 3.0, 3.0 * d**0.5 / 6.0))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r", [1, 8, 33])
@pytest.mark.parametrize("d", [3, 13, 784])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 256, 257, 300])
def test_rbf_matvec_tile_edges(device, dtype, n, d, r):
    """Either side of the 128-row tiles, the 16/32-feature stages (d = 3,
    13: element copies; 784: 16-byte copies) and the 16-column V chunks;
    the symmetric K3 against its plain version and K8's full grid on the
    same X, and bitwise repeats."""
    rnd = _gen(device, dtype, 7 * n + d + r)
    x, v = rnd(n, d), rnd(n, r)
    ls = 3.0 * d**0.5 / 6.0
    got = rbf.rbf_matvec_cuda(x, v, 3.0, ls)
    want = rbf.rbf_matvec_plain(x, v, 3.0, ls)
    full = rbf.rbf_matvec_rect_cuda(x, x, v, 3.0, ls)
    for out in (got, full):
        if dtype == torch.float32:
            torch.testing.assert_close(out, want, rtol=2e-4, atol=5e-4)
        else:
            _assert_close(out, want, dtype)
    assert torch.equal(got, rbf.rbf_matvec_cuda(x, v, 3.0, ls))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("budget", [0, 1 << 40])
@pytest.mark.parametrize("ndr", [(300, 784, 1), (1000, 50, 33), (257, 13, 8)])
def test_rbf_matvec_either_side_of_the_scratch_budget(device, dtype, budget, ndr, monkeypatch):
    """With no room for the column scratch K3 runs the square product on
    the full grid; with room, symmetric.  Both against the plain version,
    bit for bit on a repeat, and through K3's counter alone."""
    n, d, r = ndr
    monkeypatch.setattr(rbf, "SCRATCH_BYTES", budget)
    lengths = rbf.sym_lengths(-(-n // rbf.TILE))
    assert rbf._symmetric(n, lengths, r, 8) is (budget > 0)
    rnd = _gen(device, dtype, 3 * n + d + r)
    x, v = rnd(n, d), rnd(n, r)
    ls = 3.0 * d**0.5 / 6.0
    k3, k8 = cg_fused.LAUNCHES["rbf_matvec"], cg_fused.LAUNCHES["rbf_matvec_rect"]
    got = rbf.rbf_matvec_cuda(x, v, 3.0, ls)
    assert cg_fused.LAUNCHES["rbf_matvec"] == k3 + 1
    assert cg_fused.LAUNCHES["rbf_matvec_rect"] == k8
    want = rbf.rbf_matvec_plain(x, v, 3.0, ls)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=5e-4)
    else:
        _assert_close(got, want, dtype)
    assert torch.equal(got, rbf.rbf_matvec_cuda(x, v, 3.0, ls))


@pytest.mark.parametrize("r", [1, 24])
def test_rbf_matvec_at_the_scale_phase_n(device, r):
    """n = 131 072, d = 784, f64: r = 1 runs symmetric and r = 24 on the
    full grid (its column scratch would be 8.6 GB); both against the plain
    version and bit for bit on a repeat."""
    n, d = 131072, 784
    assert rbf._symmetric(n, rbf.sym_lengths(n // rbf.TILE), r, 8) is (r == 1)
    rnd = _gen(device, torch.float64, r)
    x, v = rnd(n, d), rnd(n, r)
    ls = 3.0 * d**0.5 / 6.0
    got = rbf.rbf_matvec_cuda(x, v, 3.0, ls)
    _assert_close(got, rbf.rbf_matvec_plain(x, v, 3.0, ls), torch.float64)
    assert torch.equal(got, rbf.rbf_matvec_cuda(x, v, 3.0, ls))


def test_rbf_matvec_vector_and_transposed_rhs(device):
    rnd = _gen(device, torch.float64, 5)
    x, v = rnd(700, 30), rnd(700)
    got = kops.rbf_matvec(x, v, 1.5, 2.0)
    assert got.shape == (700,)
    _assert_close(got, rbf.rbf_matvec_plain(x, v, 1.5, 2.0), torch.float64)
    basis = rnd(8, 700)
    _assert_close(kops.rbf_matvec(x, basis.T, 1.5, 2.0),
                  rbf.rbf_matvec_plain(x, basis.T, 1.5, 2.0), torch.float64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mnd", [(4096, 16384, 784), (2048, 16384, 784),
                                 (9138, 36552, 784), (1000, 3001, 784), (1, 5, 3)])
@pytest.mark.parametrize("r", [1, 8])
def test_rbf_matvec_rect(device, dtype, mnd, r):
    m, n, d = mnd
    rnd = _gen(device, dtype, m + n + r)
    xr, xc, v = rnd(m, d), rnd(n, d), rnd(n, r)
    ls = 3.0 * d**0.5 / 6.0
    k3 = cg_fused.LAUNCHES["rbf_matvec"]
    k8 = cg_fused.LAUNCHES["rbf_matvec_rect"]
    got = rbf.rbf_matvec_rect_cuda(xr, xc, v, 3.0, ls)
    assert cg_fused.LAUNCHES["rbf_matvec_rect"] == k8 + 1
    assert cg_fused.LAUNCHES["rbf_matvec"] == k3
    want = rbf.rbf_matvec_rect_plain(xr, xc, v, 3.0, ls)
    assert got.shape == (m, r)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=5e-4)
    else:
        _assert_close(got, want, dtype)
    assert torch.equal(got, rbf.rbf_matvec_rect_cuda(xr, xc, v, 3.0, ls))


def test_rbf_matvec_rect_square_case_is_k3(device):
    """With the same X for rows and columns K8 computes K3's product."""
    rnd = _gen(device, torch.float64, 2)
    x, v = rnd(700, 30), rnd(700, 3)
    _assert_close(kops.rbf_matvec_rect(x, x, v, 1.5, 2.0), kops.rbf_matvec(x, v, 1.5, 2.0),
                  torch.float64)


def test_sharded_defcg_on_one_nccl_rank(device):
    """The RBF system at n = 256 by sharded def-CG on one NCCL rank: every
    product through K8, no K3 and no plain version on the card, x to 1e-10
    of the unsharded solve on the card."""
    rng = np.random.default_rng(1)
    x, sqrt_h, b = rng.standard_normal((256, 3)), 0.5 + rng.random(256), rng.standard_normal(256)
    out = run_ranks(cases.rbf_case, 1, backend="nccl", device="cuda",
                    args=(x, sqrt_h, b, "cuda"), timeout_s=120)
    assert out["converged"]
    np.testing.assert_allclose(out["x"], out["unsharded_x"], rtol=0, atol=1e-10)
    (launches,), (plain,) = out["launches"], out["plain_on_cuda"]
    assert launches["rbf_matvec_rect"] > 0 and launches["rbf_matvec"] == 0
    assert launches["fused_cg_update"] > 0 and launches["self_gram"] > 0
    assert not any(plain.values())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k", [0, 8])
@pytest.mark.parametrize("buffered", [False, True])
def test_fused_deflate_direction(device, dtype, n, k, buffered):
    rnd = _gen(device, dtype, 7 * n + k)
    r, p, ap = (rnd(n) for _ in range(3))
    w, mu = (rnd(k, n), rnd(k)) if k else (None, None)
    beta = rnd(())
    idx = torch.tensor(3, device=device)
    bufs = [rnd(13, n) for _ in range(2)] if buffered else [None, None]
    plain_bufs = [None if b is None else b.clone() for b in bufs]
    got = cg_fused.fused_deflate_direction_cuda(r, p, beta, w, mu, ap, idx, *bufs)
    want = cg_fused.fused_deflate_direction_plain(r, p, beta, w, mu, ap, idx, *plain_bufs)
    _assert_close(got[0], want[0], dtype)
    if buffered:
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", STEP_SIZES)
@pytest.mark.parametrize("k", [0, 8, 16])
@pytest.mark.parametrize("case", ["live", "frozen", "breakdown", "recording", "frozen-recording"])
def test_fused_direction_step(device, dtype, n, k, case):
    """K2's step arm against its plain version (the loops' direction
    update, ``p`` select and recording slot): po bit for bit p where the
    step keeps p (frozen, breakdown), bit for bit the TPU-function arm's p'
    on a live step (one fused multiply-add a term) and to the kernel bar
    against the plain version's eager ops; the buffers bit for bit (the spare row on a frozen recording
    step); β and μ read from a view of a packed device vector; two
    launches bit for bit, one counted launch per call."""
    rnd = _gen(device, dtype, 29 * n + k + len(case))
    z, p, ap = rnd(n), rnd(n), rnd(n)
    w = rnd(k, n) if k else None
    packed = rnd(2 + k)  # [rs', β, μ…], as K6's step arm writes it
    beta, mu = packed[1], (packed[2:] if k else None)
    keep = torch.tensor(case in ("live", "recording"), device=device)
    active = torch.tensor(case != "frozen-recording", device=device)

    def run(step):
        bufs = {}
        if "recording" in case:
            g = _gen(device, dtype, 3)
            bufs = dict(ap=ap, active=active, row=2, p_buf=g(6, n), ap_buf=g(6, n))
        return step(z, p, beta, keep, w, mu, **bufs), bufs

    po, bk = run(cg_fused.fused_direction_step_cuda)
    pw, bp = run(cg_fused.fused_direction_step_plain)
    if bool(keep):
        tpu, _, _ = cg_fused.fused_deflate_direction_cuda(z, p, beta, w, mu)
        assert torch.equal(po, tpu)
    else:
        assert torch.equal(po, p) and torch.equal(pw, p)
    _assert_close(po, pw, dtype)
    if bk:
        assert torch.equal(bk["p_buf"], bp["p_buf"]) and torch.equal(bk["ap_buf"], bp["ap_buf"])
    again, _ = run(cg_fused.fused_direction_step_cuda)
    assert torch.equal(po, again)
    before = cg_fused.LAUNCHES["fused_deflate_direction"]
    kops.fused_direction_step(z, p, beta, keep, w, mu)
    assert cg_fused.LAUNCHES["fused_deflate_direction"] == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES + [31, 33])
@pytest.mark.parametrize("rows", [40, 24, 64, 1, 96, 112, 128, 7, 8, 9])
def test_self_gram(device, dtype, n, rows):
    # rows 7, 8, 9 and n 31, 33: either side of the 8-row tiles and the
    # 32-column shared-memory stages.
    s = _gen(device, dtype, n + rows)(rows, n)
    got = cg_fused.self_gram_cuda(s)
    _assert_close(got, cg_fused.self_gram_plain(s), dtype)
    assert torch.equal(got, got.T)
    assert torch.equal(got, cg_fused.self_gram_cuda(s))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mk", [(20, 8), (12, 8), (32, 16), (3, 1), (48, 8), (56, 8), (64, 16)])
def test_recombine_blocks(device, dtype, n, mk):
    m, k = mk
    rnd = _gen(device, dtype, n + m + k)
    s, u = rnd(2 * m, n), rnd(m, k)
    got = cg_fused.recombine_blocks_cuda(s, u)
    _assert_close(got, cg_fused.recombine_blocks_plain(s, u), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mkn", [(56, 8, 16384), (20, 8, 36551), (56, 8, 16383), (20, 8, 36553),
                                 (1, 1, 36551), (1, 16, 16383), (64, 1, 36551),
                                 (64, 16, 16385), (56, 16, 36551), (1, 8, 31)])
def test_recombine_blocks_main_shapes(device, dtype, mkn):
    """The least-squares window (2·56 rows × 16 384) and def-CG's (2·20 ×
    36 551), odd n, k ∈ {1, 8, 16} and m ∈ {1, 20, 56, 64}: against the
    plain version, and two launches bit for bit."""
    m, k, n = mkn
    rnd = _gen(device, dtype, m + 3 * k + n)
    s, u = rnd(2 * m, n), rnd(m, k)
    got = cg_fused.recombine_blocks_cuda(s, u)
    _assert_close(got, cg_fused.recombine_blocks_plain(s, u), dtype)
    assert torch.equal(got, cg_fused.recombine_blocks_cuda(s, u))


def test_gram_window_limit(device):
    """Stacked windows past 128 rows are refused, not mis-summed."""
    s = _gen(device, torch.float64, 1)(130, 100)
    with pytest.raises(ValueError, match="128"):
        cg_fused.self_gram_cuda(s)
    with pytest.raises(ValueError, match="128"):
        cg_fused.recombine_blocks_cuda(s, s[:65, :8].contiguous())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 1000, 16384, 1 << 20])
def test_lsmr_update(device, dtype, n):
    rnd = _gen(device, dtype, 11 * n)
    x, hbar, h, v = (rnd(n) for _ in range(4))
    c0, c1, c2 = rnd(()), rnd(()), rnd(())
    got = cg_fused.lsmr_update_cuda(x, hbar, h, v, c0, c1, c2)
    want = cg_fused.lsmr_update_plain(x, hbar, h, v, c0, c1, c2)
    for g, w in zip(got, want):
        _assert_close(g, w, dtype)
    before = cg_fused.LAUNCHES["lsmr_update"]
    kops.lsmr_update(x, hbar, h, v, 0.5, -0.25, 2.0)
    assert cg_fused.LAUNCHES["lsmr_update"] == before + 1


def _device_kernels(fn, reps=5):
    """Device kernels one call of ``fn`` runs: the difference between a
    ``torch.profiler`` trace of ``2 reps`` calls and one of ``reps``, over
    ``reps`` (after a warm-up call).  Profiler sessions now and then come
    back with no device events, or a constant few short on some machines;
    the difference cancels a constant loss, and a pair with no events or
    not a whole number of kernels a call is run again (three at most)."""
    from torch.profiler import ProfilerActivity, profile

    def count(calls):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if "cuda" in str(getattr(e, "device_type", "")).lower())

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        one, two = count(reps), count(2 * reps)
        if one and two and (two - one) % reps == 0:
            break
    return (two - one) / reps


def _lsmr_step_inputs(device, dtype, n, case):
    rnd = _gen(device, dtype, 17 * n + len(case))
    x, hbar, h, v, w = (rnd(n) for _ in range(5))
    s = rnd(len(cg_fused.LSMR_SLOTS)).abs() + 0.1
    beta = rnd(()).abs() + 0.1
    js = torch.tensor([3, 0], dtype=torch.int32, device=device)
    active = torch.tensor(case != "frozen", device=device)
    threshold = torch.tensor(1e-6, dtype=dtype, device=device)
    diverged_at = torch.tensor(1e8, dtype=dtype, device=device)
    if case == "beta0":  # exact termination: the latch zeroes zetabar
        beta = torch.zeros((), dtype=dtype, device=device)
    if case == "alpha0":
        w = torch.zeros_like(w)
    if case == "nonfinite":  # c̄ poisoned: the rotation and ζ̄ go NaN
        s[5] = float("nan")
    if case == "diverging":
        diverged_at = torch.tensor(1e-30, dtype=dtype, device=device)
    trace = torch.full((12,), float("nan"), dtype=dtype, device=device)
    return (x, hbar, h, v, w, torch.dot(w, w), beta, s, js, active, threshold, diverged_at, 10,
            trace)


def _equal_nan(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 1000, 16384, 16385])
@pytest.mark.parametrize("case", ["live", "frozen", "beta0", "alpha0", "nonfinite", "diverging"])
def test_lsmr_step(device, dtype, n, case):
    """K7's step arm against its plain version (the LSMR loop's former
    eager lines): every scalar, the status, j, the active flag and the
    trace slot bit for bit; the vectors to the kernel bar; two launches
    bit for bit; one counted launch per call."""
    args = _lsmr_step_inputs(device, dtype, n, case)
    t_got, t_want = args[-1].clone(), args[-1].clone()
    got = cg_fused.lsmr_step_cuda(*args[:-1], t_got)
    want = cg_fused.lsmr_step_plain(*args[:-1], t_want)
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(torch.isfinite(g), torch.isfinite(w))
        _assert_close(torch.nan_to_num(g), torch.nan_to_num(w), dtype)
    for g, w in zip(got[4:], want[4:]):
        assert _equal_nan(g, w), (g, w)
    assert _equal_nan(t_got, t_want)
    again = cg_fused.lsmr_step_cuda(*args[:-1], args[-1].clone())
    assert all(_equal_nan(a, b) for a, b in zip(got, again))
    before = cg_fused.LAUNCHES["lsmr_update"]
    kops.lsmr_step(*args)
    assert cg_fused.LAUNCHES["lsmr_update"] == before + 1


def _cg_step_inputs(device, dtype, n, k, case):
    rnd = _gen(device, dtype, 19 * n + k + len(case))
    x, r, p, ap = (rnd(n) for _ in range(4))
    aw = rnd(k, n) if k else None
    waw_inv = rnd(k, k) if k else None
    d = torch.dot(p, ap).abs() + 1.0
    rs = torch.dot(r, r)
    rnorm = torch.sqrt(rs)
    js = torch.tensor([2, 0], dtype=torch.int32, device=device)
    active = torch.tensor(case != "frozen", device=device)
    threshold = torch.tensor(1e-6, dtype=dtype, device=device)
    diverged_at = torch.tensor(1e8, dtype=dtype, device=device)
    if case == "indefinite":
        d = -d
    if case == "nonfinite":
        d = torch.tensor(float("nan"), dtype=dtype, device=device)
    if case == "diverging":
        diverged_at = torch.tensor(1e-30, dtype=dtype, device=device)
    if case == "rs0":
        rs = torch.zeros((), dtype=dtype, device=device)
    return (x, r, p, ap, d, rs, rnorm, js, active, threshold, diverged_at, 10, aw, waw_inv)


CG_STEP_CASES = [(k, case) for k in (0, 1, 8, 16)
                 for case in ("live", "frozen", "indefinite", "nonfinite", "diverging", "rs0",
                              "recording")] + [(0, "preconditioned")]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 1000, 36551, 36552])
@pytest.mark.parametrize("k,case", CG_STEP_CASES)
def test_fused_cg_step(device, dtype, n, k, case):
    """K1's step arm against its plain version (def-CG's former eager
    lines).  α, the status, j, the active and keep flags bit for bit; the
    scalars that follow the kernel's own sums (√rr, β = rr / safe(rs), μ in
    its fixed order) bit for bit from those sums, and the sums to the
    kernel bar; vectors to the kernel bar; the recorded α / β rows and the
    trace slot; a poisoned A·p zeroed; two launches bit for bit; one
    counted launch per call."""
    args = _cg_step_inputs(device, dtype, n, k, case)
    x, r, p, ap, d, rs, rnorm, js, active = args[:9]
    aw, waw_inv = args[12], args[13]
    ell = 4
    kw = {"recurrence": case != "preconditioned"}

    def run(step, ap_in):
        extra = dict(kw, trace=torch.full((12,), float("nan"), dtype=dtype, device=device))
        if case == "recording":
            extra.update(row=1, a_rows=torch.zeros(ell + 1, dtype=dtype, device=device),
                         b_rows=torch.zeros(ell + 1, dtype=dtype, device=device))
        out = step(*args[:3], ap_in, *args[4:], **extra)
        return out, extra

    (xo, ro, apo, so, jo, bo), ek = run(cg_fused.fused_cg_step_cuda, ap.clone())
    (xw, rw, apw, sw, jw, bw), ew = run(cg_fused.fused_cg_step_plain, ap.clone())
    for g, w in ((xo, xw), (ro, rw), (apo, apw)):
        assert torch.equal(torch.isfinite(g), torch.isfinite(w))
        _assert_close(torch.nan_to_num(g), torch.nan_to_num(w), dtype)
    if case == "nonfinite":
        assert not bool(apo.any())
    assert torch.equal(so[2], sw[2]) and torch.equal(jo, jw) and torch.equal(bo, bw)
    _assert_close(so[0], sw[0], dtype)
    rnorm_k = torch.where(active, torch.sqrt(so[0]), rnorm)
    assert torch.equal(so[1], rnorm_k)
    if kw["recurrence"]:
        assert torch.equal(so[3], so[0] / torch.where(rs == 0.0, 1.0, rs))
        _assert_close(so[3:], sw[3:], dtype)
        if k:
            _, _, rr2, awr = cg_fused.fused_cg_update_cuda(x, r, p, apo, so[2], aw)
            assert torch.equal(rr2, so[0])
            mu = torch.zeros(k, dtype=dtype, device=device)
            for j in range(k):
                mu = mu + waw_inv[:, j] * awr[j]
            assert torch.equal(so[4:], mu)
    assert torch.equal(torch.isnan(ek["trace"]), torch.isnan(ew["trace"]))
    _assert_close(torch.nan_to_num(ek["trace"]), torch.nan_to_num(ew["trace"]), dtype)
    if bool(active):
        assert torch.equal(ek["trace"][3], so[1])
    if case == "recording":
        assert torch.equal(ek["a_rows"], ew["a_rows"])
        assert torch.equal(ek["b_rows"][1], so[3])
    again, _ = run(cg_fused.fused_cg_step_cuda, ap.clone())
    assert all(_equal_nan(a, b) for a, b in zip((xo, ro, apo, so, jo, bo), again))
    before = cg_fused.LAUNCHES["fused_cg_update"]
    kops.fused_cg_step(*args[:3], ap.clone(), *args[4:], **kw)
    assert cg_fused.LAUNCHES["fused_cg_update"] == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_step_arms_run_one_device_kernel(device, dtype):
    """Each arm of K1, K6, K2 and K7 is one device kernel a call, the
    reductions included (``torch.profiler``, at the main paths' shapes: K1,
    K6 and K2 n = 36 551, k = 8 and k = 0, K6's pair arm main-shard's
    per-rank n = 4 096, K7 n = 16 384)."""
    cg = _cg_step_inputs(device, dtype, 36551, 8, "live")
    ls = _lsmr_step_inputs(device, dtype, 16384, "live")
    x, r, p, ap = cg[:4]
    aw, waw_inv, rs = cg[12], cg[13], cg[5]
    alpha = torch.tensor(0.3, dtype=dtype, device=device)
    c = [torch.tensor(q, dtype=dtype, device=device) for q in (0.5, -0.25, 2.0)]
    on = torch.tensor(True, device=device)
    so = cg_fused.fused_rz_step_cuda(r, p, rs, aw, waw_inv)
    aw4 = aw[:, :4096].contiguous()
    rec = dict(ap=ap, active=on, row=1, p_buf=torch.zeros(5, 36551, dtype=dtype, device=device),
               ap_buf=torch.zeros(5, 36551, dtype=dtype, device=device))
    rows = dict(row=1, a_rows=torch.zeros(5, dtype=dtype, device=device),
                b_rows=torch.zeros(5, dtype=dtype, device=device))
    # The armed arms' inputs, made before the profiled calls (an allocation
    # on the card would count as a kernel).
    cg_js, ls_js = _armed_js(cg[7]), _armed_js(ls[8])
    ls_s = torch.cat([ls[7], ls[7][1:2]])
    calls = {
        "K6 AW arm": lambda: cg_fused.fused_rz_reduce_cuda(r, p, aw),
        "K6 no-AW arm": lambda: cg_fused.fused_rz_reduce_cuda(r, p),
        "K6 step": lambda: cg_fused.fused_rz_step_cuda(r, p, rs, aw, waw_inv, alpha=alpha,
                                                       active=on, **rows),
        "K6 pair": lambda: cg_fused.fused_rz_pair_cuda(r[:4096], ap[:4096], aw4),
        "K2 step": lambda: cg_fused.fused_direction_step_cuda(r, p, so[1], on, aw,
                                                              so[2:]),
        "K2 step, recording": lambda: cg_fused.fused_direction_step_cuda(
            r, p, so[1], on, aw, so[2:], **rec),
        "K2 step, k = 0": lambda: cg_fused.fused_direction_step_cuda(r, p, so[1], on),
        "K1 step": lambda: cg_fused.fused_cg_step_cuda(*cg),
        "K1 step, k = 0": lambda: cg_fused.fused_cg_step_cuda(*cg[:12]),
        "K1 TPU-function arm": lambda: cg_fused.fused_cg_update_cuda(x, r, p, ap, alpha, cg[12]),
        "K7 step": lambda: cg_fused.lsmr_step_cuda(*ls),
        "K7 TPU-function arm": lambda: cg_fused.lsmr_update_cuda(*ls[:4], *c),
        "K1 step, armed": lambda: cg_fused.fused_cg_step_cuda(
            *cg[:7], cg_js, *cg[8:], window=4, best=rs),
        "K7 step, armed": lambda: cg_fused.lsmr_step_cuda(
            *ls[:7], ls_s, ls_js, *ls[9:], window=4),
    }
    assert {name: _device_kernels(fn) for name, fn in calls.items()} == dict.fromkeys(calls, 1)


def _armed_js(js, stall=1):
    return torch.cat([js, torch.tensor([stall], dtype=torch.int32, device=js.device)])


# The stall detector's states against the step's fresh residual r':
# improved (best far above), a stall (best = r'), the bar's own rounding
# (best = r' / 0.99), the latching step (stall = window − 1), frozen.
STALL_CASES = ["improved", "stall", "bar", "latch", "frozen"]


def _stall_inputs(case, fresh, window=4):
    best = {"improved": 1.5 * fresh, "bar": fresh / 0.99}.get(case, fresh)
    return best.reshape(()).contiguous(), window - 1 if case == "latch" else 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1000, 36551])
@pytest.mark.parametrize("k", [0, 8])
@pytest.mark.parametrize("case", STALL_CASES)
def test_fused_cg_step_armed(device, dtype, n, k, case):
    """K1's step arm with the stall detector armed (window 4): every
    output but the detector's the window-0 arm's bit for bit; ``best'``,
    ``stall'``, the status (STAGNATED latched on the same step) and the
    next active flag the plain version's bit for bit, from the kernel's
    own sums."""
    args = list(_cg_step_inputs(device, dtype, n, k, "frozen" if case == "frozen" else "live"))
    base = cg_fused.fused_cg_step_cuda(*args[:3], args[3].clone(), *args[4:])
    best, stall = _stall_inputs(case, torch.sqrt(base[3][0]))
    args[7] = _armed_js(args[7], stall)
    got = cg_fused.fused_cg_step_cuda(*args[:3], args[3].clone(), *args[4:], window=4, best=best)
    for g, w in zip(got[:3], base[:3]):
        assert torch.equal(g, w)
    assert torch.equal(got[3][:-1], base[3]) and torch.equal(got[4][0], base[4][0])
    # The plain version's detector on the kernel's own rr (its sums are the
    # kernel bar's, not bit for bit).
    rnorm_new = torch.sqrt(base[3][0])
    want_best, want_stall, want_fail = cg_fused.stagnation_update(
        best, args[7][2], rnorm_new, base[4][1], args[8], 4)
    assert _equal_nan(got[3][-1], want_best)
    assert torch.equal(got[4][1:], torch.stack([want_fail, want_stall]))
    latched = int(want_fail) == cg_fused.STAGNATED
    assert latched == (case == "latch")
    assert bool(got[5][0]) == (bool(base[5][0]) and not latched)
    assert torch.equal(got[5][1], base[5][1])
    again = cg_fused.fused_cg_step_cuda(*args[:3], args[3].clone(), *args[4:], window=4,
                                        best=best)
    assert all(_equal_nan(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1000, 16384])
@pytest.mark.parametrize("case", STALL_CASES)
def test_lsmr_step_armed(device, dtype, n, case):
    """K7's step arm armed (window 4): the window-0 outputs bit for bit,
    and the scalars, status and detector state the plain version's bit for
    bit (K7's scalars are its inputs' own: no sums)."""
    args = list(_lsmr_step_inputs(device, dtype, n, "frozen" if case == "frozen" else "live"))
    trace = args[-1]
    base = cg_fused.lsmr_step_cuda(*args[:-1], trace.clone())
    live = cg_fused.lsmr_step_cuda(*args[:9], torch.tensor(True, device=device), *args[10:-1],
                                   trace.clone())
    best, stall = _stall_inputs(case, live[4][1].abs())
    args[7] = torch.cat([args[7], best.reshape(1)])
    args[8] = _armed_js(args[8], stall)
    t_got, t_want = trace.clone(), trace.clone()
    got = cg_fused.lsmr_step_cuda(*args[:-1], t_got, window=4)
    want = cg_fused.lsmr_step_plain(*args[:-1], t_want, window=4)
    for g, w in zip(got[:4], base[:4]):
        assert torch.equal(g, w)
    assert torch.equal(got[4][:-1], base[4])
    for g, w in zip(got[4:], want[4:]):
        assert _equal_nan(g, w), (g, w)
    latched = int(got[5][1]) == cg_fused.STAGNATED
    assert latched == (case == "latch")
    assert _equal_nan(t_got, t_want)


def test_reductions_repeat_exactly(device):
    rnd = _gen(device, torch.float64, 0)
    x, r, p, ap = (rnd(36551) for _ in range(4))
    aw = rnd(8, 36551)
    a = cg_fused.fused_cg_update_cuda(x, r, p, ap, 0.3, aw)
    b = cg_fused.fused_cg_update_cuda(x, r, p, ap, 0.3, aw)
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
    s = rnd(40, 36551)
    assert torch.equal(cg_fused.self_gram_cuda(s), cg_fused.self_gram_cuda(s))


LM_TOL = {torch.float32: dict(rtol=2e-4, atol=5e-4), torch.bfloat16: dict(rtol=2e-2, atol=5e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # b, h, hkv, sq, sk, dh, causal, q_offset: tests/test_kernels.py's
    # ATTN_CASES, a GQA dh = 128 shape, a ragged causal block with an
    # offset, qwen1.5-0.5b's heads at a short prompt.
    (2, 4, 2, 64, 64, 32, False, 0),
    (1, 8, 2, 96, 96, 64, True, 0),
    (2, 4, 4, 1, 133, 64, True, 132),
    (1, 2, 1, 40, 200, 16, False, 0),
    (1, 16, 2, 33, 33, 128, True, 0),
    (1, 32, 8, 300, 300, 128, True, 0),
    (2, 4, 1, 70, 150, 64, True, 80),
    (4, 16, 16, 512, 512, 64, True, 0),
    # sk not a multiple of the 64-key tile, over 3+ tiles (the KV pipeline
    # wraps), plain and causal; one query at q_offset = sk - 1; causal with
    # sq != sk; GQA group 4 at dh 16 and 128; more blocks than one wave.
    (1, 4, 2, 50, 200, 64, False, 0),
    (2, 4, 2, 200, 200, 32, True, 0),
    (2, 8, 2, 1, 777, 128, True, 776),
    (1, 4, 4, 100, 300, 64, True, 200),
    (2, 8, 2, 130, 130, 16, True, 0),
    (1, 16, 4, 257, 257, 128, True, 0),
    (8, 32, 8, 1024, 1024, 64, True, 0),
    # dh 160 (stablelm-12b: h 32 over hkv 8): causal, ragged, plain GQA
    # group 4, one decode query, a causal block with an offset.
    (1, 32, 8, 300, 300, 160, True, 0),
    (1, 4, 1, 100, 130, 160, False, 0),
    (2, 8, 2, 1, 257, 160, True, 256),
    (2, 4, 1, 70, 150, 160, True, 80),
    # seamless-m4t-large-v2 (16 heads, dh 64, non-causal): the encoder's
    # self-attention, prefill's cross-attention (1 024 queries against 4 096
    # source keys), decode's one-row cross call, and a ragged one-row call.
    (1, 16, 16, 4096, 4096, 64, False, 0),
    (1, 16, 16, 1024, 4096, 64, False, 0),
    (4, 16, 16, 1, 4096, 64, False, 0),
    (1, 16, 16, 1, 333, 64, False, 0),
])
def test_flash_attention(device, dtype, case):
    b, h, hkv, sq, sk, dh, causal, off = case
    rnd = _gen(device, torch.float32, sq + sk + dh)
    q, k, v = (rnd(b, n, s, dh).to(dtype) for n, s in ((h, sq), (hkv, sk), (hkv, sk)))
    before = cg_fused.LAUNCHES["flash_attention"]
    got = fa.flash_attention_cuda(q, k, v, causal=causal, q_offset=off)
    assert cg_fused.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, causal=causal, q_offset=off, block_q=32, block_k=32)
    torch.testing.assert_close(got.float(), want.float(), **LM_TOL[dtype])
    oracle = kops.attention(q.float(), k.float(), v.float(), causal=causal, q_offset=off,
                            backend="reference")
    torch.testing.assert_close(got.float(), oracle, **LM_TOL[dtype])
    assert torch.equal(got, fa.flash_attention_cuda(q, k, v, causal=causal, q_offset=off))


GRAD_BAR = {torch.float32: 2e-4, torch.bfloat16: 5e-2}  # of the plain version's max abs


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # b, h, hkv, sq, sk, dh, causal (q_offset 0): dh 16, 32, 64, 128; GQA
    # groups 2, 4 and 8; ragged tiles; sq != sk; qwen1.5-0.5b's heads.
    (2, 4, 2, 64, 64, 32, False),
    (1, 8, 2, 96, 96, 64, True),
    (1, 16, 4, 257, 257, 128, True),
    (1, 2, 1, 40, 200, 16, False),
    (2, 4, 2, 130, 70, 16, True),
    (1, 4, 4, 70, 300, 128, False),
    (2, 16, 16, 512, 512, 64, True),
    (1, 16, 2, 260, 150, 128, True),
    # dh 160 (stablelm-12b: h 32 over hkv 8), ragged, sq != sk both ways.
    (1, 32, 8, 260, 260, 160, True),
    (1, 4, 1, 70, 150, 160, False),
    (2, 8, 2, 130, 70, 160, True),
    # seamless-m4t-large-v2's training (non-causal, dh 64): the encoder at
    # 2 048 frames, a ragged cross shape with sq < sk.
    (1, 16, 16, 2048, 2048, 64, False),
    (1, 16, 16, 100, 333, 64, False),
])
def test_flash_attention_grad_arms(device, dtype, case):
    b, h, hkv, sq, sk, dh, causal = case
    rnd = _gen(device, torch.float32, sq + sk + dh + 1)
    q, k, v = (rnd(b, n, s, dh).to(dtype) for n, s in ((h, sq), (hkv, sk), (hkv, sk)))
    dout, tq = rnd(b, h, sq, dh).to(dtype), rnd(b, h, sq, dh).to(dtype)
    tk, tv = rnd(b, hkv, sk, dh).to(dtype), rnd(b, hkv, sk, dh).to(dtype)
    arms = dict(_runtime.ARMS)
    out, lse = fa.flash_attention_lse_cuda(q, k, v, causal=causal)
    assert torch.equal(out, fa.flash_attention_cuda(q, k, v, causal=causal))
    out_p, lse_p = fa.flash_attention_lse_plain(q, k, v, causal=causal, block_q=32, block_k=48)
    torch.testing.assert_close(lse, lse_p, **LM_TOL[torch.float32])
    grads = fa.flash_attention_bwd_cuda(dout, q, k, v, out_p, lse_p, causal=causal)
    want = fa.flash_attention_bwd_plain(dout, q, k, v, out_p, lse_p, causal=causal, block_q=32,
                                        block_k=48)
    for got, w in zip(grads, want):
        assert got.dtype == dtype and got.shape == w.shape
        assert _rel(got, w) <= GRAD_BAR[dtype]
    again = fa.flash_attention_bwd_cuda(dout, q, k, v, out_p, lse_p, causal=causal)
    assert all(torch.equal(a, g) for a, g in zip(again, grads))
    tout = fa.flash_attention_jvp_cuda(q, k, v, out_p, lse_p, tq, tk, tv, causal=causal)
    want = fa.flash_attention_jvp_plain(q, k, v, out_p, lse_p, tq, tk, tv, causal=causal,
                                        block_q=32, block_k=48)
    assert _rel(tout, want) <= GRAD_BAR[dtype]
    assert torch.equal(tout, fa.flash_attention_jvp_cuda(q, k, v, out_p, lse_p, tq, tk, tv,
                                                         causal=causal))
    for arm, n in (("lse", 1), ("bwd", 2), ("jvp", 2)):
        key = f"flash_attention:{arm}"
        assert _runtime.ARMS.get(key, 0) - arms.get(key, 0) == n


def test_attention_autograd_and_func_on_the_card(device):
    rnd = _gen(device, torch.float32, 7)
    q, k, v = (rnd(2, n, 96, 64).to(torch.bfloat16) for n in (8, 2, 2))
    arms = dict(_runtime.ARMS)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kops.attention(*leaves, causal=True).float().square().sum().backward()
    assert all(x.grad is not None and bool(torch.isfinite(x.grad).all()) for x in leaves)
    f = lambda *a: kops.attention(*a, causal=True)  # noqa: E731
    _, lin = torch.func.linearize(f, q, k, v)
    t = tuple(torch.ones_like(x) for x in (q, k, v))
    assert torch.equal(lin(*t), torch.func.jvp(f, (q, k, v), t)[1])
    got = {a: _runtime.ARMS.get(f"flash_attention:{a}", 0) - arms.get(f"flash_attention:{a}", 0)
           for a in ("lse", "bwd", "jvp")}
    assert got["lse"] >= 1 and got["bwd"] == 1 and got["jvp"] >= 2, got
    with pytest.raises(ValueError, match="q_offset"):
        kops.attention(leaves[0], k, v, causal=True, q_offset=1)


def test_ssd_scan_refuses_a_differentiated_input(device):
    x, dt, a, bmat, cmat, d, _ = _ssd_inputs((1, 64, 2, 16, 1, 16, 32), torch.float32, device,
                                             False)
    with pytest.raises(NotImplementedError, match="ops.ssd"):
        ss.ssd_scan_cuda(x.requires_grad_(True), dt, a, bmat, cmat, d)
    with pytest.raises(NotImplementedError, match="ops.ssd"):
        torch.func.grad(lambda t: ss.ssd_scan_cuda(t, dt, a, bmat, cmat, d).sum())(x.detach())


def _ssd_inputs(case, dtype, device, state, strided=False):
    """x, dt, a, B, C, D and the state of ``case``.  ``strided``: x, B and
    C are the ``torch.split`` views of one (b, l, h·p + 2·g·n) tensor, as
    the Mamba mixer passes them."""
    b, l, h, p, g, n, _ = case
    gen = torch.Generator(device=device).manual_seed(l + h + n)
    if strided:
        conv = torch.randn(b, l, h * p + 2 * g * n, generator=gen, device=device).to(dtype)
        xc, bc, cc = torch.split(conv, [h * p, g * n, g * n], dim=-1)
        x, bmat, cmat = xc.reshape(b, l, h, p), bc.reshape(b, l, g, n), cc.reshape(b, l, g, n)
    else:
        x = torch.randn(b, l, h, p, generator=gen, device=device).to(dtype)
    dt = 0.01 + 0.39 * torch.rand(b, l, h, generator=gen, device=device)
    a = -(0.3 + 1.7 * torch.rand(h, generator=gen, device=device))
    if not strided:
        bmat, cmat = (torch.randn(b, l, g, n, generator=gen, device=device).to(dtype)
                      for _ in range(2))
    d = torch.randn(h, generator=gen, device=device)
    h0 = torch.randn(b, h, p, n, generator=gen, device=device) if state else None
    return x, dt, a, bmat, cmat, d, h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # b, l, h, p, g, n, chunk: tests/test_kernels.py's SSD_CASES, a ragged
    # l at mamba2-1.3b's head and state widths, and its prefill heads; one
    # row; one row past a chunk; 65 600 (batch, head) pairs, past a grid's
    # y limit.
    (1, 64, 2, 16, 1, 16, 32),
    (2, 100, 4, 8, 2, 24, 32),
    (1, 37, 2, 4, 2, 8, 16),
    (2, 128, 8, 32, 1, 64, 64),
    (1, 300, 4, 64, 1, 128, 128),
    (2, 512, 64, 64, 1, 128, 128),
    (2, 1, 8, 64, 1, 128, 128),
    (1, 129, 16, 64, 1, 128, 128),
    (1025, 8, 64, 16, 1, 16, 32),
])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("strided", [False, True])
def test_ssd_scan(device, dtype, case, state, strided):
    x, dt, a, bmat, cmat, d, h0 = _ssd_inputs(case, dtype, device, state, strided)
    assert x.is_contiguous() != strided
    kw = dict(chunk=case[-1], initial_state=h0, return_state=state)
    before = ss._runtime.LAUNCHES["ssd_scan"]
    got = ss.ssd_scan_cuda(x, dt, a, bmat, cmat, d, **kw)
    assert ss._runtime.LAUNCHES["ssd_scan"] == before + 1
    want = ss.ssd_plain(x, dt, a, bmat, cmat, d, **kw)
    got, want = (got, want) if state else ((got,), (want,))
    for i, (gv, wv) in enumerate(zip(got, want)):
        assert gv.shape == wv.shape and gv.dtype == wv.dtype
        scale = max(1.0, float(wv.float().abs().max()))
        # y at its dtype's bar; the f32 final state at the f32 bar in both
        # dtypes (bf16 runs split every non-bf16 factor into hi + lo).
        tol = LM_TOL[dtype if i == 0 else torch.float32]
        torch.testing.assert_close(gv.float() / scale, wv.float() / scale, **tol)
    again = ss.ssd_scan_cuda(x, dt, a, bmat, cmat, d, **kw)
    for gv, av in zip(got, again if state else (again,)):
        assert torch.equal(gv, av)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_refuses_a_strided_last_dimension(device, dtype):
    case = (2, 64, 4, 16, 1, 32, 32)
    x, dt, a, bmat, cmat, d, _ = _ssd_inputs(case, dtype, device, False)
    wide = torch.zeros(2, 64, 4, 32, device=device, dtype=dtype)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        ss.ssd_scan_cuda(wide[..., ::2], dt, a, bmat, cmat, d, chunk=32)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        ss.ssd_scan_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a, bmat, cmat, d,
                         chunk=32)


# K10's differentiated arms (training forward, backward, tangent map):
# the cases of test_ssd_scan that stay small, mamba2-1.3b's training shape
# (b 2, l 1 024) and a ragged l past a chunk; g = 2 with 16 heads a group
# over two bf16 blocks of 8 (the backward's block partials summed in block
# order), and 65 600 (batch, head) pairs on the state passes' grid.x; held
# at GRAD_BAR of the plain version's max abs (f32 2e-4, bf16 5e-2:
# chip_smoke.py's check-lm-grad).
SSD_GRAD_CASES = [(1, 64, 2, 16, 1, 16, 32), (2, 100, 4, 8, 2, 24, 32), (1, 37, 2, 4, 2, 8, 16),
                  (2, 128, 8, 32, 1, 64, 64), (1, 300, 4, 64, 1, 128, 128),
                  (2, 1, 8, 64, 1, 128, 128), (2, 1024, 64, 64, 1, 128, 128),
                  (1, 70, 32, 16, 2, 16, 32), (1025, 8, 64, 16, 1, 16, 32)]
GRAD_BAR = {torch.float32: 2e-4, torch.bfloat16: 5e-2}


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_GRAD_CASES)
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("strided", [False, True])
def test_ssd_scan_grad_arms(device, dtype, case, state, strided):
    x, dt, a, bmat, cmat, _, h0 = _ssd_inputs(case, dtype, device, state, strided)
    chunk = case[-1]
    rnd = _gen(device, torch.float32, sum(case))
    dy, tx = rnd(*x.shape).to(dtype), rnd(*x.shape).to(dtype)
    tb, tc = rnd(*bmat.shape).to(dtype), rnd(*cmat.shape).to(dtype)
    tdt, ta = 0.1 * rnd(*dt.shape), 0.1 * rnd(*a.shape)
    dh, th0 = (rnd(*h0.shape) if state else None for _ in range(2))
    arms = dict(_runtime.ARMS)
    y, h1, hs, cs = ss.ssd_scan_fwd_cuda(x, dt, a, bmat, cmat, h0, chunk=chunk)
    want = ss.ssd_fwd_plain(x, dt, a, bmat, cmat, h0, chunk=chunk)
    assert [t.shape for t in (y, h1, hs, cs)] == [t.shape for t in want]
    # The training forward is the serving arm's launches: y bit for bit.
    assert torch.equal(y, ss.ssd_scan_cuda(x, dt, a, bmat, cmat, chunk=chunk, initial_state=h0))
    assert _rel(hs, want[2]) <= 2e-4 and _rel(cs, want[3]) <= 1e-5
    _, _, hs_p, cs_p = want
    got = ss.ssd_scan_bwd_cuda(dy, x, dt, a, bmat, cmat, h0, hs_p, cs_p, dh, chunk=chunk)
    ref = ss.ssd_bwd_plain(dy, x, dt, a, bmat, cmat, h0, hs_p, cs_p, dh, chunk=chunk)
    tgot = ss.ssd_scan_jvp_cuda(x, dt, a, bmat, cmat, h0, hs_p, cs_p, tx, tdt, ta, tb, tc, th0,
                                chunk=chunk)
    tref = ss.ssd_jvp_plain(x, dt, a, bmat, cmat, h0, hs_p, cs_p, tx, tdt, ta, tb, tc, th0,
                            chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "da", "dB", "dC", "dh0", "ty", "th"), (*got, *tgot),
                          (*ref, *tref)):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert bool(torch.isfinite(g).all()), name
        bar = GRAD_BAR[dtype if g.dtype == dtype else torch.float32]
        assert _rel(g, w) <= bar, (name, _rel(g, w))
    again = ss.ssd_scan_bwd_cuda(dy, x, dt, a, bmat, cmat, h0, hs_p, cs_p, dh, chunk=chunk)
    tagain = ss.ssd_scan_jvp_cuda(x, dt, a, bmat, cmat, h0, hs_p, cs_p, tx, tdt, ta, tb, tc,
                                  th0, chunk=chunk)
    assert all(torch.equal(u, v) for u, v in zip((*got, *tgot), (*again, *tagain)))
    counts = {arm: _runtime.ARMS.get(f"ssd_scan:{arm}", 0) - arms.get(f"ssd_scan:{arm}", 0)
              for arm in ("fwd", "bwd", "jvp")}
    assert counts == {"fwd": 1, "bwd": 2, "jvp": 2}, counts


def test_ssd_autograd_and_func_on_the_card(device):
    x, dt, a, bmat, cmat, d, h0 = _ssd_inputs((2, 100, 4, 8, 2, 24, 32), torch.bfloat16, device,
                                              True, strided=True)
    arms = dict(_runtime.ARMS)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, dt, a, bmat, cmat, h0)]
    y, h1 = kops.ssd(*leaves[:5], d, chunk=32, initial_state=leaves[5], return_state=True)
    (y.float().square().sum() + h1.sum()).backward()
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in leaves)
    f = lambda *t: kops.ssd(*t, d, chunk=32)  # noqa: E731
    ins = (x, dt, a, bmat, cmat)
    _, lin = torch.func.linearize(f, *ins)
    tans = tuple(torch.ones_like(t) for t in ins)
    assert torch.equal(lin(*tans), torch.func.jvp(f, ins, tans)[1])
    got = {arm: _runtime.ARMS.get(f"ssd_scan:{arm}", 0) - arms.get(f"ssd_scan:{arm}", 0)
           for arm in ("fwd", "bwd", "jvp")}
    assert got["fwd"] >= 2 and got["bwd"] == 1 and got["jvp"] >= 2, got


def test_ssd_scan_matches_sequential_oracle(device):
    gen = torch.Generator(device=device).manual_seed(7)
    b, l, h, p, g, n = 2, 100, 4, 8, 2, 24
    x = torch.randn(b, l, h, p, generator=gen, device=device)
    dt = 0.01 + 0.39 * torch.rand(b, l, h, generator=gen, device=device)
    a = -(0.3 + 1.7 * torch.rand(h, generator=gen, device=device))
    bmat, cmat = (torch.randn(b, l, g, n, generator=gen, device=device) for _ in range(2))
    got = kops.ssd(x, dt, a, bmat, cmat, chunk=32)
    want = kops.ssd(x, dt, a, bmat, cmat, backend="reference")
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got / scale, want / scale, rtol=4e-4, atol=1e-3)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-1.3b", "seamless-m4t-large-v2"])
def test_smoke_model_serving_on_card(device, arch):
    """A SMOKE model's forward, prefill and decode through the kernels
    against the same model run through the plain versions on the card (the
    encoder–decoder on seeded source frames)."""
    from repro_torch import models
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(arch)
    model = models.init(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=device, generator=gen)
    batch = {"tokens": tokens}
    if cfg.is_encdec:
        batch["src_embeds"] = torch.randn(2, cfg.source_len, cfg.d_model, device=device,
                                          generator=gen)
    runs = {}
    for backend in ("cuda", "plain"):
        hidden, _ = models.forward_hidden(model, batch, cfg, backend=backend)
        state = models.init_decode_state(cfg, 2, 48, device=device)
        state, last = models.prefill(model, batch, state, cfg, backend=backend)
        step, state = models.decode_step(model, tokens[:, :1], state, cfg, backend=backend)
        runs[backend] = (hidden, last, step)
    for got, want in zip(runs["cuda"], runs["plain"]):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=5e-4)


# ---------------------------------------------------------------------------
# The lane axis of K1's, K6's and K2's step arms (batched solves)
# ---------------------------------------------------------------------------

# (n, k): the main path's n (odd: lane i's rows start 8-byte aligned for
# odd i, so its lanes mix 16-byte and element loads) with and without a
# basis, an aligned n, a small one and a single element.
LANE_SHAPES = [(36551, 8), (36551, 0), (36552, 8), (36552, 0), (1000, 8), (1, 1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lanes", [1, 8, 64])
@pytest.mark.parametrize("n,k", LANE_SHAPES)
@pytest.mark.parametrize("mode", ["plain", "recording", "armed"])
def test_lane_axis_step_arms(device, dtype, lanes, n, k, mode):
    """K1's, K6's and K2's step arms on a (B, n) lane axis: every lane bit
    for bit the one-lane arm on that lane's data (live, frozen, indefinite
    and diverging lanes; per-lane scalars as strided views), against the
    lane-by-lane plain versions to the kernel bar (flags, counts and
    statuses exactly), two launches bit for bit, one counted launch per
    arm per call."""
    import torch_lane_cases as lc

    if lanes * n > 64 * 36552 // 2 and mode != "plain":
        lanes = 8  # the recording buffers at 64 lanes: the plain mode covers 64
    t = lc.lane_step_inputs(torch, device, dtype, lanes, n, k, mode=mode, seed=lanes + n + k)
    full, per_lane = lc.run_lane_arms(torch, cg_fused, t)
    assert lc.lane_mismatches(torch, full, per_lane) == []
    again = lc.run_steps(torch, cg_fused, t)
    assert lc.lane_mismatches(torch, full, again) == []
    plain = lc.run_steps(torch, cg_fused, t, arms="plain")
    for key in ("jo", "bo", "k1r_js", "k1r_flags"):
        assert torch.equal(full[key], plain[key]), key
    for key, got in full.items():
        if got.dtype.is_floating_point:
            _assert_close(torch.nan_to_num(got), torch.nan_to_num(plain[key]), dtype)
    before = dict(cg_fused.LAUNCHES)
    lc.run_steps(torch, cg_fused, t)
    assert cg_fused.LAUNCHES["fused_cg_update"] == before["fused_cg_update"] + 2
    assert cg_fused.LAUNCHES["fused_rz_reduce"] == before["fused_rz_reduce"] + 1
    assert cg_fused.LAUNCHES["fused_deflate_direction"] == before["fused_deflate_direction"] + 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_lane_axis_arms_run_one_device_kernel(device, dtype):
    """Each lane-axis arm is one device kernel a call at B = 8, n = 36 551."""
    import torch_lane_cases as lc

    t = lc.lane_step_inputs(torch, device, dtype, 8, 36551, 8, mode="recording")
    so = torch.zeros(8, 10, dtype=dtype, device=device)
    on = torch.ones(8, dtype=torch.bool, device=device)
    ap = t["ap"].clone()
    calls = {
        "K1 lanes": lambda: cg_fused.fused_cg_step_cuda(
            t["x"], t["r"], t["p"], ap, t["d"], t["rs"], t["rnorm"], t["js"], t["active"],
            t["threshold"], t["diverged_at"], 10, t["aw"], t["waw_inv"]),
        "K6 lanes": lambda: cg_fused.fused_rz_step_cuda(
            t["r"], t["z"], t["rs"], t["aw"], t["waw_inv"], alpha=so[:, 2], active=on,
            row=1, a_rows=t["a_rows"], b_rows=t["b_rows"]),
        "K2 lanes": lambda: cg_fused.fused_direction_step_cuda(
            t["z"], t["p"], so[:, 1], on, t["w"], so[:, 2:10], ap=t["ap"], active=on, row=1,
            p_buf=t["p_buf"], ap_buf=t["ap_buf"]),
    }
    assert {name: _device_kernels(fn) for name, fn in calls.items()} == dict.fromkeys(calls, 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lanes", [1, 8, 64])
@pytest.mark.parametrize("n", [16384, 16385, 1000, 1])
@pytest.mark.parametrize("window", [0, 10])
def test_lane_axis_lsmr_step(device, dtype, lanes, n, window):
    """K7's step arm on a (B, n) lane axis: every lane bit for bit the
    one-lane arm on that lane's data (live, frozen, converging, diverging
    and exactly terminating lanes; ``s`` rows of a wider buffer, the other
    per-lane scalars strided views; odd n mixes 16-byte and element loads
    across lanes), against the lane-by-lane plain version to the kernel bar
    (``s``'s slots bit for bit, flags, counts and statuses exactly), two
    launches bit for bit, one counted launch a call on the lane entry."""
    import torch_lane_cases as lc

    t = lc.lsmr_lane_inputs(torch, device, dtype, lanes, n, window=window, seed=lanes + n)
    full, per_lane = lc.run_lsmr_lane_arms(torch, cg_fused, t)
    assert lc.lane_mismatches(torch, full, per_lane) == []
    assert lc.lane_mismatches(torch, full, lc.run_lsmr_steps(torch, cg_fused, t)) == []
    plain = lc.run_lsmr_steps(torch, cg_fused, t, arms="plain")
    for key in ("so", "jo", "ao", "trace"):
        assert _equal_nan(full[key], plain[key]), key
    for key in ("xo", "hbo", "ho", "vo"):
        _assert_close(full[key], plain[key], dtype)
    arms = cg_fused._runtime.ARMS
    key = "lsmr_update:lsmr_step_lanes"
    before = arms.get(key, 0)
    lc.run_lsmr_steps(torch, cg_fused, t)
    assert arms[key] == before + 1

    def call():
        cg_fused.lsmr_step_cuda(*(t[k] for k in lc.LSMR_ARGS), trace=t["trace"],
                                window=t["window"])

    assert _device_kernels(call) == 1


# ---------------------------------------------------------------------------
# The device gate of K3 / K8 (frozen steps skip their product)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ndr", [(4000, 784, 1), (1000, 50, 8), (257, 13, 33)])
@pytest.mark.parametrize("lanes", [1, 8])
def test_rbf_matvec_gate(device, dtype, ndr, lanes):
    """A gated K3 call: zeros when no flag is set (the flags a strided
    view), bit for bit the ungated call when any one is, and the plain
    version's gate likewise."""
    n, d, r = ndr
    rnd = _gen(device, dtype, n + d + r + lanes)
    x, v = rnd(n, d) * 0.3, rnd(n, r)
    flags = torch.zeros(lanes, 2, dtype=torch.bool, device=device)
    ungated = rbf.rbf_matvec_cuda(x, v, 1.3, 2.0)
    off = rbf.rbf_matvec_cuda(x, v, 1.3, 2.0, gate=flags[:, 0])
    assert torch.equal(off, torch.zeros_like(off))
    flags[lanes - 1, 0] = True
    on = rbf.rbf_matvec_cuda(x, v, 1.3, 2.0, gate=flags[:, 0])
    assert torch.equal(on, ungated)
    plain_off = rbf.rbf_matvec_plain(x, v, 1.3, 2.0, gate=flags[:, 1])
    assert torch.equal(plain_off, torch.zeros_like(plain_off))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mnd", [(2048, 16384, 784), (1000, 3001, 13)])
def test_rbf_matvec_rect_gate(device, dtype, mnd):
    """The same gate on K8: zeros gated off, the ungated product gated on."""
    m, n, d = mnd
    rnd = _gen(device, dtype, m + n + d)
    x = rnd(n, d) * 0.3
    xr, v = x[:m].contiguous(), rnd(n, 1)
    ungated = rbf.rbf_matvec_rect_cuda(xr, x, v, 1.0, 2.0)
    off = rbf.rbf_matvec_rect_cuda(xr, x, v, 1.0, 2.0,
                                   gate=torch.tensor(False, device=device))
    assert torch.equal(off, torch.zeros_like(off))
    on = rbf.rbf_matvec_rect_cuda(xr, x, v, 1.0, 2.0, gate=torch.tensor(True, device=device))
    assert torch.equal(on, ungated)


@pytest.mark.parametrize("dispatch", ["grouped", "global"])
def test_moe_backward_repeats_bit_for_bit(device, dispatch):
    """olmoe's SMOKE MoE layer widened to 64 experts top-8 (capacity factor
    1.25, so tokens drop) in bf16 on the card: output, aux and every
    gradient equal on two backward passes (no float atomics)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), n_experts=64,
                              experts_per_token=8, capacity_factor=1.25, dtype="bfloat16",
                              moe_dispatch=dispatch)
    layer = moe.moe_init(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device).requires_grad_(True)
    x = _gen(device, torch.float32, 5)(4, 256, cfg.d_model).to(torch.bfloat16)

    def run():
        xr = x.detach().requires_grad_(True)
        with moe.record_routing() as routing:
            out, aux = moe.moe_apply(layer, xr, cfg)
        grads = torch.autograd.grad(out.float().square().sum() + aux, [xr, *layer.parameters()])
        return out, aux, grads, routing[0]

    first, second = run(), run()
    assert not bool(first[3].kept.all())  # some assignments dropped
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert all(torch.equal(a, b) for a, b in zip(first[2], second[2]))
    assert all(bool(torch.isfinite(g).all()) for g in first[2])


# ---------------------------------------------------------------------------
# The compiled doors: each masked loop captured as CUDA graphs and replayed
# ---------------------------------------------------------------------------


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a compute capability 9.0 card")
    from repro_torch.core import engine

    engine.clear_programs()
    engine.reset_graph_stats()
    return torch.device("cuda")


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _same_result(got, want):
    """Two results (tensors, tuples, NamedTuples, dataclasses) bit for bit."""
    import dataclasses

    if isinstance(want, torch.Tensor):
        return got.shape == want.shape and torch.equal(_bits(got), _bits(want))
    if dataclasses.is_dataclass(want):
        return all(_same_result(getattr(got, f.name), getattr(want, f.name))
                   for f in dataclasses.fields(want))
    if isinstance(want, tuple):
        return len(got) == len(want) and all(_same_result(g, w) for g, w in zip(got, want))
    return got == want


def _door_cases(device, n=1536):
    """``{door: (compiled, eager, args, kwargs)}`` on f64 systems of order n
    (drifting SPD ``I + H K H``, rectangular ``[I; 0] + noise``)."""
    import importlib

    from repro_torch import core

    lsmr_mod = importlib.import_module("repro_torch.core.lsmr")
    rnd = _gen(device, torch.float64, 21)
    x = rnd(n, 8)
    kmat = torch.exp(-0.5 * torch.cdist(x, x) ** 2 / 4.0)
    hs = [0.2 + 0.3 * torch.rand(n, generator=torch.Generator(device=device).manual_seed(i),
                                 device=device, dtype=torch.float64) for i in range(3)]
    mats = torch.stack([torch.eye(n, dtype=torch.float64, device=device)
                        + h[:, None] * kmat * h[None, :] for h in hs])
    bs = rnd(3, n)
    w0 = torch.linalg.qr(rnd(n, 8)).Q.T.contiguous()
    aw0 = (mats[0] @ w0.T).T.contiguous()
    rect = torch.eye(2 * n, n, dtype=torch.float64, device=device) + 0.3 * rnd(3, 2 * n, n) / (
        2 * n) ** 0.5
    brect = rnd(3, 2 * n)
    A0 = core.from_matrix(mats[0])
    spec = core.SolveSpec(k=8, ell=12, tol=1e-8, maxiter=500)
    seq = dict(k=8, ell=12, make_operator=core.from_matrix, tol=1e-8, maxiter=500)
    return {
        "cg_jit": (core.solvers.cg_jit, core.cg, (A0, bs[0]),
                   dict(tol=1e-8, maxiter=500, M=core.jacobi(torch.diagonal(mats[0])),
                        record_residuals=True)),
        "defcg_jit": (core.solvers.defcg_jit, core.defcg, (A0, bs[0], None, w0, aw0),
                      dict(ell=12, tol=1e-8, maxiter=500)),
        "solve_jit": (core.solve_jit, core.solve, (A0, bs[1], spec, None), {}),
        "solve_sequence_jit": (core.solve_sequence_jit, core.recycle.solve_sequence,
                               (mats, bs), seq),
        "recycled_solve_jit": (core.recycled_solve_jit, core.recycle._recycled_solve,
                               (A0, bs[2], None, w0), dict(k=8, ell=12, tol=1e-8, maxiter=500)),
        "lsmr_jit": (lsmr_mod.lsmr_jit, lsmr_mod.lsmr, (core.from_matrix(rect[0]), brect[0]),
                     dict(damp=0.1, ell=12, tol=1e-8, maxiter=500)),
        "solve_sequence_lsmr_jit": (lsmr_mod.solve_sequence_lsmr_jit,
                                    lsmr_mod.solve_sequence_lsmr, (rect, brect),
                                    dict(seq, damp=0.1)),
        "solve_batch_jit": (core.solve_batch_jit, core.solve_batch, (mats, bs, spec, None),
                            dict(make_operator=core.from_matrix)),
        "solve_pool_step_jit": (core.solve_pool_step_jit, core.solve_pool_step,
                                (mats, bs, spec, None, torch.tensor([True, False, True],
                                                                    device=device)),
                                dict(make_operator=core.from_matrix)),
    }


DOORS = ("cg_jit", "defcg_jit", "solve_jit", "solve_sequence_jit", "recycled_solve_jit",
         "lsmr_jit", "solve_sequence_lsmr_jit", "solve_batch_jit", "solve_pool_step_jit")


@pytest.mark.parametrize("door", DOORS)
def test_compiled_door_matches_eager_bit_for_bit(hopper, door):
    """The first call captures, the second replays; both give the eager
    door's result bit for bit, and the replay launches exactly the eager
    door's kernels (the counters add each replay's launches)."""
    from repro_torch.core import engine

    compiled, eager, args, kw = _door_cases(hopper)[door]
    before = dict(_runtime.LAUNCHES)
    want = eager(*args, **kw)
    eager_launches = {k: _runtime.LAUNCHES[k] - before[k] for k in before}
    first = compiled(*args, **kw)
    captured = engine.GRAPHS["captured"]
    before = dict(_runtime.LAUNCHES)
    again = compiled(*args, **kw)
    replay_launches = {k: _runtime.LAUNCHES[k] - before[k] for k in before}
    assert _same_result(first, want) and _same_result(again, want)
    assert captured > 0 and engine.GRAPHS["replays"] > 0
    assert engine.GRAPHS["captured"] == captured  # the second call captured nothing
    assert replay_launches == eager_launches


def test_newton_systems_reuse_the_captured_graphs(hopper):
    """A Newton sequence through ``RecycleManager`` (``use_jit``): the cold
    system and the first warm one capture, every later system replays;
    x and the basis bit for bit the eager manager's."""
    from repro_torch.core import KernelSystemOperator, RecycleManager, engine

    n = 4096
    rnd = _gen(hopper, torch.float64, 3)
    x = rnd(n, 8)
    kmat = torch.exp(-0.5 * torch.cdist(x, x) ** 2 / 4.0)

    def kmv(v):
        return kmat @ v

    mgrs = [RecycleManager(k=8, ell=12, tol=1e-8, use_jit=flag) for flag in (True, False)]
    captured = []
    for i in range(5):
        sqrt_h = 0.1 + 0.4 * torch.rand(n, generator=torch.Generator(device=hopper).manual_seed(i),
                                        device=hopper, dtype=torch.float64)
        b = rnd(n)
        got, want = (m.solve(KernelSystemOperator(kmv, sqrt_h), b) for m in mgrs)
        assert _same_result(got, want)
        assert torch.equal(mgrs[0].W, mgrs[1].W)
        captured.append(engine.GRAPHS["captured"])
    assert captured[1] == captured[-1] <= 4
    assert engine.GRAPHS["reused"] == 3 and engine.GRAPHS["replays"] > 5


def _host_read_step(c, state, active, row):
    (v,) = state
    if bool(active):  # a host read: refused under capture
        v = c["mat"] @ v
    return (v,)


def _toy_active(state):
    return torch.ones((), dtype=torch.bool, device=state[0].device)


def test_capture_that_reads_the_host_raises(hopper):
    """A step that reads a device value on the host cannot be captured: the
    door raises, keeps no program, and the card stays usable."""
    from repro_torch import core
    from repro_torch.core import engine

    consts = {"mat": torch.eye(64, dtype=torch.float64, device=hopper)}
    with engine.compiled(), pytest.raises(RuntimeError):
        engine.run_recording_loop(_host_read_step, _toy_active,
                                  (torch.ones(64, dtype=torch.float64, device=hopper),),
                                  consts=consts)
    assert len(engine._PROGRAMS) == 0
    # A fault-injecting operator hidden in a closure cannot be captured either.
    op = core.FaultInjectingOperator(core.from_matrix(consts["mat"] * 2), at_matvec=5)
    b = torch.ones(64, dtype=torch.float64, device=hopper)
    with pytest.raises(RuntimeError, match="host"):
        core.solvers.cg_jit(lambda v: op(v), b, tol=1e-8, maxiter=50)
    res = core.solvers.cg_jit(core.from_matrix(consts["mat"] * 2), b, tol=1e-8, maxiter=50)
    assert bool(res.info.converged)
