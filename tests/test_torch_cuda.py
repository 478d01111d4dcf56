"""The port's Hopper kernels against their plain versions, on the card.

Marked ``cuda``: here, without a card, every test skips.  On a machine
with an H100 run them with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the GPU
machine does not need to have).  Tolerances: f64 1e-12 relative, f32
2e-4 (the Pallas tolerance of ``tests/test_cg_fused.py``); the f32 RBF
Gram matvec 2e-4 relative / 5e-4 absolute (``tests/test_kernels.py``).
``self_gram`` and ``recombine_blocks`` are held up to 128 stacked rows,
the windows of the least-squares path (lsq_bench's k + ℓ = 56 gives 112).
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cg_fused  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import rbf_matvec as rbf  # noqa: E402

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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ndr", [(4000, 784, 1), (4000, 784, 8), (1000, 50, 24),
                                 (1000, 50, 33), (257, 13, 3), (1, 5, 1)])
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
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("rows", [40, 24, 64, 1, 96, 112, 128])
def test_self_gram(device, dtype, n, rows):
    s = _gen(device, dtype, n + rows)(rows, n)
    got = cg_fused.self_gram_cuda(s)
    _assert_close(got, cg_fused.self_gram_plain(s), dtype)
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mk", [(20, 8), (12, 8), (32, 16), (3, 1), (48, 8), (56, 8), (64, 16)])
def test_recombine_blocks(device, dtype, n, mk):
    m, k = mk
    rnd = _gen(device, dtype, n + m + k)
    s, u = rnd(2 * m, n), rnd(m, k)
    got = cg_fused.recombine_blocks_cuda(s, u)
    _assert_close(got, cg_fused.recombine_blocks_plain(s, u), dtype)


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


def test_reductions_repeat_exactly(device):
    rnd = _gen(device, torch.float64, 0)
    x, r, p, ap = (rnd(36551) for _ in range(4))
    aw = rnd(8, 36551)
    a = cg_fused.fused_cg_update_cuda(x, r, p, ap, 0.3, aw)
    b = cg_fused.fused_cg_update_cuda(x, r, p, ap, 0.3, aw)
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
    s = rnd(40, 36551)
    assert torch.equal(cg_fused.self_gram_cuda(s), cg_fused.self_gram_cuda(s))
