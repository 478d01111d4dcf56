"""Kernel layer of the PyTorch port against the JAX reference.

The plain PyTorch version beside each Hopper kernel (the CPU path of
``repro_torch.kernels.ops``) is held against ``repro.kernels.ops`` on the
same numpy inputs:

* f64 against the reference's ``reference`` and ``chunked`` arms at 1e-12
  (both accumulate in f64 off the TPU, as the port's f64 kernels do);
* f32 against the Pallas kernel in interpret mode at 2e-4, the tolerance
  of ``tests/test_cg_fused.py`` (Pallas accumulates in f32).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# (n, k): ragged n throughout; k=None is the undeflated (plain-CG) variant.
CASES = [(1000, None), (1000, 1), (1000, 8), (257, 8), (4096, 8)]
JAX_ARMS = {
    "f64-reference": ("reference", np.float64, 1e-12),
    "f64-chunked": ("chunked", np.float64, 1e-12),
    "f32-interpret": ("interpret", np.float32, 2e-4),
}


def _close(got, want, tol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol,
                               err_msg=what)


def _inputs(n, k, dtype, seed):
    rng = np.random.default_rng(seed)
    vecs = [rng.standard_normal(n).astype(dtype) for _ in range(4)]
    aw = None if k is None else rng.standard_normal((k, n)).astype(dtype)
    return vecs, aw, rng


@pytest.mark.parametrize("arm", sorted(JAX_ARMS))
@pytest.mark.parametrize("case", CASES)
def test_fused_cg_update_matches_reference(arm, case):
    impl, dtype, tol = JAX_ARMS[arm]
    n, k = case
    (x, r, p, ap), aw, _ = _inputs(n, k, dtype, n + (k or 0))
    alpha = dtype(0.37)
    want = jops.fused_cg_update(
        *(jnp.asarray(v) for v in (x, r, p, ap)), alpha,
        None if aw is None else jnp.asarray(aw), impl=impl,
    )
    got = tops.fused_cg_update(
        *(torch.from_numpy(v) for v in (x, r, p, ap)),
        torch.tensor(alpha),
        None if aw is None else torch.from_numpy(aw),
    )
    assert got[0].dtype == torch.from_numpy(x).dtype
    for g, w, name in zip(got[:3], want[:3], ("x", "r", "rr")):
        _close(g, w, tol, f"{arm} {name} n={n} k={k}")
    if k is None:
        assert got[3] is None
    else:
        _close(got[3], want[3], tol, f"{arm} awr n={n} k={k}")


@pytest.mark.parametrize("arm", sorted(JAX_ARMS))
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("buffered", [False, True], ids=["direction", "buffered"])
def test_fused_deflate_direction_matches_reference(arm, case, buffered):
    impl, dtype, tol = JAX_ARMS[arm]
    n, k = case
    (r, p, ap, _), w, rng = _inputs(n, k, dtype, 3 * n + (k or 0))
    mu = None if k is None else rng.standard_normal(k).astype(dtype)
    beta = dtype(0.9)
    rows, idx = 5, 3
    p_buf = rng.standard_normal((rows, n)).astype(dtype)
    ap_buf = rng.standard_normal((rows, n)).astype(dtype)
    jarg = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    targ = lambda a: None if a is None else torch.from_numpy(a.copy())  # noqa: E731
    bufs = (p_buf, ap_buf) if buffered else (None, None)
    want = jops.fused_deflate_direction(
        jarg(r), jarg(p), beta, jarg(w), jarg(mu), jarg(ap),
        idx if buffered else None, *(jarg(b) for b in bufs), impl=impl,
    )
    got = tops.fused_deflate_direction(
        targ(r), targ(p), torch.tensor(beta), targ(w), targ(mu), targ(ap),
        torch.tensor(idx) if buffered else None, *(targ(b) for b in bufs),
    )
    _close(got[0], want[0], tol, f"{arm} p_new n={n} k={k}")
    if buffered:
        _close(got[1], want[1], 0.0, "p_buf")
        _close(got[2], want[2], 0.0, "ap_buf")
    else:
        assert got[1] is None and got[2] is None


@pytest.mark.parametrize("arm", sorted(JAX_ARMS))
@pytest.mark.parametrize("shape", [(40, 1000), (24, 257), (2, 4096)])
def test_self_gram_matches_reference(arm, shape):
    impl, dtype, tol = JAX_ARMS[arm]
    s = np.random.default_rng(sum(shape)).standard_normal(shape).astype(dtype)
    want = jops.self_gram(jnp.asarray(s), impl=impl)
    got = tops.self_gram(torch.from_numpy(s))
    assert got.dtype == torch.from_numpy(s).dtype
    _close(got, want, tol, f"{arm} self_gram {shape}")


@pytest.mark.parametrize("arm", sorted(JAX_ARMS))
@pytest.mark.parametrize("mkn", [(20, 8, 1000), (12, 1, 257), (20, 8, 4096)])
def test_recombine_blocks_matches_reference(arm, mkn):
    impl, dtype, tol = JAX_ARMS[arm]
    m, k, n = mkn
    rng = np.random.default_rng(m * k + n)
    s = rng.standard_normal((2 * m, n)).astype(dtype)
    u = rng.standard_normal((m, k)).astype(dtype)
    want = jops.recombine_blocks(jnp.asarray(s), jnp.asarray(u), impl=impl)
    got = tops.recombine_blocks(torch.from_numpy(s), torch.from_numpy(u))
    assert got.shape == (2 * k, n)
    _close(got, want, tol, f"{arm} recombine {mkn}")


@pytest.mark.parametrize("arm", sorted(JAX_ARMS))
@pytest.mark.parametrize("case", CASES)
def test_fused_rz_reduce_matches_reference(arm, case):
    impl, dtype, tol = JAX_ARMS[arm]
    n, k = case
    (r, z, _, _), aw, _ = _inputs(n, k, dtype, 5 * n + (k or 0))
    want = jops.fused_rz_reduce(
        jnp.asarray(r), jnp.asarray(z), None if aw is None else jnp.asarray(aw),
        impl=impl,
    )
    got = tops.fused_rz_reduce(
        torch.from_numpy(r), torch.from_numpy(z),
        None if aw is None else torch.from_numpy(aw),
    )
    _close(got[0], want[0], tol, f"{arm} rz n={n} k={k}")
    if k is None:
        assert got[1] is None
    else:
        _close(got[1], want[1], tol, f"{arm} awz n={n} k={k}")


# RBF Gram matvec: f64 against the reference's chunked arm and oracle at
# 1e-12; f32 against the Pallas kernel in interpret mode at the 2e-4 / 5e-4
# of tests/test_kernels.py.  r = 1 goes in as a vector.
RBF_ARMS = {
    "f64-chunked": ("chunked", np.float64),
    "f64-reference": ("reference", np.float64),
    "f32-interpret": ("interpret", np.float32),
}


@pytest.mark.parametrize("arm", sorted(RBF_ARMS))
@pytest.mark.parametrize("ndr", [(300, 13, 1), (257, 784, 3), (300, 784, 1), (257, 13, 3)])
def test_rbf_matvec_matches_reference(arm, ndr):
    impl, dtype = RBF_ARMS[arm]
    n, d, r = ndr
    rng = np.random.default_rng(n + d + r)
    x = rng.standard_normal((n, d)).astype(dtype)
    v = rng.standard_normal(n if r == 1 else (n, r)).astype(dtype)
    theta, ls = 1.3, 0.1 * d**0.5 + 1.0
    want = np.asarray(jops.rbf_matvec(jnp.asarray(x), jnp.asarray(v), theta, ls,
                                      impl=impl, block=128))
    got = tops.rbf_matvec(torch.from_numpy(x), torch.from_numpy(v), theta, ls, block=100)
    assert got.shape == want.shape and got.dtype == torch.from_numpy(x).dtype
    if dtype == np.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=5e-4)
    else:
        _close(got, want, 1e-12, f"{arm} rbf {ndr}")


def test_rbf_matvec_blocks_give_the_same_rows():
    """The plain version's row block changes only which rows share a GEMM."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((333, 20)))
    v = torch.from_numpy(rng.standard_normal((333, 4)))
    ys = [tops.rbf_matvec(x, v, 2.0, 1.5, block=b) for b in (1, 64, 1024)]
    for y in ys[1:]:
        torch.testing.assert_close(y, ys[0], rtol=1e-13, atol=1e-13)
    torch.testing.assert_close(
        ys[0], tops.rbf_matvec(x, v, 2.0, 1.5, backend="reference"),
        rtol=1e-12, atol=1e-12,
    )


@pytest.mark.parametrize("backend", ["plain", "reference"])
def test_backends_agree_in_f64(backend):
    rng = np.random.default_rng(5)
    n, k = 777, 8
    x, r, p, ap = (torch.from_numpy(rng.standard_normal(n)) for _ in range(4))
    aw = torch.from_numpy(rng.standard_normal((k, n)))
    alpha = torch.tensor(-1.25, dtype=torch.float64)
    want = tref.fused_cg_update(x, r, p, ap, alpha, aw)
    got = tops.fused_cg_update(x, r, p, ap, alpha, aw, backend=backend)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-13, atol=1e-13)
    s = torch.from_numpy(rng.standard_normal((40, n)))
    torch.testing.assert_close(tops.self_gram(s, backend=backend), tref.self_gram(s))


def test_reference_oracle_leaves_buffers_untouched():
    n = 64
    r, p, ap = (torch.ones(n, dtype=torch.float64) for _ in range(3))
    p_buf = torch.zeros((3, n), dtype=torch.float64)
    _, pb, _ = tops.fused_deflate_direction(
        r, p, 0.5, None, None, ap, 1, p_buf, p_buf.clone(), backend="reference"
    )
    assert float(p_buf.abs().sum()) == 0.0 and float(pb[1].sum()) == n


def test_cuda_backend_on_cpu_tensor_raises():
    v = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        tops.fused_cg_update(v, v, v, v, 0.5, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tops.self_gram(v[None], backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tops.fused_rz_reduce(v, v, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tops.rbf_matvec(v[:, None], v, 1.0, 1.0, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        tops.self_gram(v[None], backend="pallas")


def test_port_imports_without_jax_or_repro():
    """``repro_torch`` and every submodule import with JAX and the
    reference package made unimportable."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env=env,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
