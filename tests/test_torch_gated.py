"""Frozen steps skip their product: the device gate of the matrix-free
operator (K3's flag vector), on the CPU through the plain version's gate.

A frozen step's product is zeros (the reference's ``zeros_like``: the
``v + H½ K H½ v`` wrapper must not turn it into ``v``), a live step's is
the ungated product bit for bit, a tenant batch's is skipped only when
every lane is frozen, and a gated matrix-free sequence gives the
reference's iterations and matvecs exactly (the gate changes what a
frozen step costs, never what it counts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax.config.update("jax_enable_x64", True)

import repro.core as jc  # noqa: E402
import repro.core.operators as j_operators  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

N, D = 300, 5


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((N, D))
    pi = 1.0 / (1.0 + np.exp(-0.5 * rng.standard_normal((3, N))))
    return x, np.sqrt(pi * (1.0 - pi)), rng.standard_normal((3, N))


def test_gated_product_is_zero_when_frozen(data):
    x, sh, bs = data
    op = tc.RBFKernelSystemOperator(_t(x), _t(sh[0]), 2.0, 1.5)
    v = _t(bs[0])
    off = op.gated_matvec(v, torch.tensor(False))
    assert torch.equal(off, torch.zeros_like(v))
    assert torch.equal(op.gated_matvec(v, torch.tensor(True)), op.matvec(v))
    assert torch.equal(engine.gated_matvec(op, v, torch.tensor(False)), off)
    dense = tc.from_matrix(torch.eye(N, dtype=torch.float64))
    assert torch.equal(engine.gated_matvec(dense, v, torch.tensor(False)), v)


def test_lane_gate_skips_only_when_every_lane_is_frozen(data):
    x, sh, bs = data
    op = tc.RBFKernelSystemOperator(_t(x), _t(sh), 2.0, 1.5)
    V = _t(bs)
    flags = torch.tensor([[False, True], [True, False], [False, False]])
    live = op.gated_matvec(V, flags[:, 0])
    assert torch.equal(live, op.matvec(V))
    assert torch.equal(op.gated_matvec(V, flags[:, 1] & False), torch.zeros_like(V))
    y = kops.rbf_matvec(_t(x), V.T, 2.0, 1.5, gate=torch.zeros(3, dtype=torch.bool))
    assert torch.equal(y, torch.zeros_like(y))


@pytest.mark.parametrize("precond", [False, True])
def test_gated_sequence_counts_match_reference(data, precond):
    """A matrix-free def-CG sequence, every frozen step's product gated:
    the reference's iterations and matvecs exactly, x to 1e-10."""
    x, sh, bs = data
    kw = dict(k=4, ell=8, tol=1e-11, precond="jacobi" if precond else "none")

    def j_make(s):
        return j_operators.RBFKernelSystemOperator(jnp.asarray(x), s, 2.0, 1.5, block=64,
                                                   impl="chunked")

    def t_make(s):
        return tc.RBFKernelSystemOperator(_t(x), s, 2.0, 1.5, block=64)

    ref = jc.solve_sequence(
        jnp.asarray(sh), jnp.asarray(bs), jc.SolveSpec(**kw), make_operator=j_make,
        make_preconditioner=(lambda op: jc.jacobi(1.0 + 4.0 * op.sqrt_h**2)) if precond
        else None)
    frozen = []
    real = kops.rbf_matvec

    def counting(*args, gate=None, **kwargs):
        if gate is not None and not bool(torch.any(gate)):
            frozen.append(1)
        return real(*args, gate=gate, **kwargs)

    kops.rbf_matvec = counting
    try:
        got = tc.solve_sequence(
            _t(sh), _t(bs), tc.SolveSpec(**kw), make_operator=t_make,
            make_preconditioner=(lambda op: tc.jacobi(1.0 + 4.0 * op.sqrt_h**2)) if precond
            else None)
    finally:
        kops.rbf_matvec = real
    np.testing.assert_array_equal(got.info.iterations.numpy(), np.asarray(ref.info.iterations))
    np.testing.assert_array_equal(got.info.matvecs.numpy(), np.asarray(ref.info.matvecs))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-10, atol=1e-10)
    # Frozen steps ran (the chunk's padding after convergence) and were gated.
    assert frozen
