"""The paper's Fig. 4 on the port against the live reference.

``benchmarks/paper_fig4.py`` at ``bench_n = 1200`` in both packages on
the same data (``benchmarks/common.py: gpc_problem``): log p(y|f) of
Cholesky at Newton tol 1e-3 over the full set; the inducing subsets
(``subset_gpc``) at m = n/16, n/8, n/4, n/2; CG and def-CG(8, 12) at
solver tol 1e-8 over the full set; each as a relative error against the
exact column.  The reference draws each subset with
``jax.random.permutation(PRNGKey(m))``; the port runs its subset solve
(``gp.inducing._subset_gpc_at``) on those same indices, so the errors
are held to 1e-8 relative.  The iterative errors stay under 1e-7 and the
precision gap (best subset over the worse iterative) above 1e2 (P4).
The torch driver on the card is ``chip_smoke.py``'s ``paper`` phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import RecycleManager as JManager  # noqa: E402
from repro.gp import RBFKernel as JKernel  # noqa: E402
from repro.gp import laplace_gpc as j_laplace  # noqa: E402
from repro.gp import subset_gpc as j_subset  # noqa: E402
from repro_torch.core import RecycleManager as TManager  # noqa: E402
from repro_torch.data import make_infinite_digits  # noqa: E402
from repro_torch.gp import RBFKernel as TKernel  # noqa: E402
from repro_torch.gp import laplace_gpc as t_laplace  # noqa: E402
from repro_torch.gp.inducing import _subset_gpc_at  # noqa: E402

BENCH_N = 1200
SUBSETS = (BENCH_N // 16, BENCH_N // 8, BENCH_N // 4, BENCH_N // 2)


@pytest.fixture(scope="module")
def fig4():
    x, y = make_infinite_digits(BENCH_N, seed=0, noise=0.10)
    out = {}
    for name, laplace, manager, kernel, conv in (
        ("reference", j_laplace, JManager, JKernel(3.0, 3.0), lambda a: jnp.asarray(a, jnp.float64)),
        ("port", t_laplace, TManager, TKernel(3.0, 3.0),
         lambda a: torch.as_tensor(a, dtype=torch.float64)),
    ):
        xa, ya = conv(x), conv(y)
        kd = kernel.gram(xa)
        dense = dict(k_dense=kd, dense_matvec=True, newton_tol=1e-3)
        exact = laplace(xa, ya, kernel, solver="cholesky", **dense)
        rel = {}
        for m in SUBSETS:
            key = jax.random.PRNGKey(m)
            if name == "reference":
                sub = j_subset(xa, ya, kernel, m, key=key)
            else:
                idx = np.array(jax.random.permutation(key, BENCH_N)[:m])
                sub = _subset_gpc_at(xa, ya, kernel, idx)
            rel[f"subset_m={m}"] = abs(sub.logp_full - exact.logp) / abs(exact.logp)
        for solver in ("cg", "defcg"):
            recycle = manager(k=8, ell=12) if solver == "defcg" else None
            res = laplace(xa, ya, kernel, solver=solver, recycle=recycle, solver_tol=1e-8,
                          **dense)
            rel[solver] = abs(res.logp - exact.logp) / abs(exact.logp)
        out[name] = (exact.logp, rel)
    return out


def test_fig4_exact_column(fig4):
    (ref, _), (got, _) = fig4["reference"], fig4["port"]
    assert abs(got - ref) / abs(ref) < 1e-10


@pytest.mark.parametrize("m", SUBSETS)
def test_fig4_subset_errors_on_reference_indices(fig4, m):
    ref, got = fig4["reference"][1][f"subset_m={m}"], fig4["port"][1][f"subset_m={m}"]
    assert abs(got - ref) / ref < 1e-8, (got, ref)


def test_fig4_iterative_errors_and_gap(fig4):
    for name in ("reference", "port"):
        rel = fig4[name][1]
        assert rel["cg"] < 1e-7 and rel["defcg"] < 1e-7, (name, rel)
        best_subset = min(v for k, v in rel.items() if k.startswith("subset"))
        gap = best_subset / max(rel["cg"], rel["defcg"], 1e-16)
        assert gap > 1e2, (name, gap)
    # Bigger subsets come closer to the exact column (the Fig. 4 picture).
    errs = [fig4["port"][1][f"subset_m={m}"] for m in SUBSETS]
    assert errs[-1] < errs[0]
