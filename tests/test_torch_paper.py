"""The paper's Figs. 2–3 and Table 1 on the port against the live reference.

``benchmarks/paper_fig23.py`` and ``paper_table1.py`` at their own
``bench_n = 1200`` (``benchmarks/common.py: gpc_problem``: digits seed 0,
noise 0.10, RBF θ = λ = 3, f64, the dense K applied as ``K @ v``), run
here in both packages on the same numpy data, with the scripts' settings
line for line.  The torch drivers of these experiments live in this file
and in ``chip_smoke.py``'s ``paper`` phase (n = 36 551 on the card), not
in ``benchmarks/``.

* Fig. 2: per-system CG / def-CG(8, 12) iterations at solver tol 1e-5,
  equal or one apart a system: at tol 1e-5 a system can stop one
  iteration apart by rounding alone (ROADMAP P1).
* Fig. 3: the mean log10-residual slope per iteration after system 1 at
  solver tol 1e-8, to 5e-3, with the same verdict (def-CG steeper: P3).
* Table 1: iteration totals within one a system, the saving after
  system 1, and log p agreement with Cholesky under 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import RecycleManager as JManager  # noqa: E402
from repro.gp import RBFKernel as JKernel  # noqa: E402
from repro.gp import laplace_gpc as j_laplace  # noqa: E402
from repro_torch.core import RecycleManager as TManager  # noqa: E402
from repro_torch.data import make_infinite_digits  # noqa: E402
from repro_torch.gp import RBFKernel as TKernel  # noqa: E402
from repro_torch.gp import laplace_gpc as t_laplace  # noqa: E402

BENCH_N = 1200


def _packages():
    """``(name, laplace, manager, kernel, to_array, x, y, K)`` per package."""
    x, y = make_infinite_digits(BENCH_N, seed=0, noise=0.10)
    out = []
    for name, laplace, manager, kernel, conv in (
        ("reference", j_laplace, JManager, JKernel(3.0, 3.0), lambda a: jnp.asarray(a, jnp.float64)),
        ("port", t_laplace, TManager, TKernel(3.0, 3.0),
         lambda a: torch.as_tensor(a, dtype=torch.float64)),
    ):
        xa, ya = conv(x), conv(y)
        out.append((name, laplace, manager, kernel, xa, ya, kernel.gram(xa)))
    return out


def _slope(trace):
    """``paper_fig23.py``'s slope of one residual history."""
    r = np.asarray(trace)
    r = r[np.isfinite(r)]
    r = r[r > 0]
    if len(r) < 3:
        return 0.0
    return (np.log10(r[-1]) - np.log10(r[0])) / (len(r) - 1)


@pytest.fixture(scope="module")
def paper():
    """Table 1's three columns (Fig. 2 is its CG / def-CG pair) and
    Fig. 3's tol 1e-8 runs, per package."""
    out = {}
    for name, laplace, manager, kernel, x, y, kd in _packages():
        dense = dict(k_dense=kd, dense_matvec=True, newton_tol=1.0)
        runs = {
            "cholesky": laplace(x, y, kernel, solver="cholesky", **dense),
            "cg": laplace(x, y, kernel, solver="cg", solver_tol=1e-5, **dense),
            "defcg": laplace(x, y, kernel, solver="defcg",
                             recycle=manager(k=8, ell=12, refresh_aw="exact"),
                             solver_tol=1e-5, **dense),
            "cg8": laplace(x, y, kernel, solver="cg", solver_tol=1e-8, record_residuals=True,
                           solver_maxiter=800, **dense),
            "defcg8": laplace(x, y, kernel, solver="defcg",
                              recycle=manager(k=8, ell=12, tol=1e-8, maxiter=800),
                              solver_tol=1e-8, record_residuals=True, solver_maxiter=800,
                              **dense),
        }
        out[name] = runs
    return out


def test_fig2_per_system_iterations(paper):
    for solver in ("cg", "defcg"):
        ref = paper["reference"][solver].trace.solver_iterations
        got = paper["port"][solver].trace.solver_iterations
        assert len(got) == len(ref), (solver, got, ref)
        assert all(abs(a - b) <= 1 for a, b in zip(got, ref)), (solver, got, ref)
    # The paper's claim: def-CG below CG on every system after the first.
    port = paper["port"]
    assert all(d < c for c, d in zip(port["cg"].trace.solver_iterations[1:],
                                      port["defcg"].trace.solver_iterations[1:]))


def test_fig3_slopes(paper):
    slopes = {}
    for name, runs in paper.items():
        slopes[name] = [float(np.mean([_slope(np.asarray(t)) for t in
                                       runs[s].trace.residual_traces[1:]]))
                        for s in ("cg8", "defcg8")]
    (ref_cg, ref_def), (got_cg, got_def) = slopes["reference"], slopes["port"]
    assert abs(got_cg - ref_cg) < 5e-3 and abs(got_def - ref_def) < 5e-3, slopes
    assert (got_def < got_cg) == (ref_def < ref_cg) == True  # noqa: E712 (P3 pass)


def test_table1_totals_and_agreement(paper):
    summary = {}
    for name, runs in paper.items():
        chol = runs["cholesky"]
        its = {s: runs[s].trace.solver_iterations for s in ("cg", "defcg")}
        saving = 1.0 - sum(its["defcg"][1:]) / max(sum(its["cg"][1:]), 1)
        agreement = max(abs(runs[s].logp - chol.logp) / abs(chol.logp) for s in ("cg", "defcg"))
        summary[name] = (its, saving, agreement, chol.logp)
    (ref_its, ref_saving, _, ref_chol), (its, saving, agreement, chol) = (
        summary["reference"], summary["port"])
    for s in ("cg", "defcg"):
        assert abs(sum(its[s]) - sum(ref_its[s])) <= len(ref_its[s]), (s, its[s], ref_its[s])
    assert abs(chol - ref_chol) / abs(ref_chol) < 1e-10
    assert agreement < 1e-4
    assert saving > 0.15 and abs(saving - ref_saving) < 0.1
