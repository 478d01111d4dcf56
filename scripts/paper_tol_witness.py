#!/usr/bin/env python3
"""Run the GP Newton sequence at the paper's solver tol in both packages.

The JAX reference (``repro``) and the PyTorch port (``repro_torch``, on the
CPU through its plain versions) each run ``laplace_gpc`` on the same digits
(``benchmarks/common.py`` settings: seed 0, noise 0.10, θ = 3, λ = 3, f64,
dense K) with Cholesky, CG, def-CG(8, 12) through ``RecycleManager`` and the
``SolveSpec`` front door, at solver tol 1e-5 and Newton tol 1.  For each n it
prints, per package and solver, the Newton steps and the largest per-step
relative log p gap to that package's own Cholesky run (paper Table 1's δ),
and, per solver, the largest per-step gap between the two packages.

If the port follows the reference, the two packages' δ columns agree in
size and grow with n together, and the gap between them is far below δ.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/paper_tol_witness.py \\
        --n 500 1000 2000 4000 [--json out.json]

n = 4000 holds a 128 MB K per package; the whole run takes minutes on a
few CPU cores.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

SOLVERS = ("cholesky", "cg", "defcg", "spec")
K, ELL = 8, 12
THETA = LENGTHSCALE = 3.0


def run(package, xn, yn, solver_tol):
    """``{solver: (per-step log p, per-system iterations)}`` in ``package``."""
    if package == "repro":
        import jax.numpy as jnp
        from repro.core import RecycleManager, SolveSpec
        from repro.gp import RBFKernel, laplace_gpc

        def as_array(a):
            return jnp.asarray(a, jnp.float64)
    else:
        from repro_torch.core import RecycleManager, SolveSpec
        from repro_torch.gp import RBFKernel, laplace_gpc

        def as_array(a):
            return torch.as_tensor(a, dtype=torch.float64)

    x, y = as_array(xn), as_array(yn)
    kernel = RBFKernel(theta=THETA, lengthscale=LENGTHSCALE)
    k_dense = kernel.gram(x)
    out = {}
    for solver in SOLVERS:
        kw = {"solver": solver}
        if solver == "defcg":
            kw["recycle"] = RecycleManager(k=K, ell=ELL, tol=solver_tol)
        if solver == "spec":
            kw = {"spec": SolveSpec(k=K, ell=ELL, tol=solver_tol)}
        res = laplace_gpc(x, y, kernel, solver_tol=solver_tol, newton_tol=1.0,
                          k_dense=k_dense, dense_matvec=True, **kw)
        out[solver] = (list(res.trace.logp), list(res.trace.solver_iterations))
    return out


def max_gap(a, b):
    """Largest relative gap over the Newton steps both traces have."""
    return max(abs(u - v) / abs(v) for u, v in zip(a, b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[500, 1000, 2000, 4000])
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--json", default=None, help="also write the rows here")
    args = ap.parse_args(argv)

    from repro.data import make_infinite_digits as ref_digits
    from repro_torch.data import make_infinite_digits as port_digits

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    rows = []
    print(f"solver tol {args.tol}; δ = max over Newton steps of |log p − log p_chol| / |log p_chol|")
    print(f"{'n':>6} {'solver':8} {'newton ref/port':>15} {'δ ref':>9} {'δ port':>9} "
          f"{'ref vs port':>11}  iterations (ref | port)")
    for n in args.n:
        xn, yn = ref_digits(n, seed=0, noise=0.10)
        xp, yp = port_digits(n, seed=0, noise=0.10)
        if not (np.array_equal(xn, xp) and np.array_equal(yn, yp)):
            raise AssertionError(f"n={n}: the two digit generators disagree")
        ref = run("repro", xn, yn, args.tol)
        port = run("repro_torch", xn, yn, args.tol)
        for solver in SOLVERS:
            (rl, ri), (pl, pi) = ref[solver], port[solver]
            row = {
                "n": n, "solver": solver,
                "newton_ref": len(rl), "newton_port": len(pl),
                "delta_ref": max_gap(rl, ref["cholesky"][0]),
                "delta_port": max_gap(pl, port["cholesky"][0]),
                "ref_vs_port": max_gap(pl, rl),
                "final_logp_ref": rl[-1], "final_logp_port": pl[-1],
                "iterations_ref": ri, "iterations_port": pi,
            }
            rows.append(row)
            its = "" if solver == "cholesky" else f"{ri} | {pi}"
            print(f"{n:6d} {solver:8} {len(rl):>7d}/{len(pl):<7d} {row['delta_ref']:9.2e} "
                  f"{row['delta_port']:9.2e} {row['ref_vs_port']:11.2e}  {its}", flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
