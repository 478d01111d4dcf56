#!/usr/bin/env python3
"""Dense-K against matrix-free def-CG Newton sequences, in both packages.

The JAX reference (``repro``, matrix-free through its chunked Gram matvec)
and the PyTorch port (``repro_torch`` on the CPU, through the plain version
of its RBF Gram matvec kernel) each run ``laplace_gpc`` with def-CG(8, 12)
through ``RecycleManager`` twice on the same digits (seed 0, noise 0.10,
θ = λ = 3, f64): once with K materialized (``dense_matvec=True``) and once
matrix-free.  For each n and solver tol it prints, per package and path,
the final log p and the per-system iterations, and per package the
relative log p gap between its two paths.

The two paths differ only in the rounding of K·v, so the gap shows what a
solver tolerance leaves of the log p: how far a dense-vs-matrix-free
agreement bar can be held at that tolerance, in the reference as in the
port.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/matrix_free_witness.py \\
        --n 4000 --tol 1e-10 1e-12 [--json out.json]

At n = 4000 one run takes about five minutes on a few CPU cores (the
reference's matrix-free sequence is most of it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

K, ELL = 8, 12
THETA = LENGTHSCALE = 3.0
BLOCK = 1024


def run(package, xn, yn, solver_tol, dense):
    """``(final log p, per-system iterations)`` of one def-CG sequence."""
    if package == "repro":
        import jax.numpy as jnp
        from repro.core import RecycleManager
        from repro.gp import RBFKernel, laplace_gpc

        x, y = jnp.asarray(xn, jnp.float64), jnp.asarray(yn, jnp.float64)
        extra = {"impl": "chunked"}
    else:
        from repro_torch.core import RecycleManager
        from repro_torch.gp import RBFKernel, laplace_gpc

        x = torch.as_tensor(xn, dtype=torch.float64)
        y = torch.as_tensor(yn, dtype=torch.float64)
        extra = {}
    res = laplace_gpc(
        x, y, RBFKernel(theta=THETA, lengthscale=LENGTHSCALE), solver="defcg",
        recycle=RecycleManager(k=K, ell=ELL), solver_tol=solver_tol,
        newton_tol=1.0, dense_matvec=dense, block=BLOCK, **extra,
    )
    return res.logp, list(res.trace.solver_iterations)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[4000])
    ap.add_argument("--tol", type=float, nargs="+", default=[1e-10, 1e-12])
    ap.add_argument("--json", default=None, help="also write the rows here")
    args = ap.parse_args(argv)

    from repro_torch.data import make_infinite_digits

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    rows = []
    for n in args.n:
        xn, yn = make_infinite_digits(n, seed=0, noise=0.10)
        for tol in args.tol:
            for package in ("repro", "repro_torch"):
                (ld, it_d), (lm, it_m) = (run(package, xn, yn, tol, dense)
                                          for dense in (True, False))
                row = {"n": n, "tol": tol, "package": package,
                       "logp_dense": ld, "logp_matrix_free": lm,
                       "rel_gap": abs(lm - ld) / abs(ld),
                       "iterations_dense": it_d, "iterations_matrix_free": it_m}
                rows.append(row)
                print(f"n={n} tol={tol:g} {package:11s} log p dense {ld!r} matrix-free "
                      f"{lm!r} (rel gap {row['rel_gap']:.2e}); iterations {it_d} | {it_m}",
                      flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
