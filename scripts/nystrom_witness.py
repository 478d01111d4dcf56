#!/usr/bin/env python3
"""Nyström against Jacobi preconditioning of the GP Newton sequence, in both
packages, and the port run on the reference's own sketch.

The JAX reference (``repro``) and the PyTorch port (``repro_torch`` on the
CPU) each run ``laplace_gpc`` through the ``SolveSpec`` front door
(def-CG(8, 12), solver tol 1e-5 as in the paper) on the same digits
(seed 0, noise 0.10, θ = λ = 3, f64) with ``precond`` = ``"none"``,
``"jacobi"`` and ``"nystrom"`` (rank 16; each package draws its own
sketch's probes: the reference from ``PRNGKey(0)``, the port from a
``torch.Generator`` seeded 0).  A fourth port run, ``nystrom-ref``, uses the
reference's sketch of the same K instead of its own, carried across with
``repro_torch.convert.nystrom_sketch_from_numpy``.  For each n it prints
the per-system iterations, the matvecs and the final log p of every run,
and the Ritz values of both sketches.

If the reference's Nyström run needs as many more iterations than its
Jacobi run as the port's does, the increase belongs to the method (a
rank-16 sketch of this K), not to the port's sketch; ``nystrom-ref`` says
the same from the other side.

K is applied as a dense ``K @ v`` (``dense_matvec=True``) so that the CPU
runs stay short; the sketch is of the same K either way, and the two
paths differ only in rounding (``scripts/matrix_free_witness.py``).

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/nystrom_witness.py \\
        --n 2000 4000 [--json out.json]

At n = 4000 the runs take a few minutes on a few CPU cores.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from unittest import mock

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

K, ELL = 8, 12
THETA = LENGTHSCALE = 3.0
RANK = 16
SOLVER_TOL = 1e-5


def reference_sketch(xn):
    """The sketch the reference's ``laplace_gpc`` makes of K: the same call
    on the same dense K product and key."""
    from repro.core import randomized_nystrom
    from repro.gp import RBFKernel

    k = RBFKernel(theta=THETA, lengthscale=LENGTHSCALE).gram(jnp.asarray(xn, jnp.float64))
    return randomized_nystrom(lambda v: k @ v, jnp.zeros(xn.shape[0], jnp.float64),
                              rank=RANK, key=jax.random.PRNGKey(0))


def run_reference(xn, yn, precond):
    from repro.core import SolveSpec
    from repro.gp import RBFKernel, laplace_gpc

    res = laplace_gpc(
        jnp.asarray(xn, jnp.float64), jnp.asarray(yn, jnp.float64),
        RBFKernel(theta=THETA, lengthscale=LENGTHSCALE),
        spec=SolveSpec(k=K, ell=ELL, tol=SOLVER_TOL, precond=precond, precond_rank=RANK),
        precond_key=jax.random.PRNGKey(0), solver_tol=SOLVER_TOL, newton_tol=1.0,
        dense_matvec=True,
    )
    return res


def run_port(xn, yn, precond, sketch=None):
    """The port's sequence; with ``sketch`` (a reference ``(U, lam)``) the
    Nyström runs use it in place of the port's own."""
    from repro_torch import convert
    from repro_torch.core import SolveSpec
    from repro_torch.gp import RBFKernel, laplace_gpc
    from repro_torch.gp import laplace as laplace_mod

    def go():
        return laplace_gpc(
            torch.as_tensor(xn, dtype=torch.float64), torch.as_tensor(yn, dtype=torch.float64),
            RBFKernel(theta=THETA, lengthscale=LENGTHSCALE),
            spec=SolveSpec(k=K, ell=ELL, tol=SOLVER_TOL, precond=precond, precond_rank=RANK),
            precond_generator=torch.Generator().manual_seed(0), solver_tol=SOLVER_TOL,
            newton_tol=1.0, dense_matvec=True,
        )

    if sketch is None:
        return go()
    carried = convert.nystrom_sketch_from_numpy(*sketch, dtype=torch.float64, device="cpu")
    with mock.patch.object(laplace_mod, "randomized_nystrom", lambda *a, **kw: carried):
        return go()


def own_port_sketch(xn):
    """The port's own sketch, as its ``laplace_gpc`` makes it."""
    from repro_torch.core import randomized_nystrom
    from repro_torch.gp import RBFKernel

    k = RBFKernel(theta=THETA, lengthscale=LENGTHSCALE).gram(
        torch.as_tensor(xn, dtype=torch.float64))
    return randomized_nystrom(lambda v: k @ v, torch.zeros(xn.shape[0], dtype=torch.float64),
                              rank=RANK, generator=torch.Generator().manual_seed(0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[2000, 4000])
    ap.add_argument("--json", default=None, help="also write the rows here")
    args = ap.parse_args(argv)

    from repro_torch.data import make_infinite_digits

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    rows = []
    for n in args.n:
        xn, yn = make_infinite_digits(n, seed=0, noise=0.10)
        ref_u, ref_lam = reference_sketch(xn)
        _, port_lam = own_port_sketch(xn)
        print(f"n={n} Ritz values of K's rank-{RANK} sketch: reference "
              f"{np.round(np.asarray(ref_lam), 3).tolist()}; port "
              f"{np.round(port_lam.numpy(), 3).tolist()}", flush=True)
        runs = [("repro", p, lambda p=p: run_reference(xn, yn, p))
                for p in ("none", "jacobi", "nystrom")]
        runs += [("repro_torch", p, lambda p=p: run_port(xn, yn, p))
                 for p in ("none", "jacobi", "nystrom")]
        runs.append(("repro_torch", "nystrom-ref",
                     lambda: run_port(xn, yn, "nystrom", (np.asarray(ref_u), np.asarray(ref_lam)))))
        for package, label, fn in runs:
            res = fn()
            row = {"n": n, "package": package, "precond": label, "logp": float(res.logp),
                   "iterations": [int(i) for i in res.trace.solver_iterations],
                   "matvecs": [int(m) for m in res.trace.solver_matvecs]}
            rows.append(row)
            print(f"n={n} {package:11s} {label:11s} iterations {row['iterations']} "
                  f"(total {sum(row['iterations'])}), matvecs {sum(row['matvecs'])}, "
                  f"log p {row['logp']!r}", flush=True)
        rows.append({"n": n, "ritz_reference": np.asarray(ref_lam).tolist(),
                     "ritz_port": port_lam.tolist()})
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
