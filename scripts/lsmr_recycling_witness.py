#!/usr/bin/env python3
"""Does recycled LSMR keep its saving as the least-squares sequence grows?

Runs ``benchmarks/lsq_bench.py``'s drifting ridge sequence (singular
values logspace(0, −3), drift 0.02, λ = 1e-4, tol 1e-8, 12 systems; the
numpy recipe of ``chip_smoke.drifting_lsq``) at the sizes given, through
both packages on the CPU, each cold (``lsmr`` per system) and recycled
(``solve_sequence_lsmr``, deflsmr(8, 48), exact NW refresh):

* the JAX reference (``repro.core``, x64);
* the PyTorch port (``repro_torch.core``, its kernels' plain versions).

Prints per-system iterations, total iterations and A/Aᵀ products, and the
products recycling saves, per package and size; the last line is a JSON
object.  ``chip_smoke.py``'s main-lsq runs the same sequence on the card
at 24 576 × 16 384.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/lsmr_recycling_witness.py \\
        --sizes 3072x2048 6144x4096

Takes about 25 minutes on an 8-core CPU at those two sizes (most of it
the 6 144 × 4 096 runs: 200 MB a system, two GEMVs an iteration).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

NUM, K, ELL, DAMP, TOL, MAXITER = 12, cs.LSQ_K, cs.LSQ_ELL, cs.LSQ_DAMP, cs.LSQ_TOL, 4000


def _reference(systems):
    mats = jnp.stack([jnp.asarray(A.numpy()) for A, _ in systems])
    bs = jnp.stack([jnp.asarray(b.numpy()) for _, b in systems])
    cold = [jc.lsmr(jc.DenseMatrixOperator(mats[i]), bs[i], damp=DAMP, tol=TOL, maxiter=MAXITER)
            for i in range(len(systems))]
    seq = jc.solve_sequence_lsmr_jit(mats, bs, k=K, ell=ELL, damp=DAMP,
                                     make_operator=jc.DenseMatrixOperator, tol=TOL,
                                     maxiter=MAXITER, refresh_aw="exact")
    return ([int(r.info.iterations) for r in cold], [int(r.info.matvecs) for r in cold],
            [bool(r.info.converged) for r in cold], np.asarray(seq.info.iterations).tolist(),
            np.asarray(seq.info.matvecs).tolist(), np.asarray(seq.info.converged).tolist())


def _port(systems):
    cold = [tc.lsmr(tc.DenseMatrixOperator(A), b, damp=DAMP, tol=TOL, maxiter=MAXITER)
            for A, b in systems]
    seq = tc.solve_sequence_lsmr([A for A, _ in systems], [b for _, b in systems], k=K,
                                 ell=ELL, damp=DAMP, make_operator=tc.DenseMatrixOperator,
                                 tol=TOL, maxiter=MAXITER, refresh_aw="exact")
    return ([int(r.info.iterations) for r in cold], [int(r.info.matvecs) for r in cold],
            [bool(r.info.converged) for r in cold], [int(i) for i in seq.info.iterations],
            [int(i) for i in seq.info.matvecs], [bool(c) for c in seq.info.converged])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", nargs="+", default=["3072x2048", "6144x4096"])
    args = parser.parse_args(argv)
    out = {}
    for size in args.sizes:
        m, n = (int(v) for v in size.split("x"))
        systems = list(cs.drifting_lsq(torch, NUM, m, n, "cpu"))
        for name, run in (("reference", _reference), ("port", _port)):
            t0 = time.perf_counter()
            ci, cm, cc, ri, rm, rc = run(systems)
            saved = 1 - sum(rm) / sum(cm)
            out[f"{size} {name}"] = row = {
                "cold_iterations": ci, "cold_matvecs": sum(cm), "cold_converged": all(cc),
                "recycled_iterations": ri, "recycled_matvecs": sum(rm),
                "recycled_converged": all(rc), "products_saved": saved,
                "wall_s": time.perf_counter() - t0}
            print(f"[{size} {name}] cold {ci} (sum {sum(ci)}, {sum(cm)} products, converged "
                  f"{all(cc)}); recycled {ri} (sum {sum(ri)}, {sum(rm)} products, converged "
                  f"{all(rc)}); recycling saves {saved:+.1%} of the products; "
                  f"{row['wall_s']:.0f} s", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
