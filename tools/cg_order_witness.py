#!/usr/bin/env python3
"""How far the iteration kernels' rounding alone moves def-CG's counts.

Runs the dense and the matrix-free GP Newton sequences of ``chip_smoke.py``'s
main paths (n = 36 551, the digits data, def-CG(8, 12) through
``RecycleManager``, solver tol 1e-5) and the matrix-free Jacobi-
preconditioned front door twice on one tree of the port (``--src``): with
its kernels, and with the plain versions of the entries its loops call
for K1, K6 and K2 (PyTorch ops on the card: ``torch.dot`` and
``torch.matmul`` sum, and ``β·p + z`` rounds, in their own order).  Everything else, K3 to K5 included, is the
same in both runs.  Prints the per-system iterations, the Newton steps
and log p of each run; the last line is a JSON object.  Run against two
trees in one call to set their kernels beside one another and beside the
one plain order they share:

    python tools/cg_order_witness.py --label parent --src build/parent/src
    python tools/cg_order_witness.py --label change

Needs a CUDA card and ``nvcc``; about a minute a run after the build.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="change")
    parser.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("cg_order_witness: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.data import make_infinite_digits
    from repro_torch.gp import RBFKernel
    from repro_torch.kernels import cg_fused as cf
    from repro_torch.kernels import ops as kops

    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    xn, yn = make_infinite_digits(cs.PAPER_N, seed=0, noise=0.10)
    x = torch.as_tensor(xn, dtype=torch.float64, device="cuda")
    y = torch.as_tensor(yn, dtype=torch.float64, device="cuda")
    k_dense = RBFKernel(theta=cs.THETA, lengthscale=cs.LENGTHSCALE).gram(x)
    # The entries the tree's loops call for each kernel (its step arm where
    # the tree has one), and their plain versions.
    entries = (("fused_cg_step", "fused_cg_update"), ("fused_rz_step", "fused_rz_reduce"),
               ("fused_direction_step", "fused_deflate_direction"))
    swap = {}
    for names in entries:
        name = next(n for n in names if hasattr(cf, f"{n}_cuda"))
        swap[name] = (getattr(kops, name), getattr(cf, f"{name}_plain"))
    out = {"label": args.label, "swapped": sorted(swap)}
    paths = (("dense", True, "defcg"), ("matrix-free", False, "defcg"),
             ("matrix-free", False, "jacobi"))
    for order in ("kernel", "plain"):
        for name, (kernel_entry, plain) in swap.items():
            setattr(kops, name, kernel_entry if order == "kernel" else
                    (lambda *a, _plain=plain, backend="auto", **kw: _plain(*a, **kw)))
        for path, dense, solver in paths:
            run = cs.laplace_runs(torch, cf.LAUNCHES, x, y, k_dense if dense else None, 1e-5,
                                  f"[{args.label} {order} {path}]", solvers=(solver,),
                                  dense=dense)[solver]
            out[f"{order} {path} {solver}"] = {"iterations": run["iterations"],
                                               "newton_steps": run["newton_steps"],
                                               "logp": run["logp"]}
    for name, (kernel_entry, _) in swap.items():
        setattr(kops, name, kernel_entry)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
