"""gpc-mnist — the paper's own workload as a configuration.

The port's copy of ``repro.configs.gpc_mnist``: Laplace-approximation GP
classification on the (synthetic) infinite-digits 3-vs-5 task, the RBF
Gram matvec as the CG hot-spot, def-CG(k, ell) with harmonic-Ritz
recycling across the Newton sequence.  ``n`` here is paper-scale; smaller
runs shrink it with ``dataclasses.replace(CONFIG, n=...)``.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class GPCConfig:
    name: str = "gpc-mnist"
    n: int = 1_048_576          # paper-scale row count (2^20)
    d: int = 784
    theta: float = 3.0
    lengthscale: float = 3.0
    solver: str = "defcg"
    k: int = 8                  # recycled subspace size — def-CG(8, 12)
    ell: int = 12
    tol: float = 1e-5
    maxiter: int = 200
    newton_tol: float = 1.0
    max_newton: int = 12
    dtype: str = "float32"
    block: int = 1024           # the reference's fused-matvec row block


CONFIG = GPCConfig()
SMOKE = GPCConfig(name="gpc-smoke", n=256, maxiter=400, dtype="float64")
