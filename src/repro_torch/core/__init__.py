"""repro_torch.core — recycled Krylov solvers on flat PyTorch tensors.

The front doors are ``solve`` / ``solve_sequence`` / ``solve_batch`` /
``solve_pool_step`` driven by one
``SolveSpec`` and carrying a ``RecycleState`` (``core/api.py``); ``cg``,
``defcg``, ``RecycleManager``, ``lsmr`` and ``solve_sequence_lsmr`` are
the lower-level entry points.  Each ``*_jit`` name is its door run as one
compiled program (``core/engine.py``: CUDA graphs on the card).
"""

from repro_torch.core.api import (
    BatchSolveResult,
    SequenceSolveResult,
    SolveReport,
    SolveResult,
    SolveSpec,
    make_preconditioner,
    solve,
    solve_batch,
    solve_batch_jit,
    solve_jit,
    solve_pool_step,
    solve_pool_step_jit,
    solve_sequence,
)
from repro_torch.core.engine import SolveInfo, SolveStatus
from repro_torch.core.faults import FaultInjectingOperator, truncate_latest_checkpoint
from repro_torch.core.lsmr import (
    lsmr,
    lsmr_jit,
    solve_sequence_lsmr,
    solve_sequence_lsmr_jit,
)
from repro_torch.core.operators import (
    DenseMatrixOperator,
    GaussNewtonOperator,
    GGNOperator,
    KernelSystemOperator,
    LinearOperator,
    RBFKernelSystemOperator,
    adjoint_matvec,
    apply_to_basis,
    from_callable,
    from_matrix,
    materialize,
)
from repro_torch.core.preconditioners import (
    JacobiPreconditioner,
    NystromPreconditioner,
    WoodburyKernelPreconditioner,
    jacobi,
    kernel_nystrom_preconditioner,
    nystrom_preconditioner,
    randomized_nystrom,
)
from repro_torch.core.recycle import (
    MAX_RECOVERY_RUNGS,
    RecycleManager,
    RecycleState,
    SequenceResult,
    harmonic_ritz,
    harmonic_ritz_flat,
    random_orthonormal_basis,
    recycled_solve_jit,
    solve_sequence_jit,
)
from repro_torch.core.solvers import (
    DEFAULT_WAW_JITTER,
    CGResult,
    RecycleData,
    cg,
    cholesky_solve,
    defcg,
    deflated_initial_guess,
)
from repro_torch.core.strategies import (
    HarmonicRitz,
    MGeometryHarmonic,
    RecycleStrategy,
    WindowedRecombine,
)

__all__ = [
    "BatchSolveResult",
    "CGResult",
    "DEFAULT_WAW_JITTER",
    "DenseMatrixOperator",
    "FaultInjectingOperator",
    "GGNOperator",
    "GaussNewtonOperator",
    "HarmonicRitz",
    "JacobiPreconditioner",
    "KernelSystemOperator",
    "LinearOperator",
    "MAX_RECOVERY_RUNGS",
    "MGeometryHarmonic",
    "NystromPreconditioner",
    "RBFKernelSystemOperator",
    "RecycleData",
    "RecycleManager",
    "RecycleState",
    "RecycleStrategy",
    "SequenceResult",
    "SequenceSolveResult",
    "SolveInfo",
    "SolveReport",
    "SolveResult",
    "SolveSpec",
    "SolveStatus",
    "WindowedRecombine",
    "WoodburyKernelPreconditioner",
    "adjoint_matvec",
    "apply_to_basis",
    "cg",
    "cholesky_solve",
    "defcg",
    "deflated_initial_guess",
    "from_callable",
    "from_matrix",
    "harmonic_ritz",
    "harmonic_ritz_flat",
    "jacobi",
    "kernel_nystrom_preconditioner",
    "lsmr",
    "lsmr_jit",
    "make_preconditioner",
    "materialize",
    "nystrom_preconditioner",
    "random_orthonormal_basis",
    "randomized_nystrom",
    "recycled_solve_jit",
    "solve",
    "solve_batch",
    "solve_batch_jit",
    "solve_jit",
    "solve_pool_step",
    "solve_pool_step_jit",
    "solve_sequence",
    "solve_sequence_jit",
    "solve_sequence_lsmr",
    "solve_sequence_lsmr_jit",
    "truncate_latest_checkpoint",
]
