"""One front door for every solve: ``SolveSpec`` + ``RecycleState``.

The counterpart of ``repro.core.api``: :func:`solve` (one system) and
:func:`solve_sequence` (N related systems), configured by the same frozen
:class:`SolveSpec` (same fields, same defaults, same validation) and
carrying the same :class:`RecycleState`.  ``method`` picks the SPD
solvers (``cg``, ``defcg``) or the least-squares ones (``lsmr``,
``deflsmr``: rectangular ``A``, ridge ``λ = spec.lsq_shift``; for
``deflsmr`` the state's ``AW`` slot carries ``NW = (AᵀA + λI)W``).

Preconditioners go in as ``M`` (:func:`solve`) or as a per-system
factory (:func:`solve_sequence`), built for ``spec.precond`` by
:func:`make_preconditioner`.  A failed solve climbs the recovery ladder
(``spec.recovery_rungs``), ``spec.stagnation_window`` arms the stall
detector, and ``solve_sequence(..., checkpoint=, checkpoint_every=,
resume=)`` runs a crash-resumable chunked sequence.  ``solve(...,
mesh=)`` runs the sharded engine (:mod:`repro_torch.core.sharded`) over
the ranks of a solve mesh.  :func:`solve_batch` and
:func:`solve_pool_step` run B tenants' solves (or sequences) of every
method at once, on the lane axis of the step kernels (K1, K6 and K2 for
cg / def-CG, K7 for LSMR).  ``b``, ``x0`` and bases may be pytrees on the
single and sequence doors.  :func:`solve_jit`, :func:`solve_batch_jit`
and :func:`solve_pool_step_jit` are the same doors with every masked loop
run as one compiled program (:mod:`repro_torch.core.engine`: CUDA graphs
on the card, captured once a shape).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import engine
from repro_torch.core import lsmr as lsmr_mod
from repro_torch.core import operators as ops_mod
from repro_torch.core import preconditioners as precond_mod
from repro_torch.core import pytree as pt
from repro_torch.core import recycle as recycle_mod
from repro_torch.core import solvers as solvers_mod
from repro_torch.core.engine import SolveInfo
from repro_torch.core.recycle import RecycleState, SequenceResult
from repro_torch.core.solvers import DEFAULT_WAW_JITTER
from repro_torch.core.strategies import (
    HarmonicRitz,
    RecycleStrategy,
    WindowedRecombine,
)

_METHODS = ("cg", "defcg", "lsmr", "deflsmr")
_LSQ_METHODS = ("lsmr", "deflsmr")
_SELECTS = ("largest", "smallest")
_REFRESH_MODES = ("exact", "stale")
_PRECONDS = ("none", "jacobi", "nystrom", "custom")


@dataclasses.dataclass(frozen=True)
class SolveSpec:
    """Declarative solver configuration — the reference's fields and
    defaults (see ``repro.core.api.SolveSpec`` for their meaning)."""

    method: str = "defcg"
    k: int = 8
    ell: int = 12
    tol: float = 1e-5
    atol: float = 0.0
    maxiter: int = 1000
    select: str = "largest"
    waw_jitter: float = DEFAULT_WAW_JITTER
    refresh_aw: str = "exact"
    precond: str = "none"
    precond_rank: int = 16
    precond_sigma: float = 1.0
    strategy: RecycleStrategy = HarmonicRitz()
    recovery_rungs: int = 3
    recovery_shift: float = 1e-6
    stagnation_window: int = 0
    lsq_shift: float = 0.0

    def __post_init__(self):
        if self.method not in _METHODS:
            raise ValueError(f"method must be one of {_METHODS}, got {self.method!r}")
        if self.select not in _SELECTS:
            raise ValueError(f"select must be one of {_SELECTS}, got {self.select!r}")
        if self.refresh_aw not in _REFRESH_MODES:
            raise ValueError(
                f"refresh_aw must be one of {_REFRESH_MODES}, got {self.refresh_aw!r}"
            )
        if self.precond not in _PRECONDS:
            raise ValueError(
                f"precond must be one of {_PRECONDS}, got {self.precond!r}"
            )
        if self.method in ("defcg", "deflsmr") and self.k < 1:
            raise ValueError(f"{self.method} needs k >= 1, got k={self.k}")
        if self.lsq_shift < 0:
            raise ValueError(f"lsq_shift must be >= 0, got {self.lsq_shift}")
        if self.lsq_shift != 0.0 and self.method not in _LSQ_METHODS:
            raise ValueError(
                f"lsq_shift is the ridge λ of the least-squares methods "
                f"{_LSQ_METHODS}; method={self.method!r} ignores it"
            )
        if self.method in _LSQ_METHODS and self.precond != "none":
            raise ValueError(
                f"method={self.method!r} has no preconditioner path; "
                "use precond='none'"
            )
        if self.ell < 0 or self.maxiter < 1 or self.precond_rank < 1:
            raise ValueError("ell >= 0, maxiter >= 1, precond_rank >= 1 required")
        if self.tol < 0 or self.atol < 0 or self.waw_jitter < 0:
            raise ValueError("tol, atol and waw_jitter must be non-negative")
        if not 0 <= self.recovery_rungs <= recycle_mod.MAX_RECOVERY_RUNGS:
            raise ValueError(
                f"recovery_rungs must be in [0, "
                f"{recycle_mod.MAX_RECOVERY_RUNGS}], got {self.recovery_rungs}"
            )
        if self.recovery_shift < 0 or self.stagnation_window < 0:
            raise ValueError(
                "recovery_shift and stagnation_window must be non-negative"
            )
        if not isinstance(self.strategy, RecycleStrategy):
            raise ValueError(
                "strategy must be a repro_torch.core.strategies.RecycleStrategy "
                f"instance, got {self.strategy!r}"
            )
        if self.refresh_aw == "stale" and not isinstance(self.strategy, HarmonicRitz):
            raise ValueError(
                f"refresh_aw='stale' conflicts with strategy="
                f"{type(self.strategy).__name__}: non-default strategies "
                "own their refresh policy (WindowedRecombine IS the "
                "guarded stale mode)"
            )
        if self.strategy.needs_preconditioner and self.precond == "none":
            raise ValueError(
                f"strategy={type(self.strategy).__name__} extracts in the "
                "preconditioner's geometry — it needs precond != 'none'"
            )
        if (isinstance(self.strategy, WindowedRecombine) and self.method == "defcg"
                and self.ell == 0):
            # No window, no transition: the carried AW is never re-derived
            # and the drift never updates.
            raise ValueError(
                "strategy=WindowedRecombine needs ell > 0 — its refresh "
                "recombines the recorded window"
            )


class SolveReport(NamedTuple):
    """Failure-handling diagnostics of a solve (int32 tensors)."""

    status: torch.Tensor
    rung: torch.Tensor
    guard_firings: torch.Tensor
    matvecs: torch.Tensor


def _make_report(info: SolveInfo, rung) -> SolveReport:
    def i32(v):
        return torch.as_tensor(v).to(torch.int32)

    return SolveReport(
        status=i32(info.status),
        rung=i32(rung),
        guard_firings=i32(info.guard_fired),
        matvecs=i32(info.matvecs),
    )


class SolveResult(NamedTuple):
    """What :func:`solve` returns: solution, diagnostics, next state."""

    x: torch.Tensor
    info: SolveInfo
    state: Optional[RecycleState]
    report: Optional[SolveReport] = None


class SequenceSolveResult(NamedTuple):
    """Per-system stacked outputs of :func:`solve_sequence` + final state."""

    x: torch.Tensor
    info: SolveInfo
    theta: Optional[torch.Tensor]
    state: RecycleState
    report: Optional[SolveReport] = None


class BatchSolveResult(NamedTuple):
    """Per-tenant stacked outputs of :func:`solve_batch` (leading axis B;
    ``(B, N)`` per-system fields with ``sequence=True``).  A broken tenant
    is retired into its own slot of ``report``, never into its
    neighbours'."""

    x: torch.Tensor
    info: SolveInfo
    state: Optional[RecycleState]
    report: Optional[SolveReport] = None


def make_preconditioner(
    A,
    spec: SolveSpec,
    template: torch.Tensor,
    *,
    diag: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Build the ``M`` apply for ``spec.precond`` (None for ``"none"``).

    ``"jacobi"`` needs ``diag`` (the operator diagonal); ``"nystrom"``
    needs ``generator`` (a :class:`torch.Generator` for the sketch's
    probes) and spends ``spec.precond_rank + 8`` matvecs on the sketch, an
    a-priori cost that amortizes across every solve reusing the apply.
    """
    if spec.precond == "none":
        return None
    if spec.precond == "jacobi":
        if diag is None:
            raise ValueError("precond='jacobi' needs diag=<operator diagonal>")
        return precond_mod.jacobi(diag)
    if spec.precond == "nystrom":
        if generator is None:
            raise ValueError("precond='nystrom' needs generator=<torch.Generator>")
        U, lam = precond_mod.randomized_nystrom(
            A, template, rank=spec.precond_rank, generator=generator
        )
        return precond_mod.nystrom_preconditioner(U, lam, spec.precond_sigma)
    raise ValueError(
        "precond='custom' supplies its own apply — pass it as M instead"
    )


def _check_m(spec: SolveSpec, M) -> None:
    if spec.precond != "none" and M is None:
        raise ValueError(
            f"spec.precond={spec.precond!r} but no M was passed — build one "
            "with repro_torch.core.make_preconditioner(A, spec, template, ...)"
        )


def _solve_lsq(A, b, spec: SolveSpec, state, x0, record_residuals) -> SolveResult:
    """``solve`` for ``method="lsmr"``/``"deflsmr"``: ``min ‖Ax − b‖² +
    spec.lsq_shift·‖x‖²``; ``info.residual_norm`` is the normal residual
    ``‖Âᵀr̂‖``.  Plain ``lsmr`` passes ``state`` through untouched."""
    if spec.method == "lsmr":
        res = lsmr_mod.lsmr(
            A, b, x0,
            damp=spec.lsq_shift, tol=spec.tol, atol=spec.atol, maxiter=spec.maxiter,
            record_residuals=record_residuals, stagnation_window=spec.stagnation_window,
        )
        return SolveResult(x=res.x, info=res.info, state=state,
                           report=_make_report(res.info, 0))
    # deflsmr: the basis lives in the DOMAIN, whose size b cannot reveal.
    n = state.W.shape[1] if state is not None else lsmr_mod.domain_size(A, x0)
    if state is None:
        state = RecycleState.zeros(spec.k, n, dtype=b.dtype, device=b.device)
    if state.W.ndim != 2 or tuple(state.W.shape) != (spec.k, n) or (
        x0 is not None and x0.shape[0] != n
    ):
        raise ValueError(
            f"state.W has shape {tuple(state.W.shape)}; spec(k={spec.k}) over "
            f"this system's domain needs ({spec.k}, {n}) — state and spec must agree"
        )
    x, info, w2, nw2, theta, rung = lsmr_mod._one_recycled_lsmr(
        A, b, x0, state.W, state.AW,
        k=spec.k, ell=spec.ell, damp=spec.lsq_shift, tol=spec.tol, atol=spec.atol,
        maxiter=spec.maxiter, select=spec.select, waw_jitter=spec.waw_jitter,
        refresh_aw=spec.refresh_aw, record_residuals=record_residuals,
        stagnation_window=spec.stagnation_window,
    )
    new_state = RecycleState(
        W=w2,
        AW=nw2,  # the AW slot carries NW = (AᵀA + λI)W for deflsmr
        theta=state.theta if theta is None else theta,
        systems_solved=state.systems_solved + 1,
        drift=state.drift,
    )
    return SolveResult(x=x, info=info, state=new_state, report=_make_report(info, rung))


def _solve_pytree(A, b, spec: SolveSpec, state, x0, M, record_residuals) -> SolveResult:
    """:func:`solve` on pytree ``b`` / ``x0``: the flat solve of their
    coordinates, ``x`` back in the solution's structure (the range's for
    the SPD methods, the domain's for the least-squares ones)."""
    if spec.method in _LSQ_METHODS:
        op, b_flat, x0_flat, unravel_x = lsmr_mod.flat_lsq_problem(A, b, x0)
        res = solve(op, b_flat, spec, state, x0=x0_flat, M=M,
                    record_residuals=record_residuals)
        return res._replace(x=unravel_x()(res.x))
    b_flat, unravel = pt.ravel_vector(b)
    res = solve(pt.flat_operator(A, unravel), b_flat, spec, state,
                x0=None if x0 is None else pt.ravel(x0),
                M=None if M is None else pt.flat_operator(M, unravel),
                record_residuals=record_residuals)
    return res._replace(x=unravel(res.x))


def solve(
    A,
    b: torch.Tensor,
    spec: Optional[SolveSpec] = None,
    state: Optional[RecycleState] = None,
    *,
    x0: Optional[torch.Tensor] = None,
    M=None,
    record_residuals: bool = False,
    mesh=None,
) -> SolveResult:
    """Solve one system per ``spec``, carrying ``state``.

    ``method="defcg"``/``"deflsmr"`` return the next :class:`RecycleState`
    (``state=None`` bootstraps cold, in ``b``'s dtype and device);
    ``method="cg"``/``"lsmr"`` pass ``state`` through untouched.  The
    least-squares methods take a rectangular ``A`` (adjoint through its
    ``rmatvec``): ``b`` lives in its range, ``x0`` and the solution in its
    domain.  ``info.matvecs`` includes the refresh the strategy spent.
    ``M`` is the preconditioner apply for ``spec.precond`` (see
    :func:`make_preconditioner`); the least-squares methods take none.
    ``b`` and ``x0`` may be pytrees (``A`` and ``M`` then map pytrees):
    the solve runs on their flat coordinates, the state stays flat, and
    ``x`` comes back in the solution's structure.

    ``mesh`` (a :class:`repro_torch.launch.SolveMesh`, from
    :func:`repro_torch.launch.make_solve_mesh`) runs the solve split by
    columns over the mesh's ranks (:func:`repro_torch.core.sharded.solve_sharded`):
    every rank passes the same global ``A``, ``b`` and ``x0``; ``x`` comes
    back whole on every rank, the returned state holds this rank's
    columns (``SolveMesh.gather_state`` makes it whole).  ``cg``,
    ``defcg`` and ``lsmr`` only, no preconditioner, no recovery ladder;
    one all-reduce per cg / def-CG iteration, two per LSMR iteration.
    """
    spec = SolveSpec() if spec is None else spec
    if mesh is not None:
        if M is not None:
            raise ValueError(
                "the sharded engine has no preconditioner path — M must "
                "be None when mesh= is given"
            )
        from repro_torch.core import sharded as sharded_mod

        return sharded_mod.solve_sharded(
            A, b, spec, state, mesh=mesh, x0=x0, record_residuals=record_residuals,
        )
    _check_m(spec, M)
    if not (pt.is_flat(b) and (x0 is None or pt.is_flat(x0))):
        return _solve_pytree(A, b, spec, state, x0, M, record_residuals)
    if spec.method in _LSQ_METHODS:
        if M is not None:
            raise ValueError(f"method={spec.method!r} takes no preconditioner apply")
        return _solve_lsq(A, b, spec, state, x0, record_residuals)
    if spec.method == "cg":
        res = solvers_mod.cg(
            A, b, x0,
            tol=spec.tol, atol=spec.atol, maxiter=spec.maxiter, M=M,
            record_residuals=record_residuals,
            stagnation_window=spec.stagnation_window,
        )
        return SolveResult(
            x=res.x, info=res.info, state=state,
            report=_make_report(res.info, 0),
        )

    n = b.shape[0]
    if state is None:
        state = RecycleState.zeros(spec.k, n, dtype=b.dtype, device=b.device)
    if state.W.ndim != 2 or tuple(state.W.shape) != (spec.k, n):
        raise ValueError(
            f"state.W has shape {tuple(state.W.shape)}; spec(k={spec.k}) over "
            f"this system needs ({spec.k}, {n}) — state and spec must agree"
        )
    x, info, w2, aw2, theta, drift2, rung = recycle_mod._one_recycled_solve(
        A,
        b,
        x0,
        state.W,
        state.AW,
        state.drift,
        k=spec.k,
        ell=spec.ell,
        tol=spec.tol,
        atol=spec.atol,
        maxiter=spec.maxiter,
        select=spec.select,
        waw_jitter=spec.waw_jitter,
        refresh_aw=spec.refresh_aw,
        strategy=spec.strategy,
        M=M,
        record_residuals=record_residuals,
        recovery_rungs=spec.recovery_rungs,
        recovery_shift=spec.recovery_shift,
        stagnation_window=spec.stagnation_window,
    )
    new_state = RecycleState(
        W=w2,
        AW=aw2,
        theta=state.theta if theta is None else theta,
        systems_solved=state.systems_solved + 1,
        drift=drift2.to(state.drift.dtype),
    )
    return SolveResult(
        x=x, info=info, state=new_state, report=_make_report(info, rung)
    )


def solve_jit(A, b, spec: Optional[SolveSpec] = None, state: Optional[RecycleState] = None, *,
              x0=None, M=None, record_residuals: bool = False, mesh=None) -> SolveResult:
    """:func:`solve` as one compiled program: its def-CG / cg / LSMR loop
    (and every re-solve of the recovery ladder) captured once a shape and
    replayed (:mod:`repro_torch.core.engine`), the setup, the ladder's host
    reads and the extraction eager between the graphs.  Same arguments and
    results as :func:`solve`, bit for bit.

    ``mesh=`` runs the sharded loop as :func:`solve` does: its collectives
    (``engine.psum_merged`` → ``SolveMesh.all_reduce``) run on the host
    between the step's kernels, where a graph cannot hold them, so each
    rank's loop stays eager (K8 still runs on the card).
    """
    if mesh is not None:
        return solve(A, b, spec, state, x0=x0, M=M, record_residuals=record_residuals,
                     mesh=mesh)
    with engine.compiled():
        return solve(A, b, spec, state, x0=x0, M=M, record_residuals=record_residuals)


def _finish_sequence(
    seq: SequenceResult,
    spec: SolveSpec,
    state0: Optional[RecycleState],
    num_systems: int,
) -> SequenceSolveResult:
    device = seq.W.device
    solved0 = (
        state0.systems_solved if state0 is not None
        else torch.zeros((), dtype=torch.int32, device=device)
    )
    if seq.theta is not None:
        theta = seq.theta[-1]
    elif state0 is not None:
        theta = state0.theta
    else:
        theta = torch.zeros((spec.k,), dtype=seq.W.dtype, device=device)
    state = RecycleState(
        W=seq.W,
        AW=seq.AW,
        theta=theta,
        systems_solved=solved0 + num_systems,
        drift=seq.drift,
    )
    return SequenceSolveResult(
        x=seq.x,
        info=seq.info,
        theta=seq.theta,
        state=state,
        report=_make_report(seq.info, seq.rung),
    )


def _solve_sequence_spec(
    systems: Any,
    b_seq,
    spec: SolveSpec,
    state0: Optional[RecycleState],
    *,
    make_operator: Optional[Callable[[Any], Any]],
    make_preconditioner: Optional[Callable[[Any], Any]],
    carry_x: bool,
    divergence_fallback: bool,
    x_prev0: Optional[torch.Tensor] = None,
) -> SequenceSolveResult:
    """The whole sequence in one engine call (no checkpoints)."""
    if spec.method not in ("defcg", "deflsmr"):
        raise ValueError(
            "solve_sequence recycles a deflation basis — it needs "
            f"spec.method='defcg' or 'deflsmr', got {spec.method!r}"
        )
    if spec.precond != "none" and make_preconditioner is None:
        raise ValueError(
            f"spec.precond={spec.precond!r} but no make_preconditioner was "
            "passed — the sequence path builds M per system, so supply a "
            "factory mapping each operator to its preconditioner apply"
        )
    if spec.method == "deflsmr":
        seq = lsmr_mod.solve_sequence_lsmr(
            systems,
            b_seq,
            state0.W if state0 is not None else None,
            state0.AW if state0 is not None else None,
            k=spec.k,
            ell=spec.ell,
            damp=spec.lsq_shift,
            make_operator=make_operator,
            tol=spec.tol,
            atol=spec.atol,
            maxiter=spec.maxiter,
            select=spec.select,
            waw_jitter=spec.waw_jitter,
            refresh_aw=spec.refresh_aw,
            carry_x=carry_x,
            stagnation_window=spec.stagnation_window,
            x_prev0=x_prev0,
        )
        return _finish_sequence(seq, spec, state0, len(b_seq))
    seq = recycle_mod.solve_sequence(
        systems,
        b_seq,
        state0.W if state0 is not None else None,
        state0.AW if state0 is not None else None,
        k=spec.k,
        ell=spec.ell,
        make_operator=make_operator,
        make_preconditioner=make_preconditioner,
        tol=spec.tol,
        atol=spec.atol,
        maxiter=spec.maxiter,
        select=spec.select,
        waw_jitter=spec.waw_jitter,
        refresh_aw=spec.refresh_aw,
        carry_x=carry_x,
        strategy=spec.strategy,
        drift0=state0.drift if state0 is not None else None,
        # divergence_fallback=False disarms the ladder; otherwise the
        # spec's depth governs.
        recovery_rungs=(spec.recovery_rungs if divergence_fallback else 0),
        recovery_shift=spec.recovery_shift,
        stagnation_window=spec.stagnation_window,
        x_prev0=x_prev0,
    )
    return _finish_sequence(seq, spec, state0, len(b_seq))


def _solve_sequence_chunked(
    systems: Any,
    b_seq,
    spec: SolveSpec,
    state0: Optional[RecycleState],
    *,
    make_operator: Optional[Callable[[Any], Any]],
    make_preconditioner: Optional[Callable[[Any], Any]],
    carry_x: bool,
    divergence_fallback: bool,
    checkpoint,
    checkpoint_every: int,
    resume: bool,
) -> SequenceSolveResult:
    """Crash-resumable sequence driver: chunks of ``checkpoint_every``
    systems, each one engine call, with the full resume image saved after
    every chunk (``checkpoint.save(..., blocking=True)``): the per-system
    outputs so far, the carried :class:`RecycleState`, the warm-start
    carry, and ``next_index`` in the checkpoint's ``extra``.

    ``resume=True`` continues from the newest restorable checkpoint.  The
    chunk boundaries are fixed and the image is stored at full precision,
    so a killed and resumed run reproduces the uninterrupted run's
    iterates exactly.
    """
    num = len(b_seq)
    b0 = b_seq[0]
    dtype, device = b0.dtype, b0.device
    if spec.method == "deflsmr":
        # Rectangular systems: the basis and the solution live in the
        # operator's domain.
        make_op = make_operator if make_operator is not None else (lambda s: s)
        n = (state0.W.shape[1] if state0 is not None
             else lsmr_mod.domain_size(make_op(recycle_mod.system_at(systems, 0))))
    else:
        n = b0.shape[0]
    if state0 is None:
        state0 = RecycleState.zeros(spec.k, n, dtype=dtype, device=device)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    # The resume image: everything needed to continue mid-sequence.
    acc = {
        "x": zeros((num, n)),
        "theta": zeros((num, spec.k)),
        "iterations": zeros((num,), torch.int32),
        "converged": zeros((num,), torch.bool),
        "residual_norm": zeros((num,)),
        "matvecs": zeros((num,), torch.int32),
        "breakdown": zeros((num,), torch.bool),
        "status": zeros((num,), torch.int32),
        "guard_fired": zeros((num,), torch.bool),
        "rung": zeros((num,), torch.int32),
        "state": state0,
        "x_carry": zeros((n,)),
    }
    start = 0
    if resume:
        restored = checkpoint.restore_latest(acc)
        if restored is not None:
            _, acc, extra = restored
            start = int(extra["next_index"])

    while start < num:
        stop = min(start + checkpoint_every, num)
        sl = slice(start, stop)
        res = _solve_sequence_spec(
            recycle_mod.system_at(systems, sl),
            b_seq[sl],
            spec,
            acc["state"],
            make_operator=make_operator,
            make_preconditioner=make_preconditioner,
            carry_x=carry_x,
            divergence_fallback=divergence_fallback,
            x_prev0=acc["x_carry"] if carry_x else None,
        )
        info = res.info
        acc["x"][sl] = res.x
        for key in ("iterations", "converged", "residual_norm", "matvecs", "breakdown",
                    "status", "guard_fired"):
            acc[key][sl] = torch.as_tensor(getattr(info, key)).to(acc[key].dtype)
        acc["rung"][sl] = res.report.rung
        if res.theta is not None:
            acc["theta"][sl] = res.theta
        acc["state"] = res.state
        acc["x_carry"] = res.x[-1]
        checkpoint.save(acc, step=stop, extra={"next_index": stop}, blocking=True)
        start = stop

    info = SolveInfo(
        iterations=acc["iterations"],
        converged=acc["converged"],
        residual_norm=acc["residual_norm"],
        matvecs=acc["matvecs"],
        breakdown=acc["breakdown"],
        status=acc["status"],
        guard_fired=acc["guard_fired"],
    )
    return SequenceSolveResult(
        x=acc["x"],
        info=info,
        theta=acc["theta"] if spec.ell > 0 else None,
        state=acc["state"],
        report=_make_report(info, acc["rung"]),
    )


class _FlatOperator:
    """A pytree operator on flat coordinates; ``op`` is the operator itself
    (what a per-system preconditioner factory is handed)."""

    def __init__(self, op, unravel):
        self.op = op
        self._mv = pt.flat_operator(op, unravel)

    def __call__(self, v):
        return self._mv(v)


def solve_sequence(
    systems: Any,
    b_seq: torch.Tensor,
    spec: Optional[SolveSpec] = None,
    state0: Optional[RecycleState] = None,
    *,
    make_operator: Optional[Callable[[Any], Any]] = None,
    make_preconditioner: Optional[Callable[[Any], Any]] = None,
    carry_x: bool = False,
    divergence_fallback: bool = True,
    checkpoint=None,
    checkpoint_every: int = 0,
    resume: bool = False,
) -> SequenceSolveResult:
    """Solve a sequence of related systems, spec-driven.

    ``systems[i]`` mapped through ``make_operator`` is the i-th operator,
    ``b_seq[i]`` its right-hand side; ``systems`` may be a tensor, a list,
    or a dict of them sliced per system
    (:func:`repro_torch.core.recycle.system_at`).  The returned ``state``
    seeds the next call.  ``spec.method`` is ``"defcg"`` or ``"deflsmr"``
    (then ``A`` may be rectangular and the state's ``AW`` slot holds
    ``NW``).  ``make_preconditioner`` maps each operator to its ``M``
    apply; a spec with ``precond != "none"`` needs it.  A dict ``b_seq``
    is a pytree whose leaves carry the leading system axis (the operators
    then map pytrees; ``x`` comes back in its structure); a list holds one
    flat vector per system.

    Crash resumability: ``checkpoint`` (a
    :class:`repro_torch.checkpoint.CheckpointManager`) with
    ``checkpoint_every`` systems per chunk saves the full resume image
    after each chunk; ``resume=True`` continues from the newest
    restorable checkpoint, reproducing the uninterrupted run's iterates
    exactly.
    """
    spec = SolveSpec() if spec is None else spec
    if isinstance(b_seq, dict):
        # Pytree right-hand sides (a dict whose leaves carry a leading
        # system axis; a list holds one flat vector per system): the flat
        # sequence of their coordinates, x back in their structure.
        _, unravel = pt.ravel_vector(pt.basis_vector(b_seq, 0))
        make_op = make_operator if make_operator is not None else (lambda sys: sys)
        res = solve_sequence(
            systems, pt.ravel_basis(b_seq), spec, state0,
            make_operator=lambda sys: _FlatOperator(make_op(sys), unravel),
            make_preconditioner=None if make_preconditioner is None else (
                lambda op: pt.flat_operator(make_preconditioner(op.op), unravel)),
            carry_x=carry_x, divergence_fallback=divergence_fallback, checkpoint=checkpoint,
            checkpoint_every=checkpoint_every, resume=resume,
        )
        return res._replace(x=pt.unravel_basis(res.x, unravel))
    if checkpoint is not None:
        if checkpoint_every < 1:
            raise ValueError(
                "checkpoint= needs checkpoint_every >= 1 (systems per "
                f"chunk), got {checkpoint_every}"
            )
        return _solve_sequence_chunked(
            systems, b_seq, spec, state0,
            make_operator=make_operator,
            make_preconditioner=make_preconditioner,
            carry_x=carry_x,
            divergence_fallback=divergence_fallback,
            checkpoint=checkpoint,
            checkpoint_every=checkpoint_every,
            resume=resume,
        )
    if resume or checkpoint_every:
        raise ValueError("resume=/checkpoint_every= need checkpoint=<CheckpointManager>")
    return _solve_sequence_spec(
        systems, b_seq, spec, state0,
        make_operator=make_operator,
        make_preconditioner=make_preconditioner,
        carry_x=carry_x,
        divergence_fallback=divergence_fallback,
    )


# ---------------------------------------------------------------------------
# solve_batch — B independent tenants on the lane axis of the step kernels
# ---------------------------------------------------------------------------


def _tenant_operator(A, i: int):
    """Tenant ``i``'s own operator of a shared-K batch (``sqrt_h`` (B, n)),
    as a per-tenant preconditioner factory expects it."""
    if isinstance(A, ops_mod.RBFKernelSystemOperator):
        return ops_mod.RBFKernelSystemOperator(A.x, A.sqrt_h[i], A.theta, A.lengthscale,
                                               A.block, A.backend)
    return ops_mod.KernelSystemOperator(A.kernel_matvec, A.sqrt_h[i])


def _system_lanes(systems: Any, j: int):
    """System ``j`` of every tenant's sequence: leaves ``(B, N, …)`` →
    ``(B, …)``; a shared-K batch's ``sqrt_h`` (B, N, n) → (B, n); a dense
    operator's ``(B, N, m, n)`` matrices → ``(B, m, n)``."""
    if isinstance(systems, ops_mod.RBFKernelSystemOperator):
        return ops_mod.RBFKernelSystemOperator(systems.x, systems.sqrt_h[:, j], systems.theta,
                                               systems.lengthscale, systems.block,
                                               systems.backend)
    if isinstance(systems, ops_mod.KernelSystemOperator):
        return ops_mod.KernelSystemOperator(systems.kernel_matvec, systems.sqrt_h[:, j])
    if isinstance(systems, ops_mod.DenseMatrixOperator):
        return ops_mod.DenseMatrixOperator(systems.mat[:, j])
    if isinstance(systems, dict):
        return {key: _system_lanes(val, j) for key, val in systems.items()}
    return systems[:, j]


def _lane_problem(systems: Any, B: int, make_operator, make_preconditioner):
    """``(A, M, m_applies)`` of one system across B tenants: the batched
    operator (:func:`repro_torch.core.operators.lane_operator`), the
    batched preconditioner apply, and the tenants' own applies (for the
    M-geometry's transition).  A ``DenseMatrixOperator`` over ``(B, m, n)``
    matrices, or ``make_operator=DenseMatrixOperator`` (or ``from_matrix``)
    over a ``(B, m, n)`` tensor, is B dense tenants held as ONE
    :class:`~repro_torch.core.operators.LaneDenseOperator` (one batched
    product on the card)."""
    if make_operator is None and isinstance(systems, ops_mod.DenseMatrixOperator):
        systems, make_operator = systems.mat, ops_mod.DenseMatrixOperator
    if make_operator in (ops_mod.DenseMatrixOperator, ops_mod.from_matrix) and isinstance(
            systems, torch.Tensor):
        A = ops_mod.LaneDenseOperator(systems)
        tenants = A.ops
    elif make_operator is None and isinstance(systems, ops_mod.KernelSystemOperator) and (
            systems.sqrt_h.ndim == 2):
        A = systems
        tenants = [_tenant_operator(A, i) for i in range(B)]
    else:
        make_op = make_operator if make_operator is not None else (lambda s: s)
        tenants = [make_op(recycle_mod.system_at(systems, i)) for i in range(B)]
        A = ops_mod.lane_operator(tenants)
    if make_preconditioner is None:
        return A, None, None
    applies = [make_preconditioner(op) for op in tenants]
    return A, precond_mod.lane_preconditioner(applies), applies


def _batched_zero_state(b_batch: torch.Tensor, spec: SolveSpec, A=None) -> RecycleState:
    """Cold per-tenant states: :meth:`RecycleState.zeros` with a leading B
    (``b_batch`` is ``(B, n)``, or ``(B, N, n)`` for sequences).  For the
    least-squares methods the basis lives in the domain of the batched
    operator ``A``, whose size ``b`` cannot reveal."""
    B = b_batch.shape[0]
    n = lsmr_mod.domain_size(A) if spec.method in _LSQ_METHODS else b_batch.shape[-1]
    dtype, device = b_batch.dtype, b_batch.device

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return RecycleState(W=zeros(B, spec.k, n), AW=zeros(B, spec.k, n), theta=zeros(B, spec.k),
                        systems_solved=zeros(B, dt=torch.int32), drift=zeros(B))


def _lane_info(info: SolveInfo) -> SolveInfo:
    """An LSMR batch's info with ``guard_fired`` per lane (LSMR has no
    guard), as def-CG's batch reports it."""
    return info._replace(guard_fired=torch.zeros_like(info.converged))


def _solve_lanes(A, b, spec: SolveSpec, state: RecycleState, x0, M, m_applies):
    """One def-CG (or def-LSMR) system for every tenant: ``(x, info, next
    state, report)``."""
    if spec.method == "deflsmr":
        x, info, w2, nw2, theta, rung = lsmr_mod._one_recycled_lsmr(
            A, b, x0, state.W, state.AW, lanes=True,
            k=spec.k, ell=spec.ell, damp=spec.lsq_shift, tol=spec.tol, atol=spec.atol,
            maxiter=spec.maxiter, select=spec.select, waw_jitter=spec.waw_jitter,
            refresh_aw=spec.refresh_aw, stagnation_window=spec.stagnation_window,
        )
        info = _lane_info(info)
        new_state = RecycleState(
            W=w2, AW=nw2, theta=state.theta if theta is None else theta,
            systems_solved=state.systems_solved + 1, drift=state.drift,
        )
        return x, info, new_state, _make_report(info, rung)
    x, info, w2, aw2, theta, drift2, rung = recycle_mod._one_recycled_solve(
        A, b, x0, state.W, state.AW, state.drift, lanes=True,
        k=spec.k, ell=spec.ell, tol=spec.tol, atol=spec.atol, maxiter=spec.maxiter,
        select=spec.select, waw_jitter=spec.waw_jitter, refresh_aw=spec.refresh_aw,
        strategy=spec.strategy, M=M, m_applies=m_applies,
        recovery_rungs=spec.recovery_rungs, recovery_shift=spec.recovery_shift,
        stagnation_window=spec.stagnation_window,
    )
    new_state = RecycleState(
        W=w2, AW=aw2, theta=state.theta if theta is None else theta,
        systems_solved=state.systems_solved + 1, drift=drift2.to(state.drift.dtype),
    )
    return x, info, new_state, _make_report(info, rung)


def solve_batch(
    systems: Any,
    b_batch: torch.Tensor,
    spec: Optional[SolveSpec] = None,
    state: Optional[RecycleState] = None,
    *,
    make_operator: Optional[Callable[[Any], Any]] = None,
    make_preconditioner: Optional[Callable[[Any], Any]] = None,
    sequence: bool = False,
    carry_x: bool = False,
) -> BatchSolveResult:
    """Solve B independent tenants' systems (or sequences) at once.

    The multi-tenant serving shape: every vector is ``(B, n)``, and one
    iteration of all B def-CG (or cg) solves is one product of the
    ``(B, n)`` stack and the lane-axis launches of the step kernels (K1's
    ``fused_cg_step``, K6's ``fused_rz_step`` for preconditioned tenants,
    K2's ``fused_direction_step``), each lane with its own scalars, flags,
    counts and recording slot.  The least-squares methods run one product
    of the stack and one of its adjoint an iteration and ONE lane-axis
    launch of K7's ``lsmr_step``.  Convergence is per lane; the host reads
    "any lane active" once per chunk.  Finished lanes freeze, so each
    tenant's answer is its own solve's.

    ``systems``: a ``KernelSystemOperator`` whose ``sqrt_h`` is ``(B, n)``
    (B tenants sharing ``K``: ONE ``K`` product of the ``(n, B)`` stack an
    iteration, one K3 call of r = B matrix-free, skipped on the card once
    every lane is frozen), a ``DenseMatrixOperator`` over ``(B, m, n)``
    matrices, or per-tenant data with a leading B mapped through
    ``make_operator`` (``DenseMatrixOperator`` / ``from_matrix`` over a
    ``(B, m, n)`` tensor, and tenants sharing a kernel, are still batched
    into one product; others run tenant by tenant).  ``make_preconditioner`` maps each tenant's
    operator to its ``M``.  ``state`` has a leading B on every leaf
    (``None``: every tenant cold; for ``deflsmr`` its basis lives in the
    operators' domain).  ``sequence=True``: leaves ``(B, N, …)``,
    ``b_batch`` ``(B, N, m)``, each tenant a sequence of N systems
    (``carry_x`` warm starts within it; ``defcg`` or ``deflsmr``); ``x`` /
    ``info`` / ``report`` are then ``(B, N, …)`` and ``state`` the tenants'
    final states.  ``method`` ``"cg"`` and ``"lsmr"`` pass ``state``
    through untouched.
    """
    spec = SolveSpec() if spec is None else spec
    if spec.precond != "none" and make_preconditioner is None:
        raise ValueError(
            f"spec.precond={spec.precond!r} but no make_preconditioner was passed — the "
            "batch builds each tenant's M from its operator"
        )
    B = b_batch.shape[0]
    if sequence:
        if spec.method not in ("defcg", "deflsmr"):
            raise ValueError("sequence=True requires spec.method='defcg' or 'deflsmr'")
        num = b_batch.shape[1]
        # def-LSMR's warm start lives in the domain: the first system's is
        # the zeros its solve starts from.
        x_prev = None if spec.method == "deflsmr" else torch.zeros_like(b_batch[:, 0])
        xs, infos, reports = [], [], []
        for j in range(num):
            A, M, applies = _lane_problem(_system_lanes(systems, j), B, make_operator,
                                          make_preconditioner)
            state = _batched_zero_state(b_batch, spec, A) if state is None else state
            x, info, state, report = _solve_lanes(
                A, b_batch[:, j].contiguous(), spec, state, x_prev if carry_x else None, M,
                applies)
            x_prev = x
            xs.append(x)
            infos.append(info)
            reports.append(report)

        def stack(items):
            cls = type(items[0])
            return cls(*(None if getattr(items[0], f) is None
                         else torch.stack([torch.as_tensor(getattr(it, f)) for it in items], 1)
                         for f in cls._fields))

        return BatchSolveResult(x=torch.stack(xs, 1), info=stack(infos), state=state,
                                report=stack(reports))

    A, M, applies = _lane_problem(systems, B, make_operator, make_preconditioner)
    if spec.method in ("cg", "lsmr"):
        if spec.method == "cg":
            res = solvers_mod.defcg_lanes(
                A, b_batch, tol=spec.tol, atol=spec.atol, maxiter=spec.maxiter, M=M,
                stagnation_window=spec.stagnation_window,
            )
            info = res.info
        else:
            res = lsmr_mod.lsmr(
                A, b_batch, damp=spec.lsq_shift, tol=spec.tol, atol=spec.atol,
                maxiter=spec.maxiter, stagnation_window=spec.stagnation_window, lanes=True,
            )
            info = _lane_info(res.info)
        return BatchSolveResult(x=res.x, info=info, state=state,
                                report=_make_report(info, torch.zeros_like(info.status)))
    state = _batched_zero_state(b_batch, spec, A) if state is None else state
    n = state.W.shape[-1]
    if state.W.ndim != 3 or tuple(state.W.shape) != (B, spec.k, n) or (
            spec.method == "defcg" and n != b_batch.shape[-1]):
        raise ValueError(
            f"state.W has shape {tuple(state.W.shape)}; spec(k={spec.k}) over {B} tenants "
            f"needs ({B}, {spec.k}, n) with n their systems' (domain) size"
        )
    x, info, new_state, report = _solve_lanes(A, b_batch, spec, state, None, M, applies)
    return BatchSolveResult(x=x, info=info, state=new_state, report=report)


# ---------------------------------------------------------------------------
# solve_pool_step — one slot-masked serving step over a fixed slot pool
# ---------------------------------------------------------------------------


def _slot_bcast(active: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A ``(B,)`` slot mask shaped to broadcast against a ``(B, …)`` leaf."""
    return active.reshape(active.shape + (1,) * (leaf.ndim - 1))


def solve_pool_step(
    systems: Any,
    b_batch: torch.Tensor,
    spec: Optional[SolveSpec],
    state: Optional[RecycleState],
    active: torch.Tensor,
    *,
    make_operator: Optional[Callable[[Any], Any]] = None,
    make_preconditioner: Optional[Callable[[Any], Any]] = None,
) -> BatchSolveResult:
    """One batched serving step over a fixed pool of B slots, mask-aware.

    ``active`` is the ``(B,)`` bool slot mask.  Inactive slots are served
    a ZERO right-hand side (``‖r₀‖ = 0``: they converge before iteration
    1 and freeze, so they never hold the batch's loop open), their
    :class:`RecycleState` passes through bit-untouched (a resident idle
    tenant keeps its warm basis and counter), and their ``info`` /
    ``report`` are scrubbed to 0 iterations, 0 matvecs and CONVERGED.  The
    refresh an idle warm slot's lane rides along in is pool overhead,
    charged to no tenant.
    """
    spec = SolveSpec() if spec is None else spec
    if spec.method not in ("defcg", "deflsmr"):
        raise ValueError(
            "solve_pool_step carries per-slot RecycleState — it needs "
            f"spec.method='defcg' or 'deflsmr', got {spec.method!r}"
        )
    active = torch.as_tensor(active, dtype=torch.bool, device=b_batch.device)
    b_masked = torch.where(_slot_bcast(active, b_batch), b_batch, 0.0)
    res = solve_batch(systems, b_masked, spec, state, make_operator=make_operator,
                      make_preconditioner=make_preconditioner)
    if state is None:  # every slot cold: the zeros the batch started from
        state = RecycleState(*(torch.zeros_like(getattr(res.state, f.name))
                               for f in dataclasses.fields(RecycleState)))

    def keep(new, old):
        return torch.where(_slot_bcast(active, new), new, old)

    state_out = RecycleState(*(keep(getattr(res.state, f.name), getattr(state, f.name))
                               for f in dataclasses.fields(RecycleState)))
    info = res.info
    zero = torch.zeros((), dtype=torch.int32, device=b_batch.device)
    masked = SolveInfo(
        iterations=torch.where(active, info.iterations, zero),
        converged=torch.where(active, info.converged, True),
        residual_norm=torch.where(active, info.residual_norm, 0.0),
        matvecs=torch.where(active, info.matvecs, zero),
        residual_norms=info.residual_norms,
        breakdown=active & torch.as_tensor(info.breakdown, dtype=torch.bool),
        status=torch.where(active, torch.as_tensor(info.status).to(torch.int32), zero),
        guard_fired=active & torch.as_tensor(info.guard_fired, dtype=torch.bool),
    )
    report = SolveReport(
        status=masked.status,
        rung=torch.where(active, res.report.rung, zero),
        guard_firings=masked.guard_fired.to(torch.int32),
        matvecs=masked.matvecs,
    )
    x = torch.where(_slot_bcast(active, res.x), res.x, 0.0)
    return BatchSolveResult(x=x, info=masked, state=state_out, report=report)


solve_batch_jit = engine.compiled_door(
    solve_batch, """:func:`solve_batch` as one compiled program: the lane loop (its
``(B,)`` flags read by the host once a chunk, as ``torch.any``) captured
once a shape and replayed.  Same arguments and results, bit for bit.""")

solve_pool_step_jit = engine.compiled_door(
    solve_pool_step, """:func:`solve_pool_step` as one compiled program: a pool of
one shape captures its lane loop once, and every later serving step with
new tenants' data replays it.  Same arguments and results, bit for bit.""")
