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
resume=)`` runs a crash-resumable chunked sequence.  What the port
leaves out so far raises, naming the ROADMAP item that brings it:
``MGeometryHarmonic`` (queue 1, the other two strategies).
``solve_batch`` is absent (queue 1, batched and served solves).
``solve(..., mesh=)`` runs the sharded engine
(:mod:`repro_torch.core.sharded`) over the ranks of a solve mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import lsmr as lsmr_mod
from repro_torch.core import preconditioners as precond_mod
from repro_torch.core import recycle as recycle_mod
from repro_torch.core import solvers as solvers_mod
from repro_torch.core.engine import SolveInfo
from repro_torch.core.recycle import RecycleState, SequenceResult
from repro_torch.core.solvers import DEFAULT_WAW_JITTER
from repro_torch.core.strategies import (
    HarmonicRitz,
    MGeometryHarmonic,
    RecycleStrategy,
)

_METHODS = ("cg", "defcg", "lsmr", "deflsmr")
_LSQ_METHODS = ("lsmr", "deflsmr")
_SELECTS = ("largest", "smallest")
_REFRESH_MODES = ("exact", "stale")
_PRECONDS = ("none", "jacobi", "nystrom", "custom")


def _not_ported(what: str, item: str) -> NotImplementedError:
    """The refusal of a path the port leaves out, naming the ROADMAP item
    that brings it (by name: numbers move at each re-anchor)."""
    return NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


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


def _check_strategy(spec: SolveSpec) -> None:
    if isinstance(spec.strategy, MGeometryHarmonic):
        raise _not_ported("strategy=MGeometryHarmonic", "queue 1, the other two strategies")


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
    if spec.method in _LSQ_METHODS:
        if M is not None:
            raise ValueError(f"method={spec.method!r} takes no preconditioner apply")
        return _solve_lsq(A, b, spec, state, x0, record_residuals)
    _check_strategy(spec)

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
    _check_strategy(spec)
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
    apply; a spec with ``precond != "none"`` needs it.

    Crash resumability: ``checkpoint`` (a
    :class:`repro_torch.checkpoint.CheckpointManager`) with
    ``checkpoint_every`` systems per chunk saves the full resume image
    after each chunk; ``resume=True`` continues from the newest
    restorable checkpoint, reproducing the uninterrupted run's iterates
    exactly.
    """
    spec = SolveSpec() if spec is None else spec
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
