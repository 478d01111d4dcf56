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
:func:`make_preconditioner`.  What the port leaves out so far raises,
naming the ROADMAP item that brings it: ``MGeometryHarmonic`` (queue 1
item 9), the recovery ladder and stagnation detector (item 10),
``solve_batch`` (item 12), ``mesh=`` (item 13) and checkpointed
sequences (item 10).
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


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP queue 1 item {item}"
    )


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
        raise _not_ported("strategy=MGeometryHarmonic", 9)


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
    """
    spec = SolveSpec() if spec is None else spec
    if mesh is not None:
        raise _not_ported("the sharded engine (mesh=)", 13)
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
    ``b_seq[i]`` its right-hand side; the returned ``state`` seeds the
    next call.  ``spec.method`` is ``"defcg"`` or ``"deflsmr"`` (then
    ``A`` may be rectangular and the state's ``AW`` slot holds ``NW``).
    ``make_preconditioner`` maps each operator to its ``M`` apply; a spec
    with ``precond != "none"`` needs it.
    """
    spec = SolveSpec() if spec is None else spec
    if checkpoint is not None or checkpoint_every or resume:
        raise _not_ported("checkpointed, resumable sequences", 10)
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
        recovery_rungs=(spec.recovery_rungs if divergence_fallback else 0),
        stagnation_window=spec.stagnation_window,
    )
    return _finish_sequence(seq, spec, state0, len(b_seq))
