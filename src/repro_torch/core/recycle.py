"""Krylov subspace recycling across a sequence of SPD systems.

The counterpart of ``repro.core.recycle`` (the paper's §2.3): the
:class:`RecycleState` carried from system to system, the per-system step
shared by every front door (:func:`_one_recycled_solve`), the sequence
engine (:func:`solve_sequence`, a Python loop over systems where the
reference scans), and the host-driven :class:`RecycleManager`.

A solve that ends broken, or unconverged with a carried basis, climbs the
reference's escalating recovery ladder (:func:`_one_recycled_solve`): a
Python loop over rungs, one host read a rung (the clean path pays the
one read that finds it clean), never one a step.  A clean solve reports
rung 0, as the reference does.  The same system step serves a batch of
tenants (``solve_batch``, ``lanes=True``): every decision per lane, one
host read where any lane must act.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import engine
from repro_torch.core import operators as ops_mod
from repro_torch.core import pytree as pt
from repro_torch.core.engine import SolveInfo
from repro_torch.core.solvers import (
    DEFAULT_WAW_JITTER,
    CGResult,
    RecycleData,
    defcg,
    defcg_jit,
    defcg_lanes,
)
from repro_torch.core.strategies import (
    HarmonicRitz,
    RecycleStrategy,
    extract_next_basis_core,
    harmonic_ritz_flat_core,
)

# Highest rung the recovery ladder can climb (see ``_one_recycled_solve``).
MAX_RECOVERY_RUNGS = 3


@dataclasses.dataclass
class RecycleState:
    """Recycled-subspace state — the carry of every solve path.

    Attributes:
      W: flat ``(k, n)`` recycled basis rows (zero rows are empty slots).
      AW: ``(k, n)`` A-products of ``W`` under the operator that made them.
      theta: ``(k,)`` harmonic Ritz values (0 = clamped slot).
      systems_solved: 0-d int32 tensor — how many solves fed this state.
      drift: 0-d tensor — the strategy's carried drift measurement.
    """

    W: torch.Tensor
    AW: torch.Tensor
    theta: torch.Tensor
    systems_solved: torch.Tensor
    drift: torch.Tensor

    @classmethod
    def zeros(cls, k: int, n: int, *, dtype: torch.dtype,
              device) -> "RecycleState":
        """A cold (empty) state: the first solve runs plain CG + record."""
        return cls(
            W=torch.zeros((k, n), dtype=dtype, device=device),
            AW=torch.zeros((k, n), dtype=dtype, device=device),
            theta=torch.zeros((k,), dtype=dtype, device=device),
            systems_solved=torch.zeros((), dtype=torch.int32, device=device),
            drift=torch.zeros((), dtype=dtype, device=device),
        )


def harmonic_ritz(
    Z: Any, AZ: Any, k: int, *, select: str = "largest", jitter: float = 1e-10
) -> Tuple[Any, Any, torch.Tensor]:
    """``k`` harmonic Ritz pairs from a stacked basis ``Z`` of m ≥ k
    vectors (a pytree with a leading basis axis, or an ``(m, n)`` tensor)
    and its A-products ``AZ``: ``(W, AW, theta)``, ``W`` and ``AW`` shaped
    like ``Z`` with k vectors.  The extraction is
    :func:`~repro_torch.core.strategies.harmonic_ritz_flat_core`'s on the
    raveled rows; slots past the surviving positive Ritz pairs are exact
    zeros (θ = 0)."""
    m = pt.basis_size(Z)
    if k > m:
        raise ValueError(f"cannot extract k={k} Ritz vectors from m={m} basis")
    W, AW, theta, _ = harmonic_ritz_flat_core(pt.ravel_basis(Z), pt.ravel_basis(AZ), k,
                                              select=select, jitter=jitter)
    if pt.is_flat(Z) and Z.ndim == 2:
        return W, AW, theta
    _, unravel = pt.ravel_vector(pt.basis_vector(Z, 0))
    return pt.unravel_basis(W, unravel), pt.unravel_basis(AW, unravel), theta


def random_orthonormal_basis(generator: torch.Generator, template: Any, k: int) -> Any:
    """``k`` orthonormal standard-normal vectors shaped like ``template`` (a
    tensor or a pytree), stacked on a leading axis: Gram-Schmidt on the
    raveled vectors, drawn from ``generator`` one vector at a time (the
    bootstrap ``W``; a ``torch.Generator`` in place of the reference's
    key).  A flat ``(n,)`` template gives a ``(k, n)`` tensor."""
    flat, unravel = pt.ravel_vector(template)
    vs = []
    for _ in range(k):
        v = torch.randn(flat.shape, generator=generator, dtype=flat.dtype, device=flat.device)
        for u in vs:
            v = v - torch.dot(u, v) * u
        vs.append(v / torch.linalg.vector_norm(v))
    rows = torch.stack(vs)
    return rows if pt.is_flat(template) and template.ndim == 1 else pt.unravel_basis(rows,
                                                                                     unravel)


def harmonic_ritz_flat(
    Z: torch.Tensor,
    AZ: torch.Tensor,
    k: int,
    *,
    valid: Optional[torch.Tensor] = None,
    select: str = "largest",
    jitter: float = 1e-10,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Harmonic Ritz over flat ``(m, n)`` row bases: ``(W, AW, theta)``."""
    W, AW, theta, _ = harmonic_ritz_flat_core(
        Z, AZ, k, valid=valid, select=select, jitter=jitter
    )
    return W, AW, theta


def _lane_mask(mask: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A per-system (0-d) or per-lane (``(B,)``) mask shaped to broadcast
    against ``t``."""
    return mask.reshape(mask.shape + (1,) * (t.ndim - mask.ndim))


def _transition(strategy, w, aw, window, *, k, select, m_apply, lanes):
    """``strategy.transition`` into ``(W', AW', θ, drift)``; on a lane axis
    lane by lane (K4 and K5 once a lane), ``m_apply`` then the tenants'
    own applies, the outputs stacked."""
    if not lanes:
        return strategy.transition(w, aw, window, k=k, select=select, m_apply=m_apply)
    outs = []
    for i in range(w.shape[0]):
        win = RecycleData(P=window.P[i], AP=window.AP[i], stored=window.stored[i],
                          alpha=window.alpha[i], beta=window.beta[i])
        outs.append(strategy.transition(w[i], aw[i], win, k=k, select=select,
                                        m_apply=None if m_apply is None else m_apply[i]))
    return tuple(torch.stack([o[q] for o in outs]) for q in range(4))


def _one_recycled_solve(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor],
    w: torch.Tensor,
    aw_carry: torch.Tensor,
    drift: torch.Tensor,
    *,
    k: int,
    ell: int,
    tol: float,
    atol: float,
    maxiter: int,
    select: str,
    waw_jitter: float,
    refresh_aw: str,
    strategy: RecycleStrategy,
    M=None,
    record_residuals: bool = False,
    recovery_rungs: int = 0,
    recovery_shift: float = 1e-6,
    stagnation_window: int = 0,
    lanes: bool = False,
    m_applies=None,
):
    """ONE system of the recycled def-CG step, on flat state.

    ``strategy.prepare`` picks the ``AW`` that deflates this system and
    its cost; ``strategy.transition`` turns the recorded window into the
    next ``(W, AW, θ, drift)``.  ``M`` preconditions the solve (the
    split-preconditioned def-CG of :func:`repro_torch.core.solvers.defcg`).

    ``lanes``: the same step for B tenants (``solve_batch``): ``b``
    ``(B, n)``, state leaves with a leading B, ``A`` / ``M`` batched
    (:func:`repro_torch.core.solvers.defcg_lanes`), ``m_applies`` the
    tenants' own ``M`` applies for the transition.  Every decision below
    is then per lane: the refresh runs when ANY lane needs it (one host
    read) and each lane keeps its own result; a ladder rung runs when any
    lane climbs it, the other lanes riding along on a zero right-hand
    side (converged before iteration 1) and keeping their incumbent.

    ``recovery_rungs > 0`` arms the reference's recovery ladder.  When the
    attempt ends broken (``info.breakdown``), or unconverged with a
    carried basis, up to :data:`MAX_RECOVERY_RUNGS` re-solves follow:

    1. keep ``W``, refresh ``AW = A·W`` exactly (k matvecs, charged) and
       re-solve: repairs stale or poisoned products;
    2. re-solve with a zeroed basis (the cold path: the extraction
       re-seeds the sequence);
    3. zero basis, the preconditioner gated to the identity and the
       operator shifted to ``A + σI`` (σ = ``recovery_shift``): only on a
       breakdown, the last resort against an indefinite or singular
       operator.

    A basis-less solve that fails without a breakdown never climbs.  Every
    attempt's matvecs are charged; the adopted ``x`` (and its ``info``) is
    the attempt with the smallest finite, unbroken residual, while the
    basis comes from the last rung run.  One host read a rung decides
    whether it runs.  Then the terminal retirement: a solve still broken
    returns the finite warm start and a zeroed state.

    Returns ``(x, info, w_next, aw_next, theta, drift_next, rung)``;
    ``theta`` is ``None`` when ``ell == 0``, and ``rung`` (int32) is the
    highest rung run (0: clean, or the ladder disarmed).
    """
    solve = defcg_lanes if lanes else defcg
    m_apply = m_applies if lanes else M
    aw_used, refresh_matvecs, exact_aw, stale_guard = strategy.prepare(
        lambda ww: ops_mod.apply_to_basis(A, ww),
        w,
        aw_carry,
        drift,
        k=k,
        refresh_aw=refresh_aw,
        tol=tol,
    )
    result = solve(
        A,
        b,
        x0,
        W=w,
        AW=aw_used,
        ell=ell,
        tol=tol,
        atol=atol,
        maxiter=maxiter,
        record_residuals=record_residuals,
        waw_jitter=waw_jitter,
        exact_aw=exact_aw,
        M=M,
        stale_guard=stale_guard,
        stagnation_window=stagnation_window,
    )
    if result.recycle is not None and result.recycle.aw_used is not None:
        aw_used = result.recycle.aw_used
    info = result.info._replace(matvecs=result.info.matvecs + refresh_matvecs)
    if ell > 0:
        w_next, aw_next, theta, drift_next = _transition(
            strategy, w, aw_used, result.recycle, k=k, select=select, m_apply=m_apply,
            lanes=lanes)
    else:
        w_next, aw_next, theta, drift_next = w, aw_used, None, drift

    rung = torch.zeros(b.shape[:-1], dtype=torch.int32, device=b.device)
    if recovery_rungs <= 0:
        return result.x, info, w_next, aw_next, theta, drift_next, rung

    rungs = min(int(recovery_rungs), MAX_RECOVERY_RUNGS)
    x = result.x
    had_basis = torch.any((w != 0).flatten(-2), dim=-1)
    for i in range(1, rungs + 1):
        broken = info.breakdown
        climb = (broken | ~info.converged) & (had_basis | broken)
        if i == MAX_RECOVERY_RUNGS:
            climb = climb & broken
        # Rung 1 keeps W with freshly refreshed products; rungs 2-3 zero
        # the basis; rung 3 also shifts the operator and gates M.
        refresh = climb & had_basis if i == 1 else torch.zeros_like(climb)
        any_climb, any_refresh = torch.stack([torch.any(climb), torch.any(refresh)]).tolist()
        if not any_climb:
            break
        w_att = w if i == 1 else torch.zeros_like(w)
        aw_att = torch.zeros_like(w)
        if any_refresh:
            aw_att = torch.where(_lane_mask(refresh, w), ops_mod.apply_to_basis(A, w), aw_att)
        A_att, M_att = A, M
        if i == MAX_RECOVERY_RUNGS:
            A_att = _shifted(A, recovery_shift)
            M_att = None if M is None else _identity
        res = solve(
            A_att, torch.where(_lane_mask(climb, b), b, 0.0),
            None if x0 is None else torch.where(_lane_mask(climb, x0), x0, 0.0),
            W=w_att, AW=aw_att, ell=ell, tol=tol, atol=atol,
            maxiter=maxiter, record_residuals=record_residuals,
            waw_jitter=waw_jitter, exact_aw=True, M=M_att, stale_guard=None,
            stagnation_window=stagnation_window,
        )
        i2 = res.info
        if ell > 0:
            w2, aw2, th2, d2 = _transition(strategy, w_att, aw_att, res.recycle, k=k,
                                           select=select, m_apply=m_apply, lanes=lanes)
        else:
            w2, aw2, th2, d2 = w_att, aw_att, None, drift_next
        # Adopt whichever attempt holds the better residual (a broken or
        # non-finite incumbent loses), and charge every attempt.
        warm_ok = torch.isfinite(info.residual_norm) & ~info.breakdown
        take = climb & (~warm_ok | (i2.residual_norm < info.residual_norm))

        def pick(new, cur, sel=take):
            return None if new is None else torch.where(_lane_mask(sel, new), new, cur)

        x = pick(res.x, x)
        info = SolveInfo(
            iterations=pick(i2.iterations, info.iterations),
            converged=pick(i2.converged, info.converged),
            residual_norm=pick(i2.residual_norm, info.residual_norm),
            matvecs=info.matvecs + torch.where(climb, i2.matvecs + k * refresh.to(torch.int32),
                                               0),
            residual_norms=pick(i2.residual_norms, info.residual_norms),
            breakdown=pick(i2.breakdown, info.breakdown),
            status=pick(i2.status, info.status),
            guard_fired=info.guard_fired,
        )
        # The basis comes from the last rung each lane ran.
        w_next, aw_next = pick(w2, w_next, climb), pick(aw2, aw_next, climb)
        theta = None if theta is None else pick(th2, theta, climb)
        drift_next = pick(d2, drift_next, climb)
        rung = torch.where(climb, i, rung).to(torch.int32)

    # The terminal retirement: a solve still broken after the ladder
    # returns finite coordinates and hands no poisoned subspace on.
    x_safe = torch.zeros_like(x) if x0 is None else x0.to(x.dtype)
    x_safe = torch.where(torch.isfinite(x_safe), x_safe, 0.0)
    x = torch.where(torch.all(torch.isfinite(x), dim=-1, keepdim=True), x, x_safe)
    retire = (
        info.breakdown
        | ~torch.all(torch.isfinite(w_next).flatten(-2), dim=-1)
        | ~torch.all(torch.isfinite(aw_next).flatten(-2), dim=-1)
    )
    w_next = torch.where(_lane_mask(retire, w_next), 0.0, w_next)
    aw_next = torch.where(_lane_mask(retire, aw_next), 0.0, aw_next)
    if theta is not None:
        theta = torch.where(_lane_mask(retire, theta), 0.0, theta)
    drift_next = torch.where(retire, torch.zeros_like(drift_next), drift_next)
    return x, info, w_next, aw_next, theta, drift_next, rung


def _identity(v):
    return v


def _shifted(A, sigma: float):
    """``v ↦ A v + σ v``: rung 3's shifted operator (one eager add a
    product)."""

    def apply(v):
        return torch.add(A(v), v, alpha=sigma)

    return apply


class SequenceResult(NamedTuple):
    """Stacked outputs of :func:`solve_sequence` (leading axis = system)."""

    x: torch.Tensor
    info: SolveInfo
    theta: Optional[torch.Tensor]
    W: torch.Tensor
    AW: torch.Tensor
    drift: Optional[torch.Tensor] = None
    rung: Optional[torch.Tensor] = None


def system_at(systems: Any, i):
    """System ``i`` (an int or a slice) of a sequence: ``systems[i]``, or
    for a dict (e.g. ``{"mat": mats, "poison": poison}``) the dict of its
    values' entries ``i``, as the reference's scan slices a pytree."""
    if isinstance(systems, dict):
        return {key: system_at(val, i) for key, val in systems.items()}
    return systems[i]


def _stack_infos(infos) -> SolveInfo:
    def stack(field):
        vals = [getattr(i, field) for i in infos]
        if vals[0] is None:
            return None
        return torch.stack([torch.as_tensor(v) for v in vals])

    return SolveInfo(*(stack(f) for f in SolveInfo._fields))


def solve_sequence(
    systems: Any,
    b_seq: torch.Tensor,
    W0: Optional[torch.Tensor] = None,
    AW0: Optional[torch.Tensor] = None,
    *,
    k: int,
    ell: int,
    make_operator: Optional[Callable[[Any], Any]] = None,
    make_preconditioner: Optional[Callable[[Any], Any]] = None,
    tol: float = 1e-5,
    atol: float = 0.0,
    maxiter: int = 1000,
    select: str = "largest",
    waw_jitter: float = DEFAULT_WAW_JITTER,
    refresh_aw: str = "exact",
    carry_x: bool = False,
    strategy: Optional[RecycleStrategy] = None,
    drift0: Optional[torch.Tensor] = None,
    recovery_rungs: int = MAX_RECOVERY_RUNGS,
    recovery_shift: float = 1e-6,
    stagnation_window: int = 0,
    x_prev0: Optional[torch.Tensor] = None,
) -> SequenceResult:
    """Solve a sequence of related SPD systems, carrying ``(W, AW)``.

    ``systems[i]`` (a tensor with a leading system axis, a list, or a
    dict of such tensors, each indexed by system: :func:`system_at`) is
    mapped through ``make_operator`` to the i-th operator; ``b_seq`` is
    ``(num_systems, n)``.  ``make_preconditioner`` maps each operator to
    its ``M`` apply (``None``: unpreconditioned).  Per-system semantics are
    :func:`_one_recycled_solve`'s, shared with the single-system front
    door.  ``x_prev0`` is the warm start of the first system under
    ``carry_x`` (zeros when None).  Outputs are stacked as the reference's
    scan stacks them.
    """
    if refresh_aw not in ("exact", "stale"):
        raise ValueError(f"unknown refresh_aw={refresh_aw!r}")
    if refresh_aw == "stale" and W0 is not None and AW0 is None:
        raise ValueError("refresh_aw='stale' with W0 requires AW0")
    strategy = HarmonicRitz() if strategy is None else strategy
    make_op = make_operator if make_operator is not None else (lambda s: s)
    n = b_seq.shape[1]
    dtype, device = b_seq.dtype, b_seq.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    w = zeros(k, n) if W0 is None else W0.to(dtype)
    aw = zeros(k, n) if (AW0 is None or W0 is None) else AW0.to(dtype)
    x_prev = zeros(n) if x_prev0 is None else x_prev0.to(dtype)
    drift = zeros() if drift0 is None else drift0.to(dtype)

    xs, infos, thetas, rungs = [], [], [], []
    for i in range(b_seq.shape[0]):
        A = make_op(system_at(systems, i))
        x, info, w, aw, theta, drift, rung = _one_recycled_solve(
            A,
            b_seq[i],
            x_prev if carry_x else None,
            w,
            aw,
            drift,
            k=k,
            ell=ell,
            tol=tol,
            atol=atol,
            maxiter=maxiter,
            select=select,
            waw_jitter=waw_jitter,
            refresh_aw=refresh_aw,
            strategy=strategy,
            M=make_preconditioner(A) if make_preconditioner is not None else None,
            recovery_rungs=recovery_rungs,
            recovery_shift=recovery_shift,
            stagnation_window=stagnation_window,
        )
        x_prev = x
        xs.append(x)
        infos.append(info)
        thetas.append(theta)
        rungs.append(rung)
    return SequenceResult(
        x=torch.stack(xs),
        info=_stack_infos(infos),
        theta=None if thetas[0] is None else torch.stack(thetas),
        W=w,
        AW=aw,
        drift=drift,
        rung=torch.stack(rungs),
    )


@dataclasses.dataclass
class RecycleManager:
    """Carries the recycled subspace across a sequence of SPD systems.

    Call :meth:`solve` once per system: def-CG(k, ell) with the current
    basis (plain CG + recording for the first system), then the
    strategy's transition extracts the next basis.  ``refresh_aw="exact"``
    recomputes ``A⁽ⁱ⁾W`` per system (one multi-RHS pass, k matvecs,
    charged); ``"stale"`` reuses the extraction's products.  A solve that
    ends broken or unconverged with a carried basis is re-solved clean,
    and the failed attempt's matvecs are charged, as in the reference.
    ``solve(..., M=...)`` preconditions both attempts.  ``use_jit``
    (the default, as in the reference) solves through
    :func:`~repro_torch.core.solvers.defcg_jit`: the first system of a
    shape captures the loop, every later one replays it.
    """

    k: int
    ell: int
    select: str = "largest"
    tol: float = 1e-5
    maxiter: int = 1000
    waw_jitter: float = DEFAULT_WAW_JITTER
    refresh_aw: str = "exact"
    strategy: RecycleStrategy = HarmonicRitz()
    use_jit: bool = True
    state: Optional[RecycleState] = None
    systems_solved: int = 0
    _has_aw: bool = False

    @property
    def W(self) -> Optional[torch.Tensor]:
        return None if self.state is None else self.state.W

    @property
    def AW(self) -> Optional[torch.Tensor]:
        if self.state is None or not self._has_aw:
            return None
        return self.state.AW

    @property
    def theta(self) -> Optional[torch.Tensor]:
        return None if self.state is None else self.state.theta

    def seed(self, W: torch.Tensor, AW: Optional[torch.Tensor] = None) -> None:
        """Seed the recycle space a priori with a flat ``(m, n)`` basis,
        ``1 <= m <= k`` (and optionally its A-products)."""
        m = W.shape[0]
        if W.ndim != 2 or not 1 <= m <= self.k:
            raise ValueError(
                f"seed basis has {m} vectors; RecycleManager(k={self.k}) "
                f"can carry between 1 and {self.k}"
            )
        if AW is not None and AW.shape != W.shape:
            raise ValueError(
                f"seed AW shape {tuple(AW.shape)} does not match W shape "
                f"{tuple(W.shape)}"
            )
        self.state = RecycleState(
            W=W,
            AW=torch.zeros_like(W) if AW is None else AW,
            theta=torch.zeros((m,), dtype=W.dtype, device=W.device),
            systems_solved=torch.tensor(
                self.systems_solved, dtype=torch.int32, device=W.device
            ),
            drift=torch.zeros((), dtype=W.dtype, device=W.device),
        )
        self._has_aw = AW is not None

    def solve(
        self,
        A,
        b: torch.Tensor,
        x0: Optional[torch.Tensor] = None,
        *,
        tol: Optional[float] = None,
        maxiter: Optional[int] = None,
        record_residuals: bool = False,
        M=None,
    ) -> CGResult:
        tol = self.tol if tol is None else tol
        maxiter = self.maxiter if maxiter is None else maxiter
        if self.strategy.needs_preconditioner and M is None:
            raise ValueError(
                f"strategy={type(self.strategy).__name__} extracts in the "
                "preconditioner's geometry — pass M to every solve()"
            )
        w_flat = self.W
        aw_flat = self.AW
        drift = self.state.drift if self.state is not None else 0.0
        needs_fresh = w_flat is not None and (
            aw_flat is None
            or self.strategy.manager_wants_refresh(self.refresh_aw, drift, tol)
        )
        if needs_fresh:
            aw_flat = ops_mod.apply_to_basis(A, w_flat)

        solve_fn = defcg_jit if self.use_jit else defcg
        exact_aw = needs_fresh or w_flat is None
        result = solve_fn(
            A,
            b,
            x0,
            W=w_flat,
            AW=aw_flat,
            ell=self.ell,
            tol=tol,
            maxiter=maxiter,
            record_residuals=record_residuals,
            waw_jitter=self.waw_jitter,
            exact_aw=exact_aw,
            M=M,
            stale_guard=(
                None if exact_aw else self.strategy.in_solve_guard(tol)
            ),
        )
        if result.recycle is not None and result.recycle.aw_used is not None:
            aw_flat = result.recycle.aw_used
        refresh_cost = w_flat.shape[0] if needs_fresh else 0

        if w_flat is not None and (
            bool(result.info.breakdown) or not bool(result.info.converged)
        ):
            # A stale or ill-conditioned basis can poison the recurrences:
            # drop it and re-solve clean, charging the failed attempt.
            failed_matvecs = result.info.matvecs
            self.state = None
            self._has_aw = False
            w_flat = aw_flat = None
            result = solve_fn(
                A, b, x0,
                ell=self.ell, tol=tol, maxiter=maxiter,
                record_residuals=record_residuals, M=M,
            )
            result = result._replace(
                info=result.info._replace(
                    matvecs=result.info.matvecs + failed_matvecs + refresh_cost
                )
            )
        elif refresh_cost:
            result = result._replace(
                info=result.info._replace(
                    matvecs=result.info.matvecs + refresh_cost
                )
            )
        self.systems_solved += 1
        self._refresh(result, w_flat, aw_flat, M=M)
        return result

    def _refresh(self, result: CGResult, w_flat, aw_flat, M=None) -> None:
        rec = result.recycle
        if rec is None or int(rec.stored) == 0:
            # Nothing recorded (x0 was already exact): keep the basis.
            return
        k = min(self.k, rec.P.shape[0] + (0 if w_flat is None else w_flat.shape[0]))
        W_new, AW_new, theta, drift = self.strategy.transition(
            w_flat, aw_flat, rec, k=k, select=self.select, m_apply=M
        )
        self.state = RecycleState(
            W=W_new,
            AW=AW_new,
            theta=theta,
            systems_solved=torch.tensor(
                self.systems_solved, dtype=torch.int32, device=W_new.device
            ),
            drift=drift,
        )
        self._has_aw = True


solve_sequence_jit = engine.compiled_door(
    solve_sequence, """:func:`solve_sequence` with every system's def-CG loop a
compiled program (:mod:`repro_torch.core.engine`): the systems of one
shape share its graphs, the setup, the ladder's reads and the extraction
run eagerly between them.  Same arguments and results, bit for bit.""")


def _recycled_solve(A, b, x0, W, *, k: int, ell: int, tol: float, maxiter: int,
                    select: str = "largest"):
    _, unravel = pt.ravel_vector(b)
    w_flat = pt.ravel_basis(W)
    flat_a = A if pt.is_flat(b) and b.ndim == 1 else pt.flat_operator(A, unravel)
    aw_flat = ops_mod.apply_to_basis(flat_a, w_flat)
    result = defcg(A, b, x0, W=W, AW=pt.unravel_basis(aw_flat, unravel), ell=ell, tol=tol,
                   maxiter=maxiter, flat_recycle=True)
    rec = result.recycle
    w_next, _, _, _ = extract_next_basis_core(w_flat, aw_flat, rec.P, rec.AP, rec.stored, k,
                                              select=select)
    result = result._replace(info=result.info._replace(
        matvecs=result.info.matvecs + w_flat.shape[0]))
    return pt.unravel_basis(w_next, unravel), result.x, result


recycled_solve_jit = engine.compiled_door(
    _recycled_solve, """Single-shot solve and extract for outer loops that carry ``W``
in their own state: one multi-RHS ``AW`` refresh (charged), a flat def-CG
solve as a compiled program, and the masked extraction of the next basis.
``b``/``x0``/``W`` may be pytrees (``W`` a basis with a leading axis).
Returns ``(W_next, x, result)``, as the reference's.""")
