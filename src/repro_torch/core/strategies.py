"""Recycle strategies: the end-of-solve transition, a pluggable axis.

The counterpart of ``repro.core.strategies``: a :class:`RecycleStrategy`
owns the pre-solve refresh policy and the transition ``(recorded window,
old state) → (next W, next AW, θ, drift)``, selected by
``SolveSpec.strategy``.

* :class:`HarmonicRitz` — harmonic-Ritz extraction over ``Z = [W, P]`` in
  the Euclidean geometry, refresh per ``spec.refresh_aw``.
* :class:`WindowedRecombine` — both ``W'`` and ``AW'`` recombined from the
  recorded window (zero refresh matvecs), the next solve on the stale
  products, guarded by the carried drift (the antisymmetry of the
  extraction gram ``F``, ``fasym``) before the solve and by def-CG's
  in-solve guard during its setup.
* :class:`MGeometryHarmonic` — the extraction in the preconditioner's
  geometry: ``G = (AZ)(M⁻¹AZ)ᵀ`` from one ``self_gram`` over the taller
  stack ``[Z; AZ; M⁻¹AZ]``, so θ approximate eigenvalues of ``M⁻¹A``.

The extraction reads the recorded window once through the ``self_gram``
kernel and rebuilds the next ``W`` and ``AW`` through the
``recombine_blocks`` kernel; everything between is ``(2m, 2m)`` algebra.
Under the sharded engine (``psum_axis``, a solve mesh) the n-reductions
are taken per rank and all-reduced (``HarmonicRitz`` only, as in the
reference).  A refresh decision is one host read a system; on a batch of
tenants (``(B, k, n)`` bases) it is one read for "any lane", and each lane
takes its own result by a ``where``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import engine
from repro_torch.core.solvers import DRIFT_NOISE_FLOOR_EPS, RecycleData
from repro_torch.kernels import ops as kops

FlatApply = Callable[[torch.Tensor], torch.Tensor]


def _drift_threshold(guard: float, tol: float, dtype: torch.dtype) -> float:
    """``guard × tol`` floored at the working dtype's drift-noise level
    (``DRIFT_NOISE_FLOOR_EPS`` × eps): the one comparison scale of every
    guard layer."""
    return max(guard * tol, DRIFT_NOISE_FLOOR_EPS * torch.finfo(dtype).eps)


def _has_basis(w: torch.Tensor) -> torch.Tensor:
    """Whether a basis holds any nonzero row: 0-d for one ``(k, n)``
    basis, ``(B,)`` for a batch of ``(B, k, n)``."""
    return torch.any(w != 0) if w.ndim == 2 else torch.any((w != 0).flatten(1), dim=1)


def _gated_basis_apply(apply_basis, pred, w, fallback, k: int):
    """``(apply_basis(w) where pred else fallback, matvecs charged)``.

    One host read decides whether the operator runs at all: for one
    system ``pred`` itself (charge ``k`` or 0, a Python int); for a batch
    whether ANY lane's ``pred`` holds, and then each lane takes its own
    result by a ``where`` (charge ``k`` on the lanes that wanted it, an
    int32 ``(B,)`` tensor) — no lane pays the operator unless some lane
    needs it."""
    if pred.ndim == 0:
        return (apply_basis(w), k) if bool(pred) else (fallback, 0)
    charge = k * pred.to(torch.int32)
    if not bool(torch.any(pred)):
        return fallback, charge
    return torch.where(pred[:, None, None], apply_basis(w), fallback), charge


def _eigh(mat: torch.Tensor):
    """``torch.linalg.eigh``, NaN where it fails.  A window poisoned by a
    broken solve makes the extraction's grams non-finite; the reference's
    eigh returns NaN there, torch's raises, and the poisoned basis must
    reach the terminal retirement.  The healthy path runs eigh alone."""
    try:
        return torch.linalg.eigh(mat)
    except torch.linalg.LinAlgError:
        nan = torch.full_like(mat, float("nan"))
        return nan[0], nan


def _select_positive_ritz(zeta, Wm, k: int, select: str):
    """Pick ``k`` Ritz pairs by θ = 1/ζ, clamped to the positive count.

    Trailing slots past the positive count are exact zeros (θ = 0, zero
    eigenvector column).  The sort is stable, as ``jnp.argsort`` is: the
    keys hold ``±inf`` ties.  Returns ``(w_sel, theta, slot_ok)``.
    """
    npos = torch.sum(zeta > 0)
    slot_ok = torch.arange(k, device=zeta.device) < torch.clamp(npos, max=k)
    if select == "largest":
        order = torch.argsort(
            torch.where(zeta > 0, zeta, float("inf")), stable=True
        )[:k]
    elif select == "smallest":
        order = torch.argsort(
            torch.where(zeta > 0, zeta, float("-inf")), stable=True
        ).flip(0)[:k]
    else:
        raise ValueError(f"unknown select={select!r}")
    w_sel = Wm[:, order] * slot_ok[None, :].to(Wm.dtype)
    zeta_sel = torch.where(slot_ok, zeta[order], 1.0)
    theta = torch.where(slot_ok, 1.0 / zeta_sel, 0.0)
    return w_sel, theta, slot_ok


def harmonic_ritz_flat_core(
    Z: Union[torch.Tensor, Sequence[torch.Tensor]],
    AZ: Union[torch.Tensor, Sequence[torch.Tensor]],
    k: int,
    *,
    valid: Optional[torch.Tensor] = None,
    select: str = "largest",
    jitter: float = 1e-10,
    m_apply: Optional[FlatApply] = None,
    psum_axis=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked flat harmonic-Ritz extraction over ``(m, n)`` row bases.

    One ``self_gram`` over ``S = [Z; AZ]`` gives every gram the extraction
    needs (column norms, ``F = (AZ)Zᵀ``, ``G = (AZ)(AZ)ᵀ``); one
    ``recombine_blocks`` over the same ``S`` gives ``[W'; AW']``.
    Returns ``(W, AW, theta, fasym)`` of shapes ``(k, n), (k, n), (k,), ()``
    where ``fasym`` is the relative asymmetry of the equilibrated ``F``
    (with a stale ``AW`` block, a free proxy of ``‖AW − A·W‖``: the
    :class:`WindowedRecombine` drift).

    ``m_apply`` (a flat ``r ↦ M⁻¹r``) is the M-geometry of
    :class:`MGeometryHarmonic`: the ``self_gram`` runs over the taller
    stack ``[Z; AZ; M⁻¹AZ]`` (3m ≤ 128 rows) and ``G`` is its symmetrized
    ``(AZ, M⁻¹AZ)`` block.

    ``psum_axis`` is the solve mesh (:class:`repro_torch.launch.SolveMesh`)
    the n columns are split over: the stacked gram and the row norms of
    the new ``W`` — the only n-reductions here — are taken per rank and
    all-reduced; the ``(2m, 2m)`` eigenproblems run replicated and the
    recombination stays per rank (n is then this rank's columns).
    ``None`` is the unsharded path, unchanged.

    ``Z`` and ``AZ`` may each be given as row blocks (``[W, P]``): the
    stack ``S`` is then the one copy of the window made here (masked in
    place), and ``Z`` / ``AZ`` are its halves — at LM scale every row is a
    parameter-sized vector.
    """
    blocks = [*(Z if isinstance(Z, (tuple, list)) else [Z]),
              *(AZ if isinstance(AZ, (tuple, list)) else [AZ])]
    S2 = torch.cat(blocks, dim=0)  # (2m, n): gram + recombination
    m = S2.shape[0] // 2
    if k > m:
        raise ValueError(f"cannot extract k={k} Ritz vectors from m={m} basis")
    if valid is not None:
        S2.mul_(torch.cat([valid, valid]).to(S2.dtype)[:, None])
    Z, AZ = S2[:m], S2[m:]
    if m_apply is None:
        full = kops.self_gram(S2)
        if psum_axis is not None:
            (full,) = engine.psum_merged([full], psum_axis)
        zz = torch.diagonal(full[:m, :m])
        F_raw = full[m:, :m]
        G = full[m:, m:]
    else:
        # One taller stack: the same single self-gram also holds
        # G = (AZ)(M⁻¹AZ)ᵀ (M⁻¹ symmetric: symmetric to rounding).
        MAZ = torch.stack([m_apply(row) for row in AZ])
        full = kops.self_gram(torch.cat([S2, MAZ.to(S2.dtype)], dim=0))
        if psum_axis is not None:
            (full,) = engine.psum_merged([full], psum_axis)
        zz = torch.diagonal(full[:m, :m])
        F_raw = full[m:2 * m, :m]
        G = full[m:2 * m, 2 * m:]
        G = 0.5 * (G + G.T)

    dz = torch.where(zz > 0, torch.rsqrt(zz), 0.0)
    G = G * dz[:, None] * dz[None, :]
    F = F_raw * dz[:, None] * dz[None, :]

    fnorm = torch.sqrt(torch.sum(F * F))
    fasym = torch.sqrt(torch.sum((F - F.T) ** 2)) / torch.clamp(
        fnorm, min=torch.finfo(F.dtype).tiny
    )
    fasym = torch.where(fnorm > 0, fasym, 0.0)
    F = 0.5 * (F + F.T)

    # Second-stage equilibration on ‖AZ_i‖.
    dg = torch.diagonal(G)
    d = torch.where(dg > 0, dg, 1.0) ** -0.5
    G = G * d[:, None] * d[None, :]
    F = F * d[:, None] * d[None, :]

    # Rank-revealing reduction: project out G's near-null directions.
    lam, qg = _eigh(G)
    eps = torch.finfo(G.dtype).eps
    rcond = max(jitter, 100.0 * eps) * m
    good = lam > rcond * lam[-1]
    s = torch.where(good, 1.0 / torch.sqrt(torch.clamp(lam, min=1e-300)), 0.0)
    M = s[:, None] * (qg.T @ F @ qg) * s[None, :]
    M = 0.5 * (M + M.T)
    zeta, Wm = _eigh(M)

    w_sel, theta, slot_ok = _select_positive_ritz(zeta, Wm, k, select)

    # u folds the reduction and both equilibrations: u = D_z · D · Qg S w.
    u = qg @ (s[:, None] * w_sel)
    u = u * (d * dz)[:, None]
    u = u.to(Z.dtype)

    WA = kops.recombine_blocks(S2, u)  # (2k, n)
    W, AW = WA[:k], WA[k:]

    wsq = torch.sum(W * W, dim=1)
    if psum_axis is not None:
        (wsq,) = engine.psum_merged([wsq], psum_axis)
    wn = torch.sqrt(torch.clamp(wsq, min=torch.finfo(u.dtype).tiny))
    col_scale = torch.where(slot_ok, 1.0 / wn, 0.0).to(W.dtype)
    return W * col_scale[:, None], AW * col_scale[:, None], theta, fasym


def extract_next_basis_core(
    w_flat: Optional[torch.Tensor],
    aw_flat: Optional[torch.Tensor],
    p_flat: torch.Tensor,
    ap_flat: torch.Tensor,
    stored,
    k: int,
    *,
    select: str = "largest",
    jitter: float = 1e-10,
    m_apply: Optional[FlatApply] = None,
    psum_axis=None,
):
    """One cross-system extraction over ``Z = [W, P]`` with a device-side
    validity mask: W rows where nonzero, P rows below ``stored``.
    ``m_apply`` extracts in the M-geometry; ``psum_axis`` (see
    :func:`harmonic_ritz_flat_core`) all-reduces the W rows' norms with
    the gram's reductions."""
    ell = p_flat.shape[0]
    p_valid = torch.arange(ell, device=p_flat.device) < stored
    if w_flat is None:
        Z, AZ, valid = p_flat, ap_flat, p_valid
    else:
        Z, AZ = (w_flat, p_flat), (aw_flat, ap_flat)
        wsq = torch.sum(w_flat * w_flat, dim=1)
        if psum_axis is not None:
            (wsq,) = engine.psum_merged([wsq], psum_axis)
        valid = torch.cat([wsq > 0, p_valid])
    return harmonic_ritz_flat_core(
        Z, AZ, k, valid=valid, select=select, jitter=jitter, m_apply=m_apply,
        psum_axis=psum_axis,
    )


@dataclasses.dataclass(frozen=True)
class RecycleStrategy:
    """Owner of the per-system refresh policy and end-of-solve transition.

    * :meth:`prepare` — before the solve: ``(aw_used, refresh_matvecs,
      exact_aw, stale_guard)``; ``exact_aw`` (a Python bool) picks def-CG's
      setup path, ``stale_guard`` (a float or None) arms its in-solve
      drift guard.  On a batch (``(B, k, n)`` bases) ``refresh_matvecs``
      is an int32 ``(B,)`` tensor.
    * :meth:`transition` — after the solve: ``(W', AW', theta, drift)``
      from the recorded window; ``m_apply`` is the flat ``M⁻¹`` apply of a
      preconditioned solve (only the M-geometry reads it).
    * :meth:`manager_wants_refresh` — the host-side mirror of
      :meth:`prepare` for :class:`repro_torch.core.recycle.RecycleManager`.
    """

    def prepare(self, apply_basis: FlatApply, w, aw_carry, drift, *, k: int,
                refresh_aw: str, tol: float = 1e-5):
        raise NotImplementedError

    def transition(self, w, aw, window: RecycleData, *, k: int,
                   select: str = "largest", jitter: float = 1e-10,
                   m_apply: Optional[FlatApply] = None):
        raise NotImplementedError

    def manager_wants_refresh(self, refresh_aw: str, drift, tol: float) -> bool:
        raise NotImplementedError

    def in_solve_guard(self, tol: float):
        """Static ``defcg(stale_guard=…)`` threshold, or None."""
        del tol
        return None

    @property
    def needs_preconditioner(self) -> bool:
        """Whether the transition is meaningless without an ``M`` apply."""
        return False


def _zero_drift(ref: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=ref.dtype, device=ref.device)


@dataclasses.dataclass(frozen=True)
class HarmonicRitz(RecycleStrategy):
    """Euclidean harmonic-Ritz extraction over ``[W, P]``.

    Refresh per ``spec.refresh_aw``: ``"exact"`` recomputes ``AW`` with one
    multi-RHS pass (k matvecs, charged; skipped and uncharged on a cold
    all-zero basis — one host read decides), ``"stale"`` reuses the
    recombined products.
    """

    def prepare(self, apply_basis, w, aw_carry, drift, *, k, refresh_aw,
                tol=1e-5):
        del drift, tol
        if refresh_aw == "stale":
            return aw_carry, 0, False, None
        aw, charge = _gated_basis_apply(apply_basis, _has_basis(w), w, torch.zeros_like(w), k)
        return aw, charge, True, None

    def transition(self, w, aw, window, *, k, select="largest", jitter=1e-10,
                   m_apply=None):
        del m_apply  # Euclidean geometry
        W, AW, theta, _ = extract_next_basis_core(
            w, aw, window.P, window.AP, window.stored, k,
            select=select, jitter=jitter,
        )
        return W, AW, theta, _zero_drift(W)

    def manager_wants_refresh(self, refresh_aw, drift, tol):
        del drift, tol
        return refresh_aw == "exact"


@dataclasses.dataclass(frozen=True)
class WindowedRecombine(RecycleStrategy):
    """Zero-matvec windowed refresh with a drift guard.

    Both ``W'`` and ``AW'`` come from recombining the recorded window (one
    ``recombine_blocks``), the next solve deflates with the stale
    products and re-derives ``r₀`` with one true matvec: ``iterations + 2``
    matvecs a system, no k-matvec refresh.  Two guard layers, neither
    spending a speculative matvec:

    1. *pre-solve* — when the CARRIED drift (the gram asymmetry ``fasym``
       the previous transition measured) exceeds ``guard × tol``,
       :meth:`prepare` refreshes up front (k matvecs);
    2. *in-solve* — def-CG's ``stale_guard``: ``‖(A·W − AW)c‖``, measured
       by the stale setup on THIS system, refreshes and redoes the
       deflated guess before the first iteration.

    Both thresholds are floored at ~500·eps of the working dtype, so an
    unchanged operator (stale products exact to rounding) never buys a
    refresh.  ``guard = inf`` never refreshes; ``guard = 0`` refreshes on
    any drift above that floor.
    """

    guard: float = 0.1

    def in_solve_guard(self, tol: float) -> float:
        """The threshold armed as ``defcg(stale_guard=…)`` (def-CG floors
        it at the dtype's noise level)."""
        return self.guard * tol

    def prepare(self, apply_basis, w, aw_carry, drift, *, k, refresh_aw,
                tol=1e-5):
        del refresh_aw  # the guard is the policy, not the spec flag
        threshold = _drift_threshold(self.guard, tol, w.dtype)
        refresh = _has_basis(w) & (torch.as_tensor(drift, device=w.device) > threshold)
        aw, charge = _gated_basis_apply(apply_basis, refresh, w, aw_carry, k)
        # exact_aw=False even when the guard just refreshed: the stale
        # setup's true-matvec r₀ is the one path for every system.
        return aw, charge, False, self.in_solve_guard(tol)

    def transition(self, w, aw, window, *, k, select="largest", jitter=1e-10,
                   m_apply=None):
        del m_apply
        W, AW, theta, fasym = extract_next_basis_core(
            w, aw, window.P, window.AP, window.stored, k,
            select=select, jitter=jitter,
        )
        return W, AW, theta, fasym.to(W.dtype)

    def manager_wants_refresh(self, refresh_aw, drift, tol):
        del refresh_aw
        d = torch.as_tensor(drift)
        dtype = d.dtype if d.dtype.is_floating_point else torch.float32
        return bool(d > _drift_threshold(self.guard, tol, dtype))


@dataclasses.dataclass(frozen=True)
class MGeometryHarmonic(RecycleStrategy):
    """Harmonic extraction in the preconditioner's geometry.

    The exact refresh of :class:`HarmonicRitz` (whatever ``refresh_aw``
    says), but the transition passes the ``M⁻¹`` apply into the grams, so
    θ approximate eigenvalues of the effective operator ``M⁻¹A`` and
    ``select`` targets what the preconditioner leaves behind.  Needs a
    preconditioned spec (``SolveSpec`` checks it); with no ``M`` at the
    transition it is the Euclidean extraction.
    """

    def prepare(self, apply_basis, w, aw_carry, drift, *, k, refresh_aw,
                tol=1e-5):
        del aw_carry, drift, refresh_aw, tol
        aw, charge = _gated_basis_apply(apply_basis, _has_basis(w), w, torch.zeros_like(w), k)
        return aw, charge, True, None

    def transition(self, w, aw, window, *, k, select="largest", jitter=1e-10,
                   m_apply=None):
        W, AW, theta, _ = extract_next_basis_core(
            w, aw, window.P, window.AP, window.stored, k,
            select=select, jitter=jitter, m_apply=m_apply,
        )
        return W, AW, theta, _zero_drift(W)

    def manager_wants_refresh(self, refresh_aw, drift, tol):
        del refresh_aw, drift, tol
        return True

    @property
    def needs_preconditioner(self) -> bool:
        return True
