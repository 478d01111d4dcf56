"""Recycle strategies: the end-of-solve transition (harmonic Ritz).

The counterpart of ``repro.core.strategies`` for the incumbent strategy,
:class:`HarmonicRitz`: harmonic-Ritz extraction over ``Z = [W, P]`` in
the Euclidean geometry, with the refresh policy of ``spec.refresh_aw``.
The extraction reads the recorded window once through the ``self_gram``
kernel and rebuilds the next ``W`` and ``AW`` through the
``recombine_blocks`` kernel; everything between is ``(2m, 2m)`` algebra.
Under the sharded engine (``psum_axis``, a solve mesh) the n-reductions
are taken per rank and all-reduced, and the rest stays as it is.
``WindowedRecombine`` and ``MGeometryHarmonic`` come with ROADMAP queue 1
item 9; until then :class:`MGeometryHarmonic` exists so that a spec can
name it, and :func:`repro_torch.core.solve` refuses it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import engine
from repro_torch.core.solvers import RecycleData
from repro_torch.kernels import ops as kops

FlatApply = Callable[[torch.Tensor], torch.Tensor]


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
    Z: torch.Tensor,
    AZ: torch.Tensor,
    k: int,
    *,
    valid: Optional[torch.Tensor] = None,
    select: str = "largest",
    jitter: float = 1e-10,
    psum_axis=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked flat harmonic-Ritz extraction over ``(m, n)`` row bases.

    One ``self_gram`` over ``S = [Z; AZ]`` gives every gram the extraction
    needs (column norms, ``F = (AZ)Zᵀ``, ``G = (AZ)(AZ)ᵀ``); one
    ``recombine_blocks`` over the same ``S`` gives ``[W'; AW']``.
    Returns ``(W, AW, theta, fasym)`` of shapes ``(k, n), (k, n), (k,), ()``
    where ``fasym`` is the relative asymmetry of the equilibrated ``F``.

    ``psum_axis`` is the solve mesh (:class:`repro_torch.launch.SolveMesh`)
    the n columns are split over: the stacked gram and the row norms of
    the new ``W`` — the only n-reductions here — are taken per rank and
    all-reduced; the ``(2m, 2m)`` eigenproblems run replicated and the
    recombination stays per rank (n is then this rank's columns).
    ``None`` is the unsharded path, unchanged.
    """
    m = Z.shape[0]
    if k > m:
        raise ValueError(f"cannot extract k={k} Ritz vectors from m={m} basis")
    if valid is not None:
        vz = valid.to(Z.dtype)[:, None]
        Z = Z * vz
        AZ = AZ * vz

    S2 = torch.cat([Z, AZ], dim=0)  # (2m, n): gram + recombination
    full = kops.self_gram(S2)
    if psum_axis is not None:
        (full,) = engine.psum_merged([full], psum_axis)
    zz = torch.diagonal(full[:m, :m])
    F_raw = full[m:, :m]
    G = full[m:, m:]

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
    lam, qg = torch.linalg.eigh(G)
    eps = torch.finfo(G.dtype).eps
    rcond = max(jitter, 100.0 * eps) * m
    good = lam > rcond * lam[-1]
    s = torch.where(good, 1.0 / torch.sqrt(torch.clamp(lam, min=1e-300)), 0.0)
    M = s[:, None] * (qg.T @ F @ qg) * s[None, :]
    M = 0.5 * (M + M.T)
    zeta, Wm = torch.linalg.eigh(M)

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
    psum_axis=None,
):
    """One cross-system extraction over ``Z = [W, P]`` with a device-side
    validity mask: W rows where nonzero, P rows below ``stored``.
    ``psum_axis`` (see :func:`harmonic_ritz_flat_core`) all-reduces the W
    rows' norms with the gram's reductions."""
    ell = p_flat.shape[0]
    p_valid = torch.arange(ell, device=p_flat.device) < stored
    if w_flat is None:
        Z, AZ, valid = p_flat, ap_flat, p_valid
    else:
        Z = torch.cat([w_flat, p_flat], dim=0)
        AZ = torch.cat([aw_flat, ap_flat], dim=0)
        wsq = torch.sum(w_flat * w_flat, dim=1)
        if psum_axis is not None:
            (wsq,) = engine.psum_merged([wsq], psum_axis)
        valid = torch.cat([wsq > 0, p_valid])
    return harmonic_ritz_flat_core(
        Z, AZ, k, valid=valid, select=select, jitter=jitter, psum_axis=psum_axis
    )


@dataclasses.dataclass(frozen=True)
class RecycleStrategy:
    """Owner of the per-system refresh policy and end-of-solve transition.

    * :meth:`prepare` — before the solve: ``(aw_used, refresh_matvecs,
      exact_aw, stale_guard)``.
    * :meth:`transition` — after the solve: ``(W', AW', theta, drift)``
      from the recorded window.
    * :meth:`manager_wants_refresh` — the host-side mirror of
      :meth:`prepare` for :class:`repro_torch.core.recycle.RecycleManager`.
    """

    def prepare(self, apply_basis: FlatApply, w, aw_carry, drift, *, k: int,
                refresh_aw: str, tol: float = 1e-5):
        raise NotImplementedError

    def transition(self, w, aw, window: RecycleData, *, k: int,
                   select: str = "largest", jitter: float = 1e-10):
        raise NotImplementedError

    def manager_wants_refresh(self, refresh_aw: str, drift, tol: float) -> bool:
        raise NotImplementedError

    def in_solve_guard(self, tol: float):
        """Static ``defcg(stale_guard=…)`` threshold, or None."""
        del tol
        return None

    @property
    def needs_preconditioner(self) -> bool:
        return False


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
        if bool(torch.any(w != 0)):
            return apply_basis(w), k, True, None
        return torch.zeros_like(w), 0, True, None

    def transition(self, w, aw, window, *, k, select="largest", jitter=1e-10):
        W, AW, theta, _ = extract_next_basis_core(
            w, aw, window.P, window.AP, window.stored, k,
            select=select, jitter=jitter,
        )
        return W, AW, theta, torch.zeros((), dtype=W.dtype, device=W.device)

    def manager_wants_refresh(self, refresh_aw, drift, tol):
        del drift, tol
        return refresh_aw == "exact"


@dataclasses.dataclass(frozen=True)
class MGeometryHarmonic(RecycleStrategy):
    """Harmonic extraction in the preconditioner's geometry — not ported
    yet (ROADMAP queue 1 item 9): the front door refuses it."""
