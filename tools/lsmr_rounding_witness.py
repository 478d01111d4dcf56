#!/usr/bin/env python3
"""How far rounding alone moves LSMR's iteration counts, in both packages.

Cold LSMR (λ = 1e-4, tol 1e-8) on the eight drifting, ill-conditioned
systems of ``tests/test_lsmr.py`` (90 × 60, singular values
logspace(0, −3), κ(Â) ≈ 100), run by:

* the JAX reference (``repro.core.lsmr``), with its products as matrix
  products and again summed in another order (``Σ_j a_ij v_j``);
* the PyTorch port (``repro_torch.core.lsmr`` on the CPU), the same two ways;
* a plain numpy transcription of the same recurrence in f64, and in
  ``np.longdouble`` (80-bit extended on x86).

It prints each run's per-system iterations and their sum.  All f64 runs
solve the same problems to the same tolerance; only the rounding differs.
Past a dozen iterations the Krylov vectors lose orthogonality and the
counts part by a few per cent, in either package and between two
summation orders of one package; the extended-precision run shows how
much of the count is rounding at all.  Then, for the first system, the
gap between the two packages' recorded Krylov rows ``v_j`` (a 24-row
window, every fourth row printed), and the recycled sequence of the
reference test (deflsmr(8, 40)) in both packages.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/lsmr_rounding_witness.py

Takes about half a minute on a CPU.
"""

from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402

DAMP, TOL, MAXITER = 1e-4, 1e-8, 400


def drifting_systems(num=8, m=90, n=60, drift=0.02, seed=3):
    """``tests/test_lsmr.py:_ill_conditioned_sequence``, as numpy."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, m)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    base = U[:, :n] @ np.diag(np.logspace(0, -3, n)) @ V.T
    mats, bs = [], []
    for _ in range(num):
        mats.append(base)
        bs.append(rng.standard_normal(m))
        base = base + drift * np.linalg.norm(base) / np.sqrt(m * n) * rng.standard_normal((m, n))
    return mats, bs


def numpy_lsmr(A, b, damp, tol, maxiter):
    """The recurrence of ``repro.core.lsmr.lsmr`` (cold start, damped,
    no deflation) in numpy, in ``A``'s dtype.  Returns the iterations."""
    sd = np.sqrt(A.dtype.type(damp))
    beta = np.sqrt(b @ b)
    u, un = b / beta, np.zeros(A.shape[1], A.dtype)
    g = A.T @ u
    alpha = np.sqrt(g @ g)
    v = g / alpha
    zetabar, alphabar, rho, rhobar, cbar, sbar = alpha * beta, alpha, 1.0, 1.0, 1.0, 0.0
    threshold = tol * alpha * beta
    j = 0
    while j < maxiter and abs(zetabar) > threshold:
        um, un = A @ v - alpha * u, sd * v - alpha * un
        beta = np.sqrt(um @ um + un @ un)
        u, un = um / beta, un / beta
        w = A.T @ u + sd * un - beta * v
        alpha_new = np.sqrt(w @ w)
        v = w / alpha_new
        rho_new = np.sqrt(alphabar**2 + beta**2)
        c, s = alphabar / rho_new, beta / rho_new
        thetanew, alphabar = s * alpha_new, c * alpha_new
        rhobar_new = np.sqrt((cbar * rho_new) ** 2 + thetanew**2)
        cbar, sbar = cbar * rho_new / rhobar_new, thetanew / rhobar_new
        zetabar = -sbar * zetabar
        rho, rhobar, alpha = rho_new, rhobar_new, alpha_new
        j += 1
    return j


def main() -> None:
    mats, bs = drifting_systems()
    runs = {
        "reference, A @ v": [
            jc.lsmr(jc.DenseMatrixOperator(jnp.asarray(a)), jnp.asarray(b), damp=DAMP,
                    tol=TOL, maxiter=MAXITER).info.iterations
            for a, b in zip(mats, bs)
        ],
        "reference, summed by rows": [
            jc.lsmr(jc.LinearOperator(
                matvec=lambda v, a=jnp.asarray(a): jnp.sum(a * v[None, :], axis=1),
                rmatvec=lambda u, a=jnp.asarray(a): jnp.sum(a * u[:, None], axis=0)),
                jnp.asarray(b), damp=DAMP, tol=TOL, maxiter=MAXITER).info.iterations
            for a, b in zip(mats, bs)
        ],
        "port, A @ v": [
            tc.lsmr(tc.DenseMatrixOperator(torch.from_numpy(a)), torch.from_numpy(b),
                    damp=DAMP, tol=TOL, maxiter=MAXITER).info.iterations
            for a, b in zip(mats, bs)
        ],
        "port, summed by rows": [
            tc.lsmr(tc.LinearOperator(
                matvec=lambda v, a=torch.from_numpy(a): torch.sum(a * v[None, :], dim=1),
                rmatvec=lambda u, a=torch.from_numpy(a): torch.sum(a * u[:, None], dim=0)),
                torch.from_numpy(b), damp=DAMP, tol=TOL, maxiter=MAXITER).info.iterations
            for a, b in zip(mats, bs)
        ],
        "numpy f64": [numpy_lsmr(a, b, DAMP, TOL, MAXITER) for a, b in zip(mats, bs)],
        "numpy longdouble": [
            numpy_lsmr(a.astype(np.longdouble), b.astype(np.longdouble), DAMP, TOL, MAXITER)
            for a, b in zip(mats, bs)
        ],
    }
    for name, its in runs.items():
        its = [int(i) for i in its]
        print(f"{name:28s} {its} sum {sum(its)}")

    A, b = mats[0], bs[0]
    n = A.shape[1]
    W = np.zeros((8, n))
    kw = dict(damp=DAMP, ell=24, tol=TOL, maxiter=MAXITER)
    ref = jc.lsmr(jc.DenseMatrixOperator(jnp.asarray(A)), jnp.asarray(b), None,
                  jnp.asarray(W), jnp.asarray(W), flat_recycle=True, **kw)
    got = tc.lsmr(tc.DenseMatrixOperator(torch.from_numpy(A)), torch.from_numpy(b), None,
                  torch.from_numpy(W), torch.from_numpy(W), **kw)
    gap = np.abs(np.asarray(ref.recycle.P) - got.recycle.P.numpy()).max(axis=1)
    print("window row gap, reference vs port (rows 0, 4, …, 20): "
          + " ".join(f"{g:.1e}" for g in gap[::4]))

    kw = dict(k=8, ell=40, damp=DAMP, tol=TOL, maxiter=MAXITER, refresh_aw="exact")
    seqs = {
        "reference deflsmr(8, 40)": jc.solve_sequence_lsmr(
            jnp.asarray(np.stack(mats)), jnp.asarray(np.stack(bs)),
            make_operator=jc.DenseMatrixOperator, **kw).info.iterations,
        "port deflsmr(8, 40)": tc.solve_sequence_lsmr(
            torch.from_numpy(np.stack(mats)), torch.from_numpy(np.stack(bs)),
            make_operator=tc.DenseMatrixOperator, **kw).info.iterations,
    }
    for name, its in seqs.items():
        its = [int(i) for i in its]
        print(f"{name:28s} {its} sum {sum(its)}")


if __name__ == "__main__":
    main()
