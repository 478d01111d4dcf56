"""Per-rank cases of ``tests/test_torch_sharded.py`` and ``test_torch_cuda.py``.

Spawned ranks import this module, not the test files: it imports torch
and ``repro_torch`` only, so the JAX reference runs in the pytest process
alone.  Every function here runs on every rank of a group started by
:func:`repro_torch.launch.run_ranks` and returns numpy data (rank 0's is
what the test sees).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.core import (
    DenseMatrixOperator,
    RBFKernelSystemOperator,
    RecycleState,
    SolveSpec,
    solve,
)
from repro_torch.configs import gpc_mnist
from repro_torch.launch import COLLECTIVES, gpc_dryrun, make_solve_mesh

F64 = torch.float64
CONTRACT_ITERS = 8  # the contract runs N and N + 8 iterations at tol 0


def _np(t):
    return t.detach().cpu().numpy()


def _every_rank(value):
    """``value`` from every rank of the world, in rank order (uncounted)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _summary(res, every_rank=True):
    """The result as numpy; with ``every_rank`` (a world collective: every
    rank must call it) each rank's iteration count too."""
    info = res.info
    out = {
        "x": _np(res.x),
        "iterations": int(info.iterations),
        "matvecs": int(info.matvecs),
        "converged": bool(info.converged),
        "status": int(info.status),
    }
    out["rank_iterations"] = (
        _every_rank(out["iterations"]) if every_rank else [out["iterations"]]
    )
    return out


def _raised(fn):
    try:
        fn()
    except (ValueError, TypeError, NotImplementedError) as exc:
        return type(exc).__name__, str(exc)
    return None


def _counted(fn):
    """What ``fn`` returns, and the collectives it issued by kind."""
    before = dict(COLLECTIVES)
    out = fn()
    return out, {kind: COLLECTIVES[kind] - before[kind] for kind in before}


def mesh_cases(device):
    """Group construction, the out-of-range counts, membership and the
    layout helpers."""
    world = dist.get_world_size()
    mesh = make_solve_mesh(device=device)
    out = {
        "size": mesh.size, "rank": mesh.rank, "device": str(mesh.device),
        "backend": mesh.backend,
        "explicit": [make_solve_mesh(n, device=device).size for n in range(1, world + 1)],
        "out_of_range": [_raised(lambda n=n: make_solve_mesh(n, device=device))
                         for n in (world + 1, 0)],
    }
    one = make_solve_mesh(1, device=device)
    out["members"] = _every_rank(one.member)
    A = DenseMatrixOperator(torch.eye(8 * world, dtype=F64, device=device))
    b = torch.ones(8 * world, dtype=F64, device=device)
    out["non_member"] = _every_rank(
        _raised(lambda: solve(A, b, SolveSpec(method="cg"), mesh=one))
    )

    gen = torch.Generator().manual_seed(3)
    v = torch.randn(8 * world, generator=gen, dtype=F64).to(device)
    full = RecycleState(
        W=torch.randn(4, 8 * world, generator=gen, dtype=F64).to(device),
        AW=torch.randn(4, 8 * world, generator=gen, dtype=F64).to(device),
        theta=torch.arange(4, dtype=F64, device=device),
        systems_solved=torch.tensor(2, dtype=torch.int32, device=device),
        drift=torch.tensor(0.5, dtype=F64, device=device),
    )
    local = mesh.shard_state(full)
    back = mesh.gather_state(local)
    arrays = convert.recycle_state_to_numpy(full)
    via_convert = convert.recycle_state_shard_from_numpy(
        **arrays, rank=mesh.rank, world_size=world, dtype=F64, device=device
    )
    out["helpers"] = {
        "vector_roundtrip": float((mesh.gather(mesh.shard(v)) - v).abs().max()),
        "local_shape": tuple(local.W.shape),
        "state_roundtrip": max(float((back.W - full.W).abs().max()),
                               float((back.AW - full.AW).abs().max())),
        "convert_matches": bool(torch.equal(via_convert.W, local.W)
                                and torch.equal(via_convert.AW, local.AW)),
    }
    return out


def dense_cases(a_np, b_np, b2_np, device):
    """The dense n = 64 system of ``tests/test_sharded_engine.py``, sharded."""
    mesh = make_solve_mesh(device=device)
    A = DenseMatrixOperator(torch.tensor(a_np, device=device))
    b = torch.tensor(b_np, device=device)
    b2 = torch.tensor(b2_np, device=device)
    n = b.shape[0]
    cold = RecycleState.zeros(4, n, dtype=F64, device=device)
    out = {"parity": {}}
    for method in ("cg", "defcg", "lsmr"):
        spec = SolveSpec(method=method, k=4, ell=6, tol=1e-12, maxiter=300)
        out["parity"][method] = _summary(solve(A, b, spec, cold, mesh=mesh))

    spec = SolveSpec(method="defcg", k=4, ell=6, tol=1e-10, maxiter=200)
    st = mesh.gather_state(solve(A, b, spec, cold, mesh=mesh).state)
    out["state"] = {"W": _np(st.W), "AW": _np(st.AW), "theta": _np(st.theta),
                    "systems_solved": int(st.systems_solved)}

    # The recycling win, and a state carried to another group size.
    spec = SolveSpec(method="defcg", k=4, ell=8, tol=1e-8, maxiter=200)
    got1 = solve(A, b, spec, cold, mesh=mesh)
    got2 = solve(A, b2, spec, got1.state, mesh=mesh)
    out["recycle"] = {"first": _summary(got1), "second": _summary(got2)}
    whole = mesh.gather_state(got1.state)
    one = make_solve_mesh(1, device=device)
    if one.member:
        out["reshard"] = {
            "size_1": _summary(solve(A, b2, spec, whole, mesh=one), every_rank=False),
            "unsharded": _np(solve(A, b2, spec, whole).x),
        }

    for key, tol in (("damped", 1e-10), ("damped_tight", 1e-12)):
        spec = SolveSpec(method="lsmr", tol=tol, maxiter=300, lsq_shift=1e-2)
        out[key] = _summary(solve(A, b, spec, mesh=mesh))

    spec = SolveSpec(method="defcg", k=4, ell=6, tol=1e-8, maxiter=200)
    res = solve(A, b, spec, cold, x0=b2, record_residuals=True, mesh=mesh)
    out["x0_trace"] = dict(_summary(res), trace=_np(res.info.residual_norms))

    # The stall detector (eager in the sharded loops): the first step's
    # residual grows on this system, so window 1 stops there.
    out["stagnation"] = {}
    for method in ("cg", "defcg"):
        spec = SolveSpec(method=method, k=4, ell=6, tol=1e-12, maxiter=300,
                         stagnation_window=1)
        out["stagnation"][method] = _summary(solve(A, b, spec, cold, mesh=mesh))

    # The collective contract, by difference: N and N + 8 live iterations.
    contract = {}
    for method in ("cg", "defcg", "lsmr"):
        counts = []
        for maxiter in (CONTRACT_ITERS, 2 * CONTRACT_ITERS):
            spec = SolveSpec(method=method, k=4, ell=6, tol=0.0, maxiter=maxiter)
            res, count = _counted(lambda: solve(A, b, spec, cold, mesh=mesh))
            counts.append((int(res.info.iterations), count))
        contract[method] = counts
    out["contract"] = contract

    # The front door's refusals (all raise before any collective).
    odd = DenseMatrixOperator(torch.eye(62, dtype=F64, device=device))
    out["errors"] = {
        "deflsmr": _raised(lambda: solve(A, b, SolveSpec(method="deflsmr"), mesh=mesh)),
        "M": _raised(lambda: solve(A, b, SolveSpec(method="cg"), M=lambda r: r, mesh=mesh)),
        "precond": _raised(lambda: solve(
            A, b, SolveSpec(method="defcg", precond="jacobi"), mesh=mesh)),
        "indivisible": _raised(lambda: solve(
            odd, torch.ones(62, dtype=F64, device=device), SolveSpec(method="cg"), mesh=mesh)),
        "not_a_mesh": _raised(lambda: solve(A, b, SolveSpec(method="cg"), mesh=dist.group.WORLD)),
        "operator": _raised(lambda: solve(
            lambda v: v, b, SolveSpec(method="cg"), mesh=mesh)),
        "state_shape": _raised(lambda: solve(
            A, b, SolveSpec(method="defcg", k=4), RecycleState.zeros(
                4, 10, dtype=F64, device=device), mesh=mesh)),
    }
    return out


def rbf_case(x_np, sqrt_h_np, b_np, device):
    """The RBF operator at n = 256 (``test_rbf_operator_sharded_parity``),
    each product through ``rbf_matvec_rect``; the counts of K8 launches
    and of plain versions run on the card, per rank."""
    from repro_torch.kernels import _runtime

    mesh = make_solve_mesh(device=device)
    A = RBFKernelSystemOperator(
        torch.tensor(x_np, device=device), torch.tensor(sqrt_h_np, device=device),
        theta=1.3, lengthscale=1.1, block=64,
    )
    b = torch.tensor(b_np, device=device)
    spec = SolveSpec(method="defcg", k=4, ell=6, tol=1e-9, maxiter=400)
    for key in _runtime.LAUNCHES:
        _runtime.LAUNCHES[key] = _runtime.PLAIN_ON_CUDA[key] = 0
    res = solve(A, b, spec, RecycleState.zeros(4, b.shape[0], dtype=F64, device=device),
                mesh=mesh)
    out = _summary(res)
    out["launches"] = _every_rank(dict(_runtime.LAUNCHES))
    out["plain_on_cuda"] = _every_rank(dict(_runtime.PLAIN_ON_CUDA))
    out["unsharded_x"] = _np(solve(A, b, spec).x)
    return out


def all_cases(dense_args, rbf_args, device="cpu"):
    return {
        "mesh": mesh_cases(device),
        "dense": dense_cases(*dense_args, device=device),
        "rbf": rbf_case(*rbf_args, device=device),
    }


def damped_lsmr_case(a_np, b_np, tols):
    """Damped LSMR (λ = 1e-2) sharded and unsharded at each tol: the
    witness behind ROADMAP P6, printed by ``tests/test_torch_sharded.py``
    when run as a script."""
    mesh = make_solve_mesh(device="cpu")
    A, b = DenseMatrixOperator(torch.tensor(a_np)), torch.tensor(b_np)
    out = {}
    for tol in tols:
        spec = SolveSpec(method="lsmr", tol=tol, maxiter=300, lsq_shift=1e-2)
        got, alone = solve(A, b, spec, mesh=mesh), solve(A, b, spec)
        out[tol] = {"sharded": (_np(got.x), int(got.info.iterations)),
                    "unsharded": (_np(alone.x), int(alone.info.iterations))}
    return out



def gpc_iteration_case(x_np, sqrt_h_np, state_np):
    """One GPC def-CG iteration (``launch.gpc_dryrun``) with this rank's
    block of rows against the whole X: the outputs gathered (vectors, W,
    AW) and the collectives the iteration issued."""
    mesh = make_solve_mesh(device="cpu")
    n = x_np.shape[0]
    cfg = dataclasses.replace(gpc_mnist.SMOKE, n=n)
    blk = mesh.block(n)
    xv, r, p, rs, w, aw, waw_inv = (torch.as_tensor(a) for a in state_np)
    state = (xv[blk], r[blk], p[blk], rs, w[:, blk].contiguous(), aw[:, blk].contiguous(),
             waw_inv)
    before = dict(COLLECTIVES)
    out = gpc_dryrun.make_defcg_iteration(cfg, mesh)(torch.as_tensor(x_np),
                                                     torch.as_tensor(sqrt_h_np)[blk], state)
    issued = {k: COLLECTIVES[k] - before[k] for k in COLLECTIVES}
    sharded = (0, 1, 2, 4, 5)  # x, r, p, W, AW: blocks of rows (columns of W, AW)
    return [_np(mesh.gather(o) if i in sharded else o) for i, o in enumerate(out)], issued
