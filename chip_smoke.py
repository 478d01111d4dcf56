#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU, end to end.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the script when it fails:

1. device   — needs ``torch.cuda.is_available()``; prints the card's name
              and power limit (``nvidia-smi``) and compute capability.
2. build    — builds the port's CUDA sources (``src/repro_torch/csrc``) with
              ``nvcc``, one process per source, all started together.
3. kernels  — holds every kernel of the main paths against its plain PyTorch
              version on the card, in f64 (1e-12 relative) and f32 (2e-4;
              the RBF Gram matvec 2e-4 relative / 5e-4 absolute), at the
              main paths' shapes (n = 36 551 and the cut n = 16 384 of the
              preconditioned sequences) and at a ragged small n; times each (CUDA
              events, median of 25 launches, 3 for the RBF Gram matvec, L2
              flushed before each) beside its plain version, the one
              PyTorch call that computes the same function where there is
              one, and its bound.
4. check    — small Newton sequences (n = 400) on the card against the same
              sequences run on the CPU through the plain versions: the
              dense-K solvers, and the matrix-free Jacobi-preconditioned
              front door (log p to 1e-10, iterations within one).
5. main     — the paper's GP-classification Newton sequence at n = 36 551
              (Table 1's n; ``benchmarks/common.py`` settings: digits seed 0,
              noise 0.10, θ = 3, λ = 3, f64, dense K built on the card),
              solved by Cholesky, CG, def-CG(8, 12) through RecycleManager,
              and the SolveSpec front door at the paper's solver tol 1e-5.
              def-CG must beat CG on iterations after system 1, and every
              kernel must have launched in that run (the counts in the
              kernels line) while no plain version ran on the card.  The
              per-step log p gap to Cholesky at tol 1e-5 is reported; the
              three iterative solvers are then run again at solver tol 1e-10
              (counted apart) and must agree with Cholesky's log p to 1e-6.
              ``scripts/paper_tol_witness.py`` shows on the CPU that the
              reference has the same gap at tol 1e-5, growing with n.
6. scale    — one RBF Gram matvec each in f32 and f64 at n = 131 072,
              d = 784, where a dense K would need 69 GB (f32) or 137 GB.
7. main-mf  — the matrix-free Newton sequence (K never formed; every K
              product is the RBF Gram matvec kernel) on the same n = 36 551
              data, f64, solver tol 1e-5: def-CG(8, 12) through
              RecycleManager, and the SolveSpec front door with
              precond="jacobi" and precond="nystrom" (rank 16, generator
              seed 0).  The two preconditioned sequences run at n = 16 384
              when the kernel's measured f64 time passes 0.25 s per call.
              Every kernel must launch in this run, no plain version may
              run on the card, and every log p must be finite; each is set
              beside a Cholesky log p of the same data.
8. agree    — at n = 4 000, matrix-free def-CG against dense def-CG, both
              f64: at solver tol 1e-10 iterations within one per system,
              at solver tol 1e-12 log p to 1e-10.

Each main path (5 and 7) is driven with the launch counters set to 0
just before it and read just after; the ``{"kernels": [...]}`` JSON line
gives each kernel's launches summed over the two.  Last comes the
``{"ok": true, "device": {...}}`` line; the full report also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PAPER_N = 36551  # benchmarks/paper_table1.py: the paper's Table 1 n
RAGGED_N = 1000
K, ELL = 8, 12
M = K + ELL  # window rows after system 1: Z = [W, P]
TOL = {"float64": 1e-12, "float32": 2e-4}
RBF_TOL_F32 = (2e-4, 5e-4)  # relative, absolute: tests/test_kernels.py
REPS = 25
RBF_REPS = 3  # one f64 call at the paper's n takes a quarter second

# configs/gpc_mnist.py's widths: d = 784, θ = λ = 3, block 1024; the
# Nyström sketch of SolveSpec's default rank.
D, THETA, LENGTHSCALE, BLOCK, PRECOND_RANK = 784, 3.0, 3.0, 1024, 16
RBF_RS = (1, K, PRECOND_RANK + 8)  # a CG step, the A·W refresh, the sketch
SCALE_N = 131072
AGREE_N = 4000
CUT_N = 16384  # the preconditioned sequences' n when the kernel is slow
CUT_MS = 250.0

# Card peaks (NVIDIA data sheets; dense).  "float64"/"float32" are the
# CUDA-core rates the SIMT kernels run at; "float64_tensor" is the FP64
# tensor-core rate, the least time of the RBF Gram matvec's f64 GEMM-shaped
# work.  Keyed by a substring of the card name.
PEAKS = {
    "H100": {"bytes": 3.35e12, "float64": 34e12, "float32": 67e12,
             "float64_tensor": 67e12},
}

# Which TPU kernel each port kernel replaces, and the port's source.
REPLACES = {
    "fused_cg_update": "src/repro/kernels/cg_fused.py:122",
    "fused_deflate_direction": "src/repro/kernels/cg_fused.py:426",
    "rbf_matvec": "src/repro/kernels/rbf_matvec.py:77",
    "self_gram": "src/repro/kernels/cg_fused.py:558",
    "recombine_blocks": "src/repro/kernels/cg_fused.py:639",
    "fused_rz_reduce": "src/repro/kernels/cg_fused.py:252",
}
SOURCES = dict.fromkeys(REPLACES, "src/repro_torch/csrc/cg_fused.cu")
SOURCES["rbf_matvec"] = "src/repro_torch/csrc/rbf_matvec.cu"
DENSE_PATH_KERNELS = ("fused_cg_update", "fused_deflate_direction", "self_gram",
                      "recombine_blocks")


def log(msg=""):
    print(msg, flush=True)


def peaks_for(name: str) -> dict:
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no peak table for card {name!r}")


def device_ms(torch, fn, reps=REPS) -> float:
    """Median device time of one ``fn()``: CUDA events around each of
    ``reps`` calls queued behind a spin kernel (so host launch overhead is
    not timed), with a 96 MiB write before each to evict the 50 MB L2 —
    the def-CG loop reads the 10.7 GB dense K between two calls."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    # Warm every kernel of the loop first: a kernel's first launch loads
    # its module, which can block the host until the spin kernel ends.
    for _ in range(2):
        flush.zero_()
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _is_device(evt) -> bool:
    return "cuda" in str(getattr(evt, "device_type", "")).lower()


def profile_kernels(torch, fn, reps=REPS):
    """Device time per call of each GPU kernel ``fn`` launches, from a
    ``torch.profiler`` trace of ``reps`` calls: ``{kernel name: ms}``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if _is_device(evt) and us > 0 and evt.count >= reps:
            out[evt.key[:60]] = us / reps / 1e3
    return out


def compare(torch, got, want, dtype_name, what):
    """Max abs error of a kernel output against its plain version; raises
    when the error relative to the output's scale passes the tolerance."""
    got = [g for g in got if g is not None]
    want = [w for w in want if w is not None]
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} outputs, plain gave {len(want)}")
    worst_abs = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: bad output shape or non-finite values")
        err = float((g - w).abs().max())
        scale = max(1.0, float(w.abs().max()))
        if err / scale > TOL[dtype_name]:
            raise AssertionError(
                f"{what}: error {err:.3e} (relative {err / scale:.3e}) "
                f"> {TOL[dtype_name]}"
            )
        worst_abs = max(worst_abs, err)
    return worst_abs


def kernel_inputs(torch, n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=dtype)

    return {
        "x": rnd(n), "r": rnd(n), "p": rnd(n), "ap": rnd(n),
        "aw": rnd(K, n), "w": rnd(K, n), "mu": rnd(K),
        "alpha": rnd(()), "beta": rnd(()),
        "p_buf": rnd(ELL + 1, n), "ap_buf": rnd(ELL + 1, n),
        "idx": torch.tensor(5, device="cuda"),
        "s": rnd(2 * M, n), "u": rnd(M, K),
    }


def kernel_calls(cf, t):
    """name -> list of (label, kernel call, plain call) on inputs ``t``."""
    bufs = lambda: (t["p_buf"].clone(), t["ap_buf"].clone())  # noqa: E731
    return {
        "fused_cg_update": [
            ("aw", lambda: cf.fused_cg_update_cuda(t["x"], t["r"], t["p"], t["ap"], t["alpha"], t["aw"]),
             lambda: cf.fused_cg_update_plain(t["x"], t["r"], t["p"], t["ap"], t["alpha"], t["aw"])),
            ("no-aw", lambda: cf.fused_cg_update_cuda(t["x"], t["r"], t["p"], t["ap"], t["alpha"]),
             lambda: cf.fused_cg_update_plain(t["x"], t["r"], t["p"], t["ap"], t["alpha"])),
        ],
        "fused_deflate_direction": [
            ("direction", lambda: cf.fused_deflate_direction_cuda(t["r"], t["p"], t["beta"], t["w"], t["mu"]),
             lambda: cf.fused_deflate_direction_plain(t["r"], t["p"], t["beta"], t["w"], t["mu"])),
            ("buffered", lambda: cf.fused_deflate_direction_cuda(t["r"], t["p"], t["beta"], t["w"], t["mu"], t["ap"], t["idx"], *bufs()),
             lambda: cf.fused_deflate_direction_plain(t["r"], t["p"], t["beta"], t["w"], t["mu"], t["ap"], t["idx"], *bufs())),
            ("plain-cg", lambda: cf.fused_deflate_direction_cuda(t["r"], t["p"], t["beta"]),
             lambda: cf.fused_deflate_direction_plain(t["r"], t["p"], t["beta"])),
        ],
        "self_gram": [
            ("S", lambda: (cf.self_gram_cuda(t["s"]),), lambda: (cf.self_gram_plain(t["s"]),)),
        ],
        "fused_rz_reduce": [
            ("aw", lambda: cf.fused_rz_reduce_cuda(t["r"], t["p"], t["aw"]),
             lambda: cf.fused_rz_reduce_plain(t["r"], t["p"], t["aw"])),
            ("no-aw", lambda: cf.fused_rz_reduce_cuda(t["r"], t["p"]),
             lambda: cf.fused_rz_reduce_plain(t["r"], t["p"])),
        ],
        "recombine_blocks": [
            ("S,u", lambda: (cf.recombine_blocks_cuda(t["s"], t["u"]),),
             lambda: (cf.recombine_blocks_plain(t["s"], t["u"]),)),
        ],
    }


def work(name, n, itemsize):
    """(bytes moved, operations) of one call at the main path's shapes:
    each input read once, each output written once."""
    if name == "fused_cg_update":
        return (6 * n + K * n + K + 2) * itemsize, (6 + 2 * K) * n
    if name == "fused_deflate_direction":
        return (3 * n + K * n + K + 1) * itemsize, (2 + 2 * K) * n
    if name == "self_gram":
        m2 = 2 * M
        return (m2 * n + m2 * m2) * itemsize, m2 * (m2 + 1) * n
    if name == "recombine_blocks":
        return (2 * M * n + M * K + 2 * K * n) * itemsize, 4 * K * M * n
    if name == "fused_rz_reduce":
        return ((2 + K) * n + K + 1) * itemsize, 2 * (1 + K) * n
    raise KeyError(name)


def phase_kernels(torch, cf, peaks):
    f64 = torch.float64
    report = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        for n in (PAPER_N, CUT_N, RAGGED_N):
            t = kernel_inputs(torch, n, dtype, seed=n)
            for name, calls in kernel_calls(cf, t).items():
                for label, kern, plain in calls:
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    err = compare(torch, got, want, dname, f"{name}[{label}] {dname} n={n}")
                    log(f"[kernels] {name:24s} {label:9s} {dname} n={n:6d}: max abs err {err:.3e}")
                    if dtype == f64 and n == PAPER_N:
                        entry = report.setdefault(name, {"max_abs_err": 0.0})
                        entry["max_abs_err"] = max(entry["max_abs_err"], err)

    t = kernel_inputs(torch, PAPER_N, f64, seed=1)
    ut = t["u"].T
    library = {
        "self_gram": lambda: t["s"] @ t["s"].T,
        "recombine_blocks": lambda: torch.matmul(ut, t["s"].view(2, M, PAPER_N)),
        # rᵀz alone: the no-AW arm (timed beside it below).
        "fused_rz_reduce": lambda: torch.dot(t["r"], t["p"]),
    }
    calls = kernel_calls(cf, t)
    for name, entry in report.items():
        _, kern, plain = calls[name][0]
        nbytes, ops = work(name, PAPER_N, 8)
        entry["ms"] = device_ms(torch, kern)
        entry["plain_ms"] = device_ms(torch, plain)
        entry["library_ms"] = device_ms(torch, library[name]) if name in library else None
        t_bytes, t_ops = nbytes / peaks["bytes"], ops / peaks["float64"]
        entry["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        entry["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        entry["profiled_kernels_ms"] = profile_kernels(torch, kern)
        extra = f" profiler {entry['profiled_kernels_ms']}"
        if name == "fused_deflate_direction":
            entry["recording_arm_ms"] = device_ms(torch, lambda: cf.fused_deflate_direction_cuda(
                t["r"], t["p"], t["beta"], t["w"], t["mu"], t["ap"], t["idx"],
                t["p_buf"], t["ap_buf"]))
            extra += f" recording arm {entry['recording_arm_ms']:.4f} ms"
        if name == "fused_rz_reduce":
            entry["no_aw_ms"] = device_ms(torch, calls[name][1][1])
            extra += f" no-AW arm {entry['no_aw_ms']:.4f} ms"
        log(f"[timing] {name:24s} f64 n={PAPER_N}: kernel {entry['ms']:.4f} ms, plain "
            f"{entry['plain_ms']:.4f} ms, library {entry['library_ms']} ms, bound "
            f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}){extra}")
    return report


def rbf_inputs(torch, n, d, r, dtype, seed):
    """Pixel-like data in [0, 1) (the digits' range) and Gaussian V."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((n, d), generator=g, device="cuda", dtype=dtype)
    v = torch.randn((n, r), generator=g, device="cuda", dtype=dtype)
    return x, v


def rbf_work(n, d, r, itemsize):
    """(bytes moved, operations) of one RBF Gram matvec: X and V read once,
    Y written once.  K(X, X) is symmetric, so the least work forms each
    pair once: the cross term X·Xᵀ is a SYRK of n(n+1)·d flops, and the
    distances and exp (about 8 operations a pair) come to ~4n²; K·V still
    takes 2n²r, since a tile K_ij feeds both Y_i += K_ij·V_j and
    Y_j += K_ijᵀ·V_i.  The kernel does not use the symmetry yet (it forms
    every tile) and is held to this bound all the same."""
    return (n * d + 2 * n * r) * itemsize, n * (n + 1) * d + 2 * n * n * r + 4 * n * n


def phase_rbf(torch, rbf, peaks):
    """The RBF Gram matvec against its plain version in f64 and f32 at the
    paper's n, the cut n of the preconditioned sequences and a ragged n,
    then timed at the main path's shapes.  The f32 bound is taken at the
    FP32 vector rate, not the TF32 tensor-core rate: TF32's 10-bit
    mantissa cannot hold ‖xᵢ‖² + ‖xⱼ‖² − 2xᵢ·xⱼ to the f32 tolerance, so
    no f32 kernel of this accuracy can run at that rate."""
    report = {"max_abs_err": 0.0}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        for n, d in ((PAPER_N, D), (CUT_N, D), (RAGGED_N, 50)):
            for r in RBF_RS:
                x, v = rbf_inputs(torch, n, d, r, dtype, seed=n + r)
                got = rbf.rbf_matvec_cuda(x, v, THETA, LENGTHSCALE)
                want = rbf.rbf_matvec_plain(x, v, THETA, LENGTHSCALE, BLOCK)
                torch.cuda.synchronize()
                what = f"rbf_matvec {dname} n={n} d={d} r={r}"
                if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{what}: bad output shape or non-finite values")
                err = float((got - want).abs().max())
                if dtype == torch.float64:
                    scale = max(1.0, float(want.abs().max()))
                    if err / scale > TOL["float64"]:
                        raise AssertionError(f"{what}: relative error {err / scale:.3e}")
                    if n == PAPER_N:
                        report["max_abs_err"] = max(report["max_abs_err"], err)
                else:
                    rtol, atol = RBF_TOL_F32
                    if bool(((got - want).abs() > atol + rtol * want.abs()).any()):
                        raise AssertionError(f"{what}: error {err:.3e} past {RBF_TOL_F32}")
                log(f"[kernels] rbf_matvec {dname} n={n:6d} d={d} r={r:2d}: max abs err "
                    f"{err:.3e} (max |y| {float(want.abs().max()):.3e})")

    timings = {}
    for dtype, rs in ((torch.float64, RBF_RS), (torch.float32, (1,))):
        dname = str(dtype).split(".")[-1]
        itemsize = 8 if dtype == torch.float64 else 4
        peak = peaks["float64_tensor"] if dtype == torch.float64 else peaks["float32"]
        for r in rs:
            x, v = rbf_inputs(torch, PAPER_N, D, r, dtype, seed=r)
            kms = device_ms(torch, lambda: rbf.rbf_matvec_cuda(x, v, THETA, LENGTHSCALE),
                            RBF_REPS)
            pms = device_ms(torch, lambda: rbf.rbf_matvec_plain(x, v, THETA, LENGTHSCALE, BLOCK),
                            RBF_REPS)
            nbytes, ops = rbf_work(PAPER_N, D, r, itemsize)
            t_bytes, t_ops = nbytes / peaks["bytes"], ops / peak
            timings[f"{dname} r={r}"] = t = {
                "ms": kms, "plain_ms": pms, "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "tflop_s": ops / kms / 1e9,
            }
            log(f"[timing] rbf_matvec {dname} n={PAPER_N} d={D} r={r:2d}: kernel {kms:.2f} ms "
                f"({t['tflop_s']:.2f} TFLOP/s), plain {pms:.2f} ms, bound {t['bound_ms']:.2f} ms "
                f"({t['bound_by']}), library null")
    main = timings["float64 r=1"]
    report.update(ms=main["ms"], plain_ms=main["plain_ms"], library_ms=None,
                  bound_ms=main["bound_ms"], bound_by=main["bound_by"], timings=timings)
    x, v = rbf_inputs(torch, PAPER_N, D, 1, torch.float64, seed=1)
    report["profiled_kernels_ms"] = profile_kernels(
        torch, lambda: rbf.rbf_matvec_cuda(x, v, THETA, LENGTHSCALE), reps=2)
    log(f"[timing] rbf_matvec profiler {report['profiled_kernels_ms']}")
    return report


def phase_scale(torch, rbf):
    """One Gram matvec each in f32 and f64 at n = 131 072, where a dense K
    does not fit the card."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        itemsize = 8 if dtype == torch.float64 else 4
        x, v = rbf_inputs(torch, SCALE_N, D, 1, dtype, seed=7)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        y = rbf.rbf_matvec_cuda(x, v, THETA, LENGTHSCALE)
        end.record()
        torch.cuda.synchronize()
        if y.shape != (SCALE_N, 1) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"[scale] {dname}: bad output")
        ms = start.elapsed_time(end)
        out[dname] = {"ms": ms, "dense_k_gb": SCALE_N * SCALE_N * itemsize / 1e9}
        log(f"[scale] rbf_matvec {dname} n={SCALE_N} d={D}: {ms:.1f} ms "
            f"(a dense K would need {out[dname]['dense_k_gb']:.0f} GB)")
        del x, v, y
    return out


def laplace_runs(torch, launches, x, y, k_dense, solver_tol, log_prefix,
                 solvers=("cholesky", "cg", "defcg", "spec"), dense=True):
    """One ``laplace_gpc`` Newton sequence per solver: ``cholesky``, ``cg``,
    ``defcg`` (RecycleManager), ``spec`` (the front door), or ``jacobi`` /
    ``nystrom`` (the front door, preconditioned).  ``dense`` applies K as
    the dense ``k_dense @ v``; otherwise through the RBF Gram matvec."""
    from repro_torch.core import RecycleManager, SolveSpec
    from repro_torch.gp import RBFKernel, laplace_gpc

    runs = {}
    for solver in solvers:
        kw = {"solver": solver}
        if solver == "defcg":
            kw["recycle"] = RecycleManager(k=K, ell=ELL)
        if solver in ("spec", "jacobi", "nystrom"):
            precond = "none" if solver == "spec" else solver
            kw = {"spec": SolveSpec(k=K, ell=ELL, tol=solver_tol, precond=precond,
                                    precond_rank=PRECOND_RANK)}
            if solver == "nystrom":
                kw["precond_generator"] = torch.Generator().manual_seed(0)
        before = dict(launches)
        t0 = time.perf_counter()
        res = laplace_gpc(
            x, y, RBFKernel(theta=THETA, lengthscale=LENGTHSCALE),
            solver_tol=solver_tol, newton_tol=1.0, block=BLOCK,
            k_dense=k_dense, dense_matvec=dense, **kw,
        )
        if x.is_cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f = res.f
        if f.shape != x.shape[:1] or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{solver}: non-finite or misshaped latent f")
        acc = float((torch.sign(f) == y).double().mean())
        launched = {k: launches[k] - before[k] for k in before}
        runs[solver] = {
            "logp": res.logp,
            "logp_trace": res.trace.logp,
            "newton_steps": len(res.trace.logp),
            "iterations": res.trace.solver_iterations,
            "matvecs": res.trace.solver_matvecs,
            "cumulative_solve_s": res.trace.cumulative_time,
            "wall_s": wall,
            "train_accuracy": acc,
            "launches": launched,
        }
        log(f"{log_prefix} {solver:8s} logp={res.logp:.10f} newton={len(res.trace.logp)} "
            f"iters={res.trace.solver_iterations} matvecs={res.trace.solver_matvecs} "
            f"solve_s={[round(v, 4) for v in res.trace.cumulative_time]} wall={wall:.2f}s "
            f"acc={acc:.4f} launches={launched}")
    return runs


def frozen_steps(iterations, ell, chunk):
    """Masked steps the harness runs past convergence (host reads every
    ``chunk`` steps after the ``ell`` recording steps)."""
    steps = ell
    if iterations > ell:
        steps += chunk * math.ceil((iterations - ell) / chunk)
    return steps - iterations


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core import engine
    from repro_torch.data import make_infinite_digits
    from repro_torch.gp import RBFKernel
    from repro_torch.kernels import _build
    from repro_torch.kernels import cg_fused as cf
    from repro_torch.kernels import rbf_matvec as rbf

    report = {}
    # -- 1. device ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[device] {card}, capability {torch.cuda.get_device_capability(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    report["card"] = smi
    peaks = peaks_for(card)
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    sources = sorted(p[:-3] for p in os.listdir(_build.CSRC) if p.endswith(".cu"))
    logs = _build.build(sources)
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {sources} in {report['build_s']:.1f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line and "0 bytes spill" not in line:
                log(f"[build] {src}: {line.strip()}")

    # -- 3. kernels ---------------------------------------------------------
    kernels = phase_kernels(torch, cf, peaks)
    kernels["rbf_matvec"] = rbf_k = phase_rbf(torch, rbf, peaks)

    # -- 4. small check: card against CPU ------------------------------------
    xs, ys = make_infinite_digits(400, seed=1, noise=0.10)
    small = {}
    for dev in ("cuda", "cpu"):
        x = torch.as_tensor(xs, dtype=torch.float64, device=dev)
        y = torch.as_tensor(ys, dtype=torch.float64, device=dev)
        small[dev] = laplace_runs(torch, cf.LAUNCHES, x, y, None, 1e-10, f"[check {dev}]")
    for solver, run in small["cuda"].items():
        cpu = small["cpu"][solver]
        if abs(run["logp"] - cpu["logp"]) > 1e-8 * abs(cpu["logp"]):
            raise AssertionError(f"[check] {solver}: card logp {run['logp']} vs CPU {cpu['logp']}")
        if len(run["iterations"]) != len(cpu["iterations"]) or any(
            abs(a - b) > 1 for a, b in zip(run["iterations"], cpu["iterations"])
        ):
            raise AssertionError(f"[check] {solver}: iterations {run['iterations']} vs {cpu['iterations']}")
    report["check"] = small
    # The matrix-free, Jacobi-preconditioned front door: RBF Gram matvec
    # and fused_rz_reduce kernels on the card, their plain versions on the
    # CPU.
    small_mf = {}
    for dev in ("cuda", "cpu"):
        x = torch.as_tensor(xs, dtype=torch.float64, device=dev)
        y = torch.as_tensor(ys, dtype=torch.float64, device=dev)
        small_mf[dev] = laplace_runs(torch, cf.LAUNCHES, x, y, None, 1e-10,
                                     f"[check-mf {dev}]", solvers=("jacobi",), dense=False)
    run, cpu = small_mf["cuda"]["jacobi"], small_mf["cpu"]["jacobi"]
    if abs(run["logp"] - cpu["logp"]) > 1e-10 * abs(cpu["logp"]):
        raise AssertionError(f"[check-mf] card logp {run['logp']} vs CPU {cpu['logp']}")
    if len(run["iterations"]) != len(cpu["iterations"]) or any(
        abs(a - b) > 1 for a, b in zip(run["iterations"], cpu["iterations"])
    ):
        raise AssertionError(f"[check-mf] iterations {run['iterations']} vs {cpu['iterations']}")
    if not (run["launches"]["rbf_matvec"] and run["launches"]["fused_rz_reduce"]):
        raise AssertionError(f"[check-mf] kernels not launched: {run['launches']}")
    report["check_mf"] = small_mf

    # -- 5. main path -------------------------------------------------------
    t0 = time.perf_counter()
    xn, yn = make_infinite_digits(PAPER_N, seed=0, noise=0.10)
    data_s = time.perf_counter() - t0
    x = torch.as_tensor(xn, dtype=torch.float64, device="cuda")
    y = torch.as_tensor(yn, dtype=torch.float64, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k_dense = RBFKernel(theta=THETA, lengthscale=LENGTHSCALE).gram(x)
    torch.cuda.synchronize()
    gram_s = time.perf_counter() - t0
    log(f"[main] n={PAPER_N}: digits {data_s:.1f} s (CPU), dense K {gram_s:.3f} s")
    ones = torch.ones(PAPER_N, dtype=torch.float64, device="cuda")
    gemv_ms = device_ms(torch, lambda: k_dense @ ones)
    log(f"[main] dense GEMV K @ v: {gemv_ms:.4f} ms")

    def zero_counts():
        for key in cf.LAUNCHES:
            cf.LAUNCHES[key] = 0
            cf.PLAIN_ON_CUDA[key] = 0

    # The main path: the paper's solver tol 1e-5.  Its counts alone go into
    # the kernels line.
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    runs = laplace_runs(torch, cf.LAUNCHES, x, y, k_dense, 1e-5, "[main]")
    launches = dict(cf.LAUNCHES)
    plain_on_cuda = dict(cf.PLAIN_ON_CUDA)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[main] launches {launches}; plain versions on the card {plain_on_cuda}; "
        f"peak memory {peak_gb:.2f} GB")
    # The agreement check at solver tol 1e-10, counted on its own.
    zero_counts()
    tight = laplace_runs(torch, cf.LAUNCHES, x, y, k_dense, 1e-10, "[main tol=1e-10]",
                         solvers=("cg", "defcg", "spec"))
    tight_launches = dict(cf.LAUNCHES)
    tight_plain = dict(cf.PLAIN_ON_CUDA)
    log(f"[main tol=1e-10] launches {tight_launches}; plain versions on the card "
        f"{tight_plain}")

    # At the paper's solver tol (1e-5) the iterative Newton sequences drift
    # from Cholesky's by far more than the tolerance, by a gap that grows
    # with n (the reference does the same: scripts/paper_tol_witness.py),
    # and may take one more Newton step; the per-step δ (paper Table 1's
    # column) is reported.  The agreement itself is held at solver tol 1e-10.
    chol = runs["cholesky"]
    for solver in ("cg", "defcg", "spec"):
        run = runs[solver]
        deltas = [abs(a - b) / abs(b) for a, b in zip(run["logp_trace"], chol["logp_trace"])]
        run["delta_vs_cholesky"] = deltas
        log(f"[main] {solver:8s} per-step δ vs cholesky (tol 1e-5): "
            + " ".join(f"{d:.1e}" for d in deltas))
        t = tight[solver]
        rel = abs(t["logp"] - chol["logp"]) / abs(chol["logp"])
        t["delta_vs_cholesky"] = rel
        log(f"[main] {solver:8s} tol 1e-10: logp {t['logp']:.10f}, δ vs cholesky {rel:.2e}, "
            f"newton {t['newton_steps']} vs {chol['newton_steps']}")
        if rel > 1e-6 or t["newton_steps"] != chol["newton_steps"]:
            raise AssertionError(f"[main] {solver} at tol 1e-10 disagrees with cholesky")
    cg_after = sum(runs["cg"]["iterations"][1:])
    def_after = sum(runs["defcg"]["iterations"][1:])
    if not def_after < cg_after:
        raise AssertionError(f"[main] def-CG {def_after} iterations after system 1, CG {cg_after}")
    if not all(launches[k] > 0 for k in DENSE_PATH_KERNELS):
        raise AssertionError(f"[main] a kernel never launched: {launches}")
    if any(plain_on_cuda.values()) or any(tight_plain.values()):
        raise AssertionError(
            f"[main] plain versions ran on the card: {plain_on_cuda}, {tight_plain}")
    log(f"[main] iterations after system 1: cg {cg_after}, defcg {def_after} "
        f"({1 - def_after / cg_after:.1%} fewer)")

    frozen = {
        s: sum(frozen_steps(i, ELL if s in ("defcg", "spec") else 0, engine.CHUNK)
               for i in runs[s]["iterations"])
        for s in ("cg", "defcg", "spec")
    }
    log(f"[main] frozen-step matvecs (computed, discarded, not counted): {frozen}; "
        f"at {gemv_ms:.4f} ms each: "
        + ", ".join(f"{s} {c * gemv_ms:.2f} ms" for s, c in frozen.items()))
    # Passes over the 10.7 GB K inside the timed solves: every masked step,
    # the initial residual, and one multi-RHS refresh per carried basis.
    per_pass = {}
    for s in ("cg", "defcg", "spec"):
        run = runs[s]
        refreshes = len(run["iterations"]) - 1 if s != "cg" else 0
        passes = sum(run["iterations"]) + frozen[s] + len(run["iterations"]) + refreshes
        per_pass[s] = 1e3 * run["cumulative_solve_s"][-1] / passes
    log("[main] solve time per pass over K (GEMV "
        f"{gemv_ms:.4f} ms): " + ", ".join(f"{s} {v:.4f} ms" for s, v in per_pass.items()))

    report.update(
        main={"n": PAPER_N, "runs": runs, "tight": tight, "launches": launches,
              "tight_launches": tight_launches, "plain_on_cuda": plain_on_cuda,
              "tight_plain_on_cuda": tight_plain, "peak_memory_gb": peak_gb,
              "gemv_ms": gemv_ms, "gram_s": gram_s, "digits_s": data_s,
              "frozen_step_matvecs": frozen, "solve_ms_per_k_pass": per_pass},
    )
    log(f"[main] RBF Gram matvec f64 r=1: {rbf_k['ms']:.2f} ms against the dense GEMV "
        f"K @ v {gemv_ms:.4f} ms ({rbf_k['ms'] / gemv_ms:.0f}x)")
    chol_logp = runs["cholesky"]["logp"]
    del k_dense
    torch.cuda.empty_cache()

    # -- 6. scale: past what a dense K allows --------------------------------
    report["scale"] = phase_scale(torch, rbf)

    # -- 7. the matrix-free main path -----------------------------------------
    cut = rbf_k["ms"] > CUT_MS
    pre_n = CUT_N if cut else PAPER_N
    if cut:
        xc, yc = (torch.as_tensor(a, dtype=torch.float64, device="cuda")
                  for a in make_infinite_digits(CUT_N, seed=0, noise=0.10))
        log(f"[main-mf] the kernel takes {rbf_k['ms']:.1f} ms > {CUT_MS} ms per call: "
            f"the preconditioned sequences run at n = {CUT_N}")
    else:
        xc, yc = x, y
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    mf = laplace_runs(torch, cf.LAUNCHES, x, y, None, 1e-5, "[main-mf]",
                      solvers=("defcg",), dense=False)
    mf.update(laplace_runs(torch, cf.LAUNCHES, xc, yc, None, 1e-5, f"[main-mf n={pre_n}]",
                           solvers=("jacobi", "nystrom"), dense=False))
    mf_launches = dict(cf.LAUNCHES)
    mf_plain = dict(cf.PLAIN_ON_CUDA)
    mf_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[main-mf] launches {mf_launches}; plain versions on the card {mf_plain}; "
        f"peak memory {mf_peak_gb:.2f} GB")
    if not all(mf_launches.values()):
        raise AssertionError(f"[main-mf] a kernel never launched: {mf_launches}")
    if any(mf_plain.values()):
        raise AssertionError(f"[main-mf] plain versions ran on the card: {mf_plain}")
    if cut:  # Cholesky on the cut data (dense K, no kernel), counted apart
        kc = RBFKernel(theta=THETA, lengthscale=LENGTHSCALE).gram(xc)
        chol_cut = laplace_runs(torch, cf.LAUNCHES, xc, yc, kc, 1e-5,
                                f"[main-mf n={pre_n}]", solvers=("cholesky",))["cholesky"]
        del kc
        torch.cuda.empty_cache()
    for solver, run in mf.items():
        if not all(math.isfinite(v) for v in run["logp_trace"]):
            raise AssertionError(f"[main-mf] {solver}: non-finite log p {run['logp_trace']}")
        n_run = PAPER_N if solver == "defcg" else pre_n
        ref = chol_logp if n_run == PAPER_N else chol_cut["logp"]
        steps = run["newton_steps"]
        # K3 calls inside the timed solves: all but b and f of each step.
        passes = run["launches"]["rbf_matvec"] - 2 * steps
        run.update(n=n_run, k3_passes=passes,
                   solve_ms_per_k3_pass=1e3 * run["cumulative_solve_s"][-1] / passes,
                   cholesky_logp=ref, delta_vs_cholesky=abs(run["logp"] - ref) / abs(ref),
                   frozen_steps=sum(frozen_steps(i, ELL, engine.CHUNK)
                                    for i in run["iterations"]))
        log(f"[main-mf] {solver:8s} n={n_run}: newton {steps}, iterations {run['iterations']}, "
            f"matvecs {run['matvecs']}, solve {run['cumulative_solve_s'][-1]:.2f} s, "
            f"{passes} K3 passes at {run['solve_ms_per_k3_pass']:.1f} ms each "
            f"({run['frozen_steps']} frozen steps), logp {run['logp']:.10f} vs cholesky "
            f"{ref:.10f} (δ {run['delta_vs_cholesky']:.2e})")
    report["main_mf"] = {"runs": mf, "launches": mf_launches, "plain_on_cuda": mf_plain,
                         "peak_memory_gb": mf_peak_gb, "preconditioned_n": pre_n,
                         "cut": cut}

    # -- 8. agreement: matrix-free against dense where both fit --------------
    # At solver tol 1e-10 the iterations must agree within one per system.
    # The log p is held to 1e-10 at solver tol 1e-12: at 1e-10 the cold
    # first system of the two paths can stop an iteration apart, and the log
    # p gap is then of the solver tolerance's size, in the reference's own
    # dense and matrix-free paths too (scripts/matrix_free_witness.py).
    xa, ya = (torch.as_tensor(a, dtype=torch.float64, device="cuda")
              for a in make_infinite_digits(AGREE_N, seed=0, noise=0.10))
    ka = RBFKernel(theta=THETA, lengthscale=LENGTHSCALE).gram(xa)
    report["agree"] = agree = {"n": AGREE_N}
    for tol in (1e-10, 1e-12):
        dense_run = laplace_runs(torch, cf.LAUNCHES, xa, ya, ka, tol, f"[agree dense {tol:g}]",
                                 solvers=("defcg",))["defcg"]
        mf_run = laplace_runs(torch, cf.LAUNCHES, xa, ya, None, tol, f"[agree mf {tol:g}]",
                              solvers=("defcg",), dense=False)["defcg"]
        rel = abs(mf_run["logp"] - dense_run["logp"]) / abs(dense_run["logp"])
        its_m, its_d = mf_run["iterations"], dense_run["iterations"]
        agree[f"{tol:g}"] = {"dense": dense_run, "matrix_free": mf_run, "logp_rel": rel}
        log(f"[agree] n={AGREE_N} tol {tol:g}: logp matrix-free {mf_run['logp']:.12f} vs dense "
            f"{dense_run['logp']:.12f} (rel {rel:.2e}); iterations {its_m} vs {its_d}")
        if len(its_m) != len(its_d):
            raise AssertionError(f"[agree] tol {tol:g}: Newton steps differ")
        if tol == 1e-10 and any(abs(a - b) > 1 for a, b in zip(its_m, its_d)):
            raise AssertionError(f"[agree] tol {tol:g}: iterations differ by more than one")
        if tol == 1e-12 and rel > 1e-10:
            raise AssertionError(f"[agree] tol {tol:g}: log p differs by {rel:.2e}")

    totals = {name: launches[name] + mf_launches[name] for name in cf.LAUNCHES}
    kernel_line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": totals[name], "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"],
         "bound_ms": kernels[name]["bound_ms"], "bound_by": kernels[name]["bound_by"],
         "library_ms": kernels[name]["library_ms"]}
        for name in cf.LAUNCHES
    ]}
    report["kernels"] = kernels
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    log(json.dumps(kernel_line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
