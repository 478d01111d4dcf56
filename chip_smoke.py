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
              one, and its bound.  The LSMR update (K7) is held at the
              least-squares path's n = 16 384, the Gauss-Newton parameter
              count 32 768, lsq_bench's 2²⁰ and a ragged n, and the two
              extraction kernels at the least-squares windows' 96, 112 and
              128 stacked rows (timed at 112 rows, n = 16 384).
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
9. check-lsq — ``benchmarks/lsq_bench.py``'s own problem (m = 180, n = 120,
              12 systems, logspace and flat spectra, drift 0.02, λ = 1e-4,
              tol 1e-8, deflsmr(8, 48)) on the card against the CPU: cold
              iterations within one (or 5 %) per system, recycled within
              10 % (ROADMAP P5), every x within 1e-6 relative; and six
              ``hf_step``s at ``tests/test_optim.py``'s size in each mode
              (Gauss-Newton and GGN), loss to 1e-10 and iterations equal.
10. main-lsq — the least-squares main path: lsq_bench's drifting ridge
              sequence at m = 24 576, n = 16 384 (f64, 3.2 GB a system, A_0
              built on the card), cold LSMR per system and deflsmr(8, 48)
              through the front door, over 12 systems.  Every system must
              converge, the last x must match a Cholesky solve of AᵀA + λI
              to 1e-5, and the LSMR update and both extraction kernels must
              launch.  Then, counted apart, ``torch.profiler`` over 16 LSMR
              iterations gives the launches per iteration.
11. main-gn  — Gauss-Newton training: ``hf_step(solver="gauss_newton")`` on
              a teacher-student tanh residual, 65 536 samples, d = 1024, 32
              outputs (32 768 parameters), f64, 10 steps with recycling and
              10 without; the loss must fall and stay finite, and the LSMR
              update must launch.

Each main path (5, 7, 10 and 11) is driven with the launch counters set to
0 just before it and read just after; the ``{"kernels": [...]}`` JSON line
gives each kernel's launches summed over the four.  Last comes the
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
# tensor-core rate, the least time of f64 GEMM-shaped work (the RBF Gram
# matvec, the extraction's S Sᵀ and uᵀS).  Keyed by a substring of the
# card name.
PEAKS = {
    "H100": {"bytes": 3.35e12, "float64": 34e12, "float32": 67e12,
             "float64_tensor": 67e12},
}
GEMM_SHAPED = ("self_gram", "recombine_blocks")

# benchmarks/lsq_bench.py's drifting ridge sequence (λ = 1e-4, tol 1e-8,
# deflsmr(8, 48), exact NW refresh, drift 0.02), at its own size for the
# card-against-CPU check and at m = 24 576, n = 16 384 (its m/n = 1.5) for
# the least-squares main path; maxiter 4000 there (the bench's 600 is for
# n = 120).
LSQ_DAMP, LSQ_TOL, LSQ_K, LSQ_ELL, LSQ_DRIFT = 1e-4, 1e-8, 8, 48, 0.02
LSQ_BENCH = {"m": 180, "n": 120, "num": 12, "maxiter": 600}
LSQ_MAIN = {"m": 24576, "n": 16384, "num": 12, "maxiter": 4000}
# Gauss-Newton training: tests/test_optim.py's teacher-student residual
# tanh(x @ w) − y widened to 65 536 samples, d = 1024, 32 outputs, f64.
GN = {"samples": 65536, "d": 1024, "out": 32, "steps": 10}
# K7 sizes: the least-squares main path's n, the GN parameter count,
# lsq_bench's microbench n, a ragged n.
K7_NS = (LSQ_MAIN["n"], GN["d"] * GN["out"], 1 << 20, RAGGED_N)
# Stacked window rows the extraction kernels must take: def-CG's 2(k + ℓ)
# = 40, and the least-squares windows (lsq_bench 2·56 = 112).
GRAM_ROWS = (96, 112, 128)

# Which TPU kernel each port kernel replaces, and the port's source.
REPLACES = {
    "fused_cg_update": "src/repro/kernels/cg_fused.py:122",
    "fused_deflate_direction": "src/repro/kernels/cg_fused.py:426",
    "rbf_matvec": "src/repro/kernels/rbf_matvec.py:77",
    "self_gram": "src/repro/kernels/cg_fused.py:558",
    "recombine_blocks": "src/repro/kernels/cg_fused.py:639",
    "fused_rz_reduce": "src/repro/kernels/cg_fused.py:252",
    "lsmr_update": "src/repro/kernels/cg_fused.py:336",
}
SOURCES = dict.fromkeys(REPLACES, "src/repro_torch/csrc/cg_fused.cu")
SOURCES["rbf_matvec"] = "src/repro_torch/csrc/rbf_matvec.cu"
DENSE_PATH_KERNELS = ("fused_cg_update", "fused_deflate_direction", "self_gram",
                      "recombine_blocks")
MF_PATH_KERNELS = DENSE_PATH_KERNELS + ("rbf_matvec", "fused_rz_reduce")
LSQ_PATH_KERNELS = ("lsmr_update", "self_gram", "recombine_blocks")
GN_PATH_KERNELS = ("lsmr_update",)


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
    if name == "lsmr_update":  # x, h̄, h, v and c0..c2 in; x', h̄', h' out
        return (7 * n + 3) * itemsize, 6 * n
    raise KeyError(name)


def ops_peak(peaks, name, dname):
    """The card's peak rate for ``name``'s operations in ``dname``."""
    if dname == "float64" and name in GEMM_SHAPED:
        return peaks["float64_tensor"]
    return peaks[dname]


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
        t_bytes, t_ops = nbytes / peaks["bytes"], ops / ops_peak(peaks, name, "float64")
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


def phase_lsmr_kernels(torch, cf, peaks):
    """K7 (``lsmr_update``) in f64 and f32 against its plain version at
    K7_NS, timed at each in f64 and at 2²⁰ in f32; then the extraction
    kernels (K4, K5) at the least-squares window rows, K4 and K5 timed at
    112 rows and n = 16 384, beside their bounds and the one PyTorch call
    that computes each."""
    report = {"max_abs_err": 0.0, "timings": {}}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        itemsize = 8 if dtype == torch.float64 else 4
        for n in K7_NS:
            g = torch.Generator(device="cuda").manual_seed(n)
            x, hbar, h, v = (torch.randn(n, generator=g, device="cuda", dtype=dtype)
                             for _ in range(4))
            c = [torch.randn((), generator=g, device="cuda", dtype=dtype) for _ in range(3)]
            got = cf.lsmr_update_cuda(x, hbar, h, v, *c)
            want = cf.lsmr_update_plain(x, hbar, h, v, *c)
            torch.cuda.synchronize()
            err = compare(torch, got, want, dname, f"lsmr_update {dname} n={n}")
            log(f"[kernels] lsmr_update {dname} n={n:7d}: max abs err {err:.3e}")
            if dtype == torch.float64 and n == LSQ_MAIN["n"]:
                report["max_abs_err"] = err
            if n == RAGGED_N or (dtype == torch.float32 and n != 1 << 20):
                continue
            nbytes, ops = work("lsmr_update", n, itemsize)
            t_bytes, t_ops = nbytes / peaks["bytes"], ops / peaks[dname]
            t = {"ms": device_ms(torch, lambda: cf.lsmr_update_cuda(x, hbar, h, v, *c)),
                 "plain_ms": device_ms(torch, lambda: cf.lsmr_update_plain(x, hbar, h, v, *c)),
                 "bound_ms": 1e3 * max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            report["timings"][f"{dname} n={n}"] = t
            log(f"[timing] lsmr_update {dname} n={n}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
                f"library null")
    main = report["timings"][f"float64 n={LSQ_MAIN['n']}"]
    report.update(main, library_ms=None)

    gram = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        for rows in GRAM_ROWS:
            for n in (LSQ_MAIN["n"], RAGGED_N):
                g = torch.Generator(device="cuda").manual_seed(rows + n)
                s_ = torch.randn(rows, n, generator=g, device="cuda", dtype=dtype)
                u = torch.randn(rows // 2, K, generator=g, device="cuda", dtype=dtype)
                e1 = compare(torch, (cf.self_gram_cuda(s_),), (cf.self_gram_plain(s_),),
                             dname, f"self_gram rows={rows} n={n}")
                e2 = compare(torch, (cf.recombine_blocks_cuda(s_, u),),
                             (cf.recombine_blocks_plain(s_, u),), dname,
                             f"recombine_blocks rows={rows} n={n}")
                log(f"[kernels] self_gram / recombine_blocks {dname} rows={rows} n={n:6d}: "
                    f"max abs err {e1:.3e} / {e2:.3e}")
    rows, n = 2 * (LSQ_K + LSQ_ELL), LSQ_MAIN["n"]
    g = torch.Generator(device="cuda").manual_seed(3)
    s_ = torch.randn(rows, n, generator=g, device="cuda", dtype=torch.float64)
    u = torch.randn(rows // 2, LSQ_K, generator=g, device="cuda", dtype=torch.float64)
    ut = u.T.contiguous()
    for name, kern, plain, lib, nbytes, ops in (
        ("self_gram", lambda: cf.self_gram_cuda(s_), lambda: cf.self_gram_plain(s_),
         lambda: s_ @ s_.T, (rows * n + rows * rows) * 8, rows * (rows + 1) * n),
        ("recombine_blocks", lambda: cf.recombine_blocks_cuda(s_, u),
         lambda: cf.recombine_blocks_plain(s_, u),
         lambda: torch.matmul(ut, s_.view(2, rows // 2, n)),
         (rows * n + rows // 2 * LSQ_K + 2 * LSQ_K * n) * 8, 2 * LSQ_K * rows * n),
    ):
        t_bytes, t_ops = nbytes / peaks["bytes"], ops / ops_peak(peaks, name, "float64")
        gram[name] = t = {"rows": rows, "n": n, "ms": device_ms(torch, kern),
                          "plain_ms": device_ms(torch, plain),
                          "library_ms": device_ms(torch, lib),
                          "bound_ms": 1e3 * max(t_bytes, t_ops),
                          "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        log(f"[timing] {name} f64 rows={rows} n={n}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    report["lsq_windows"] = gram
    return report


def drifting_lsq(torch, num, m, n, device, decay="logspace", seed=0):
    """``benchmarks/lsq_bench.py``'s drifting ridge sequence: singular
    values logspace(0, −3, n) (``decay="flat"``: |N(0, 1)| + 0.5) under
    random orthogonal factors, then A_{i+1} = A_i + drift·‖A_i‖_F/√(mn)·G.
    Yields ``(A_i, b_i)`` one system at a time.  On the CPU it is the
    bench's numpy recipe exactly (full (m, m) QR); on the card (logspace
    only) the left factor is the reduced QR of an (m, n) Gaussian, the
    same distribution without the (m, m) factor, drawn from a torch
    generator."""
    import numpy as np

    if device == "cpu":
        rng = np.random.default_rng(seed)
        U, _ = np.linalg.qr(rng.standard_normal((m, m)))
        V, _ = np.linalg.qr(rng.standard_normal((n, n)))
        s = np.logspace(0, -3, n) if decay == "logspace" else np.abs(rng.standard_normal(n)) + 0.5
        base = U[:, :n] @ np.diag(s) @ V.T
        for _ in range(num):
            b = rng.standard_normal(m)
            yield torch.from_numpy(base), torch.from_numpy(b)
            base = base + LSQ_DRIFT * np.linalg.norm(base) / np.sqrt(m * n) * \
                rng.standard_normal((m, n))
        return
    f64 = torch.float64
    g = torch.Generator(device=device).manual_seed(seed)
    U = torch.linalg.qr(torch.randn(m, n, generator=g, device=device, dtype=f64)).Q
    V = torch.linalg.qr(torch.randn(n, n, generator=g, device=device, dtype=f64)).Q
    U.mul_(torch.logspace(0, -3, n, device=device, dtype=f64))
    base = U @ V.T
    del U, V
    for _ in range(num):
        b = torch.randn(m, generator=g, device=device, dtype=f64)
        yield base, b
        step = torch.randn(m, n, generator=g, device=device, dtype=f64)
        base = step.mul_(LSQ_DRIFT * float(torch.linalg.norm(base)) / math.sqrt(m * n)).add_(base)


def lsq_runs(torch, systems, maxiter, log_prefix):
    """Cold LSMR per system and deflsmr(8, 48) over the sequence, both
    through the SolveSpec front door, each timed on the host clock ended
    by a synchronize."""
    from repro_torch.core import DenseMatrixOperator, SolveSpec, solve, solve_sequence

    sync = torch.cuda.synchronize if systems[0][0].is_cuda else (lambda: None)
    spec = dict(tol=LSQ_TOL, maxiter=maxiter, lsq_shift=LSQ_DAMP)
    cold, t0 = [], time.perf_counter()
    for A, b in systems:
        res = solve(DenseMatrixOperator(A), b, SolveSpec(method="lsmr", **spec))
        cold.append((res.x, res.info))
    sync()
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = solve_sequence([A for A, _ in systems], [b for _, b in systems],
                         SolveSpec(method="deflsmr", k=LSQ_K, ell=LSQ_ELL, refresh_aw="exact",
                                   **spec),
                         make_operator=DenseMatrixOperator)
    sync()
    rec_s = time.perf_counter() - t0
    out = {
        "cold": {"iterations": [int(i.iterations) for _, i in cold],
                 "matvecs": [int(i.matvecs) for _, i in cold],
                 "converged": [bool(i.converged) for _, i in cold], "wall_s": cold_s},
        "recycled": {"iterations": [int(i) for i in seq.info.iterations],
                     "matvecs": [int(i) for i in seq.info.matvecs],
                     "converged": [bool(c) for c in seq.info.converged], "wall_s": rec_s},
    }
    for name, run in out.items():
        log(f"{log_prefix} {name:8s} iterations {run['iterations']} (sum "
            f"{sum(run['iterations'])}), matvecs {sum(run['matvecs'])}, wall {run['wall_s']:.2f} s")
    return out, [x for x, _ in cold], seq


def _close_counts(got, want, frac):
    return all(abs(a - b) <= max(1, math.ceil(frac * b)) for a, b in zip(got, want))


def phase_check_lsq(torch, cf):
    """lsq_bench's own problem (m = 180, n = 120, 12 systems, logspace and
    flat) on the card against the CPU (plain versions), and six
    ``hf_step``s in each mode (tests/test_optim.py's size) likewise."""
    import numpy as np

    out = {}
    cfg = LSQ_BENCH
    for decay in ("logspace", "flat"):
        cpu = list(drifting_lsq(torch, cfg["num"], cfg["m"], cfg["n"], "cpu", decay))
        card = [(A.cuda(), b.cuda()) for A, b in cpu]
        res = {}
        for dev, systems in (("cuda", card), ("cpu", cpu)):
            res[dev] = lsq_runs(torch, systems, cfg["maxiter"], f"[check-lsq {decay} {dev}]")
        (rc, xc, sc), (rh, xh, sh) = res["cuda"], res["cpu"]
        # Cold solves stop within one iteration (or 5 %) of the CPU's; the
        # recycled ones within 10 %: past ~10 iterations each device's
        # rounding grows through the recurrence (ROADMAP P5).
        for name, frac in (("cold", 0.05), ("recycled", 0.10)):
            if not all(rc[name]["converged"]):
                raise AssertionError(f"[check-lsq] {decay} {name}: a card solve did not converge")
            if not _close_counts(rc[name]["iterations"], rh[name]["iterations"], frac):
                raise AssertionError(f"[check-lsq] {decay} {name}: iterations "
                                     f"{rc[name]['iterations']} vs CPU {rh[name]['iterations']}")
        xs = [(a, b) for a, b in zip(xc, xh)] + [(a, b) for a, b in zip(sc.x, sh.x)]
        worst = max(float(torch.linalg.norm(a.cpu() - b) / torch.linalg.norm(b)) for a, b in xs)
        log(f"[check-lsq] {decay}: worst x gap card vs CPU {worst:.2e} (relative)")
        if worst > 1e-6:
            raise AssertionError(f"[check-lsq] {decay}: x gap {worst:.2e} > 1e-6")
        if decay == "logspace" and not sum(rc["recycled"]["matvecs"]) < sum(rc["cold"]["matvecs"]):
            raise AssertionError("[check-lsq] recycling did not save products on the card")
        out[decay] = {"cuda": rc, "cpu": rh, "worst_x_gap": worst}

    # hf_step at tests/test_optim.py's size in both modes, card against CPU:
    # Gauss-Newton ((def)LSMR on the Jacobian: K7, K4, K5) and GGN (def-CG
    # on the damped GGN through torch.func: K1, K2, K4, K5).
    from repro_torch import convert
    from repro_torch.optim import HFConfig, hf_init, hf_step, squared_loss_hvp

    rng = np.random.default_rng(0)
    xs, wt = rng.standard_normal((64, 8)), rng.standard_normal((8, 3))
    w0 = rng.standard_normal((8, 3)) * 0.1

    def model_fn(p, bt):
        return torch.tanh(bt["x"] @ p["w"])

    def loss_fn(outputs, bt):
        return torch.mean(torch.square(outputs - bt["y"]))

    def residual_fn(p, bt):
        return model_fn(p, bt) - bt["y"]

    for solver in ("gauss_newton", "ggn"):
        hcfg = HFConfig(k=4, ell=8, cg_tol=1e-10, cg_maxiter=200, init_damping=0.1,
                        solver=solver)
        fns = (dict(residual_fn=residual_fn) if solver == "gauss_newton" else
               dict(model_fn=model_fn, loss_fn=loss_fn, loss_hvp=squared_loss_hvp))
        # One bootstrap basis for both devices, carried across by convert.
        boot = convert.hf_state_to_numpy(
            hf_init({"w": torch.tensor(w0)}, hcfg, torch.Generator().manual_seed(0)))
        gn = {}
        for dev in ("cuda", "cpu"):
            batch = {"x": torch.tensor(xs, device=dev),
                     "y": torch.tanh(torch.tensor(xs @ wt, device=dev))}
            params = {"w": torch.tensor(w0, device=dev)}
            state = convert.hf_state_from_numpy(**boot, dtype=torch.float64, device=dev)
            losses, its = [], []
            for _ in range(6):
                params, state, m = hf_step(params, state, batch, cfg=hcfg, **fns)
                losses.append(float(m["loss"]))
                its.append(int(m["cg_iterations"]))
            gn[dev] = {"loss": losses, "iterations": its}
        tag = f"[check-gn {solver}]"
        log(f"{tag} card loss {gn['cuda']['loss']} iterations {gn['cuda']['iterations']}; "
            f"CPU iterations {gn['cpu']['iterations']}")
        for a, b in zip(gn["cuda"]["loss"], gn["cpu"]["loss"]):
            if abs(a - b) > 1e-10 * abs(b):
                raise AssertionError(f"{tag} loss {gn['cuda']['loss']} vs CPU {gn['cpu']['loss']}")
        if gn["cuda"]["iterations"] != gn["cpu"]["iterations"]:
            raise AssertionError(f"{tag} iterations {gn['cuda']['iterations']} vs CPU "
                                 f"{gn['cpu']['iterations']}")
        out["gn" if solver == "gauss_newton" else "ggn"] = gn
    return out


def profile_lsmr_steps(torch, A, b, W=None, NW=None, steps=16):
    """``torch.profiler`` over ``steps`` LSMR iterations (tol 0, so every
    step is live): device kernels launched per iteration, and device time
    per iteration split into the two GEMVs and everything else."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import DenseMatrixOperator, lsmr

    op = DenseMatrixOperator(A)
    lsmr(op, b, W=W, NW=NW, damp=LSQ_DAMP, tol=0.0, maxiter=steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lsmr(op, b, W=W, NW=NW, damp=LSQ_DAMP, tol=0.0, maxiter=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, gemv_us, other_us, names = 0, 0.0, 0.0, {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if not (_is_device(evt) and us > 0):
            continue
        launches += evt.count
        key = evt.key.lower()
        if "gemv" in key or "gemm" in key:
            gemv_us += us
        else:
            other_us += us
        names[evt.key[:50]] = evt.count
    return {"steps": steps, "launches_per_iteration": launches / steps,
            "gemv_ms_per_iteration": gemv_us / steps / 1e3,
            "other_ms_per_iteration": other_us / steps / 1e3,
            "wall_ms_per_iteration_profiled": 1e3 * wall / steps, "kernels": names}


def phase_main_lsq(torch, cf, peaks):
    """The least-squares main path at m = 24 576, n = 16 384 (f64, 3.2 GB a
    system): cold LSMR per system and deflsmr(8, 48) over the drifting
    sequence, through the front door.  Every system must converge, the
    last x must match a Cholesky solve of AᵀA + λI, and K7, K4 and K5 must
    launch while no plain version runs.  The caller zeroes the counters."""
    m, n = LSQ_MAIN["m"], LSQ_MAIN["n"]
    from repro_torch.core import engine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    systems = list(drifting_lsq(torch, LSQ_MAIN["num"], m, n, "cuda"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    A0, b0 = systems[0]
    gemv_ms = device_ms(torch, lambda: A0 @ b0[:n])
    gemv_t_ms = device_ms(torch, lambda: A0.T @ b0)
    bound_ms = 2 * m * n * 8 / peaks["bytes"] * 1e3
    log(f"[main-lsq] m={m} n={n}: {len(systems)} systems built on the card in {build_s:.1f} s; "
        f"GEMV A v {gemv_ms:.4f} ms, Aᵀ u {gemv_t_ms:.4f} ms (bound of the pair "
        f"{bound_ms:.4f} ms)")

    runs, xs_cold, seq = lsq_runs(torch, systems, LSQ_MAIN["maxiter"], "[main-lsq]")
    for name, run in runs.items():
        if not all(run["converged"]):
            raise AssertionError(f"[main-lsq] {name}: a system did not converge")
        ell = 0 if name == "cold" else LSQ_ELL
        frozen = sum(frozen_steps(i, ell, engine.CHUNK) for i in run["iterations"])
        its = sum(run["iterations"])
        run.update(frozen_products=2 * frozen,
                   ms_per_iteration=1e3 * run["wall_s"] / its,
                   ms_per_step_run=1e3 * run["wall_s"] / (its + frozen))
        log(f"[main-lsq] {name:8s} {its} iterations, {sum(run['matvecs'])} A/Aᵀ products "
            f"counted, {2 * frozen} frozen products (computed, discarded), "
            f"{run['ms_per_iteration']:.3f} ms per iteration "
            f"({run['ms_per_step_run']:.3f} ms per step run; GEMV pair bound {bound_ms:.3f} ms)")
    A, b = systems[-1]
    N = A.T @ A
    N.diagonal().add_(LSQ_DAMP)
    x_ref = torch.cholesky_solve((A.T @ b)[:, None], torch.linalg.cholesky(N))[:, 0]
    del N
    gaps = {name: float(torch.linalg.norm(x - x_ref) / torch.linalg.norm(x_ref))
            for name, x in (("cold", xs_cold[-1]), ("recycled", seq.x[-1]))}
    log(f"[main-lsq] last system against Cholesky of AᵀA + λI: relative gap {gaps}")
    if max(gaps.values()) > 1e-5:
        raise AssertionError(f"[main-lsq] last x off the ridge solution: {gaps}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    saved = 1 - sum(runs["recycled"]["matvecs"]) / sum(runs["cold"]["matvecs"])
    log(f"[main-lsq] recycled vs cold A/Aᵀ products: {saved:+.1%} saved; peak memory "
        f"{peak_gb:.1f} GB")
    report = {"m": m, "n": n, "num": len(systems), "runs": runs,
              "gemv_ms": gemv_ms, "gemv_t_ms": gemv_t_ms, "gemv_pair_bound_ms": bound_ms,
              "cholesky_gap": gaps, "products_saved": saved, "peak_memory_gb": peak_gb,
              "build_systems_s": build_s}
    return report, systems, seq.state


def phase_main_gn(torch):
    """Gauss-Newton training (``hf_step`` with ``solver="gauss_newton"``) on
    the teacher-student residual at 65 536 samples, d = 1024, 32 outputs
    (32 768 parameters), f64, 10 steps with recycling and 10 without.  The
    loss must fall and stay finite.  The caller zeroes the counters."""
    from repro_torch.optim import HFConfig, hf_init, hf_step

    f64 = torch.float64
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(GN["samples"], GN["d"], generator=g, device="cuda", dtype=f64)
    x.mul_(math.sqrt(8.0 / GN["d"]))  # pre-activations at the test's scale
    y = torch.tanh(x @ torch.randn(GN["d"], GN["out"], generator=g, device="cuda", dtype=f64))
    w0 = torch.randn(GN["d"], GN["out"], generator=g, device="cuda", dtype=f64) * 0.1
    batch = {"x": x, "y": y}

    def residual_fn(p, bt):
        return torch.tanh(bt["x"] @ p["w"]) - bt["y"]

    out = {}
    for recycle in (True, False):
        cfg = HFConfig(k=4, ell=8, cg_tol=1e-6, cg_maxiter=200, init_damping=0.1,
                       solver="gauss_newton", recycle=recycle)
        params = {"w": w0.clone()}
        state = hf_init(params, cfg, torch.Generator(device="cuda").manual_seed(1))
        rows = []
        for _ in range(GN["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, mt = hf_step(params, state, batch, residual_fn=residual_fn, cfg=cfg)
            torch.cuda.synchronize()
            rows.append({"loss": float(mt["loss"]), "new_loss": float(mt["new_loss"]),
                         "damping": float(mt["damping"]), "accepted": bool(mt["accepted"]),
                         "iterations": int(mt["cg_iterations"]),
                         "matvecs": int(mt["cg_matvecs"]), "wall_s": time.perf_counter() - t0})
        name = "recycled" if recycle else "cold"
        its = sum(r["iterations"] for r in rows)
        wall = sum(r["wall_s"] for r in rows)
        out[name] = {"steps": rows, "iterations": its, "wall_s": wall,
                     "ms_per_iteration": 1e3 * wall / max(its, 1)}
        log(f"[main-gn] {name:8s} loss {rows[0]['loss']:.4e} -> {rows[-1]['new_loss']:.4e}; "
            f"LSMR iterations per step {[r['iterations'] for r in rows]}; "
            f"{wall:.2f} s, {out[name]['ms_per_iteration']:.3f} ms per LSMR iteration "
            f"(step included)")
        losses = [r["loss"] for r in rows] + [rows[-1]["new_loss"]]
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"[main-gn] {name}: loss did not fall: {losses}")
        out[name]["final_state"] = (params, state, cfg)
    return out, batch, residual_fn


def profile_gn_step(torch, params, state, batch, residual_fn, cfg):
    """``torch.profiler`` over one Gauss-Newton step: device kernels
    launched, device time by kernel class, and the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import hf_step

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = hf_step(params, state, batch, residual_fn=residual_fn, cfg=cfg)
        its = int(m["cg_iterations"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, gemm_us, other_us = 0, 0.0, 0.0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if not (_is_device(evt) and us > 0):
            continue
        launches += evt.count
        if "gemm" in evt.key.lower() or "gemv" in evt.key.lower():
            gemm_us += us
        else:
            other_us += us
    busy = (gemm_us + other_us) / 1e3
    return {"iterations": its, "launches": launches, "gemm_ms": gemm_us / 1e3,
            "other_ms": other_us / 1e3, "wall_ms_profiled": 1e3 * wall,
            "device_busy_share": busy / (1e3 * wall)}


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
    kernels["lsmr_update"] = phase_lsmr_kernels(torch, cf, peaks)

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
    if not all(mf_launches[k] for k in MF_PATH_KERNELS):
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

    del ka, xa, ya, x, y, xc, yc
    torch.cuda.empty_cache()

    # -- 9. least squares at lsq_bench's size: card against CPU --------------
    report["check_lsq"] = phase_check_lsq(torch, cf)

    # -- 10. the least-squares main path ----------------------------------------
    zero_counts()
    lsq, lsq_systems, lsq_state = phase_main_lsq(torch, cf, peaks)
    lsq_launches = dict(cf.LAUNCHES)
    lsq_plain = dict(cf.PLAIN_ON_CUDA)
    log(f"[main-lsq] launches {lsq_launches}; plain versions on the card {lsq_plain}")
    if not all(lsq_launches[k] for k in LSQ_PATH_KERNELS):
        raise AssertionError(f"[main-lsq] a kernel never launched: {lsq_launches}")
    if any(lsq_plain.values()):
        raise AssertionError(f"[main-lsq] plain versions ran on the card: {lsq_plain}")
    # Launches per LSMR iteration (eager PyTorch: every scalar op is one),
    # counted apart from the main path's run.
    lsq["profile"] = {
        "cold": profile_lsmr_steps(torch, *lsq_systems[0]),
        "deflated": profile_lsmr_steps(torch, *lsq_systems[-1], W=lsq_state.W, NW=lsq_state.AW),
    }
    for name, prof in lsq["profile"].items():
        log(f"[main-lsq] profile {name}: {prof['launches_per_iteration']:.1f} launches per "
            f"iteration; device {prof['gemv_ms_per_iteration']:.4f} ms GEMV + "
            f"{prof['other_ms_per_iteration']:.4f} ms other per iteration; wall "
            f"{prof['wall_ms_per_iteration_profiled']:.4f} ms per iteration under the profiler")
    report["main_lsq"] = lsq
    del lsq_systems, lsq_state
    torch.cuda.empty_cache()

    # -- 11. Gauss-Newton training ---------------------------------------------
    zero_counts()
    report["main_gn"], gn_batch, gn_residual = phase_main_gn(torch)
    gn_launches = dict(cf.LAUNCHES)
    gn_plain = dict(cf.PLAIN_ON_CUDA)
    log(f"[main-gn] launches {gn_launches}; plain versions on the card {gn_plain}")
    if not all(gn_launches[k] for k in GN_PATH_KERNELS):
        raise AssertionError(f"[main-gn] a kernel never launched: {gn_launches}")
    if any(gn_plain.values()):
        raise AssertionError(f"[main-gn] plain versions ran on the card: {gn_plain}")
    report["main_gn"]["launches"] = gn_launches
    # One more step of the recycled run under the profiler, counted apart.
    gn_params, gn_state, gn_cfg = report["main_gn"]["recycled"].pop("final_state")
    prof = profile_gn_step(torch, gn_params, gn_state, gn_batch, gn_residual, gn_cfg)
    report["main_gn"]["cold"].pop("final_state")
    report["main_gn"]["profile"] = prof
    log(f"[main-gn] profile of one more recycled step: {prof['iterations']} LSMR iterations, "
        f"{prof['launches']} device launches, device {prof['gemm_ms']:.2f} ms GEMM + "
        f"{prof['other_ms']:.2f} ms other, wall {prof['wall_ms_profiled']:.2f} ms under the "
        f"profiler (device busy {prof['device_busy_share']:.0%})")

    totals = {name: launches[name] + mf_launches[name] + lsq_launches[name] + gn_launches[name]
              for name in cf.LAUNCHES}
    report["launch_totals"] = totals
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
