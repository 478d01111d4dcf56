#!/usr/bin/env python3
"""The iteration-tail kernels K1, K6, K2, K7 and the loops they end, timed
on the card.

Measures one tree of the port (``--src``, default this tree's ``src``):

* K1 (``fused_cg_update``) at n = 36 551, k = 8, f64: the TPU-function
  arm and, where the tree has it, the def-CG step arm
  (``fused_cg_step_cuda``); K6 (``fused_rz_reduce``) at the same shape:
  the AW and no-AW arms and, where the tree has them, the step arm
  (``fused_rz_step_cuda``) and the pair arm (``fused_rz_pair_cuda``, at
  main-shard's per-rank n = 4 096; beside it the two one-vector calls it
  replaces); K2 (``fused_deflate_direction``): the TPU-function arm with
  and without recording and, where the tree has it, the step arm
  (``fused_direction_step_cuda``) at k = 8, recording and not, and at
  k = 0; K7 (``lsmr_update``) at n = 16 384, 32 768 and 2²⁰ in f64 and
  2²⁰ in f32: the TPU-function arm and the LSMR step arm
  (``lsmr_step_cuda``); K1's and K7's step arms also armed with the stall
  detector (``window=4``) where the tree has it.  Each the median of 25
  CUDA-event timings with
  the L2 evicted before each call (``chip_smoke.device_ms``), with the
  device kernels one call launches (``torch.profiler``);
* deflated def-CG (k = 8) on the dense main path's Newton system at
  n = 36 551 (the digits data, K formed on the card), without and with
  the Jacobi preconditioner: ``chip_smoke.profile_defcg_steps`` and
  ``profile_pdefcg_steps`` (launches and device time per iteration, 16
  steps), then the wall time per iteration of 64 live steps (tol 0),
  unprofiled;
* damped LSMR (λ = 1e-4) on the least-squares main path's first system
  (24 576 × 16 384, ``chip_smoke.drifting_lsq``): ``profile_lsmr_steps``
  cold and deflated (a random orthonormal W with NW = (AᵀA + λI)W), then
  the wall time per iteration of 256 live cold steps, unprofiled;
* Gauss-Newton training (``chip_smoke.GN``'s residual): three recycled
  ``hf_step``s, then ``chip_smoke.profile_gn_step`` over a fourth (device
  busy share, launches, ms per LSMR iteration), then five more unprofiled
  (``gn_wall``: wall ms per LSMR iteration);
* ``digests``: SHA-256 of the outputs of K1's and K7's window-0 step arms
  on seeded inputs and of the 64-step def-CG and 256-step LSMR iterates
  above, so two trees' outputs compare bit for bit.

To compare two trees on one card, run this script from one tree against
both, in turns (the package is imported from ``--src`` before
``chip_smoke``, and each tree builds its kernels under its own
``build/``)::

    git archive <parent> | tar -x -C build/parent
    python tools/step_times.py --label parent --src build/parent/src
    python tools/step_times.py --label change
    python tools/step_times.py --label change
    python tools/step_times.py --label parent --src build/parent/src

Needs a CUDA card and ``nvcc``; about a minute a run after the build.
The last line is a JSON object.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="change")
    parser.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("step_times: no CUDA device available", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.core import DenseMatrixOperator, KernelSystemOperator, defcg, jacobi, lsmr
    from repro_torch.data import make_infinite_digits
    from repro_torch.gp import RBFKernel
    from repro_torch.kernels import cg_fused as cf
    from repro_torch.optim import HFConfig, hf_init, hf_step

    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"label": args.label, "package": os.path.dirname(repro_torch.__file__), "card": card}
    print(f"[{args.label}] {card}; package {out['package']}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    f64, f32 = torch.float64, torch.float32
    # Each section draws from its own generator: the trees see the same data.
    g = torch.Generator(device="cuda")

    def rnd(*shape, dtype=f64):
        return torch.randn(*shape, generator=g, device="cuda", dtype=dtype)

    out["digests"] = {}

    def digest(name, tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        out["digests"][name] = h.hexdigest()[:16]

    def timed(name, fn):
        out[name] = {"ms": cs.device_ms(torch, fn), "kernels_per_call": cs.kernels_per_call(torch, fn)}
        print(f"[{args.label}] {name}: {out[name]['ms']:.5f} ms, "
              f"{out[name]['kernels_per_call']:.1f} device kernels a call", flush=True)

    # -- K1 ---------------------------------------------------------------------
    g.manual_seed(1)
    n, k = cs.PAPER_N, cs.K
    x, r, p, ap = (rnd(n) for _ in range(4))
    aw, waw_inv = rnd(k, n), rnd(k, k)
    alpha = torch.tensor(0.3, dtype=f64, device="cuda")
    timed(f"K1 tpu arm f64 n={n} k={k}", lambda: cf.fused_cg_update_cuda(x, r, p, ap, alpha, aw))
    if hasattr(cf, "fused_cg_step_cuda"):
        d = torch.dot(p, ap).abs() + 1.0
        rs = torch.dot(r, r)
        rnorm = torch.sqrt(rs)
        js = torch.tensor([2, 0], dtype=torch.int32, device="cuda")
        on = torch.tensor(True, device="cuda")
        thr, div = (torch.tensor(v, dtype=f64, device="cuda") for v in (1e-6, 1e8))
        timed(f"K1 step arm f64 n={n} k={k}", lambda: cf.fused_cg_step_cuda(
            x, r, p, ap, d, rs, rnorm, js, on, thr, div, 100, aw, waw_inv))
        digest("K1 step arm", cf.fused_cg_step_cuda(
            x, r, p, ap.clone(), d, rs, rnorm, js, on, thr, div, 100, aw, waw_inv))
        if "window" in inspect.signature(cf.fused_cg_step_cuda).parameters:
            js3 = torch.tensor([2, 0, 1], dtype=torch.int32, device="cuda")
            timed(f"K1 step arm armed f64 n={n} k={k}", lambda: cf.fused_cg_step_cuda(
                x, r, p, ap, d, rs, rnorm, js3, on, thr, div, 100, aw, waw_inv, window=4,
                best=rnorm))

    # -- K6 and K2 -------------------------------------------------------------
    g.manual_seed(5)
    z, p = rnd(n), rnd(n)
    timed(f"K6 aw arm f64 n={n} k={k}", lambda: cf.fused_rz_reduce_cuda(r, z, aw))
    timed(f"K6 no-aw arm f64 n={n}", lambda: cf.fused_rz_reduce_cuda(r, z))
    n_loc = cs.SHARD_N // cs.SHARD_RANKS
    r4, ap4, aw4 = r[:n_loc], ap[:n_loc], aw[:, :n_loc].contiguous()
    timed(f"K6 two one-vector calls f64 n={n_loc} k={k}", lambda: (
        cf.fused_rz_reduce_cuda(r4, ap4, aw4), cf.fused_rz_reduce_cuda(r4, r4, aw4)))
    if hasattr(cf, "fused_rz_step_cuda"):
        rs = torch.dot(r, r)
        timed(f"K6 step arm f64 n={n} k={k}", lambda: cf.fused_rz_step_cuda(r, z, rs, aw, waw_inv))
        timed(f"K6 pair arm f64 n={n_loc} k={k}", lambda: cf.fused_rz_pair_cuda(r4, ap4, aw4))
    beta, mu, w = rnd(()), rnd(k), rnd(k, n)
    bufs = (torch.zeros(13, n, dtype=f64, device="cuda"),
            torch.zeros(13, n, dtype=f64, device="cuda"))
    idx = torch.tensor(5, device="cuda")
    timed(f"K2 tpu arm f64 n={n} k={k}", lambda: cf.fused_deflate_direction_cuda(z, p, beta, w, mu))
    timed(f"K2 tpu arm recording f64 n={n} k={k}", lambda: cf.fused_deflate_direction_cuda(
        z, p, beta, w, mu, ap, idx, *bufs))
    timed(f"K2 k=0 beside torch.addcmul f64 n={n}", lambda: torch.addcmul(z, beta, p))
    if hasattr(cf, "fused_direction_step_cuda"):
        on = torch.tensor(True, device="cuda")
        timed(f"K2 step arm f64 n={n} k={k}", lambda: cf.fused_direction_step_cuda(
            z, p, beta, on, w, mu))
        timed(f"K2 step arm recording f64 n={n} k={k}", lambda: cf.fused_direction_step_cuda(
            z, p, beta, on, w, mu, ap=ap, active=on, row=5, p_buf=bufs[0], ap_buf=bufs[1]))
        timed(f"K2 step arm f64 n={n} k=0", lambda: cf.fused_direction_step_cuda(z, p, beta, on))

    # -- K7 ---------------------------------------------------------------------
    for n, dtype in ((16384, f64), (32768, f64), (1 << 20, f64), (1 << 20, f32)):
        g.manual_seed(n)
        dname = str(dtype).split(".")[-1]
        x, hbar, h, v, w = (rnd(n, dtype=dtype) for _ in range(5))
        c = [torch.tensor(q, dtype=dtype, device="cuda") for q in (0.5, -0.25, 2.0)]
        timed(f"K7 tpu arm {dname} n={n}", lambda: cf.lsmr_update_cuda(x, hbar, h, v, *c))
        if hasattr(cf, "lsmr_step_cuda"):
            s = rnd(7, dtype=dtype).abs() + 0.1
            js = torch.tensor([2, 0], dtype=torch.int32, device="cuda")
            on = torch.tensor(True, device="cuda")
            thr, div = (torch.tensor(q, dtype=dtype, device="cuda") for q in (1e-6, 1e8))
            wsq, beta = torch.dot(w, w), rnd((), dtype=dtype).abs()
            timed(f"K7 step arm {dname} n={n}", lambda: cf.lsmr_step_cuda(
                x, hbar, h, v, w, wsq, beta, s, js, on, thr, div, 100))
            digest(f"K7 step arm {dname} n={n}", cf.lsmr_step_cuda(
                x, hbar, h, v, w, wsq, beta, s, js, on, thr, div, 100))
            if "window" in inspect.signature(cf.lsmr_step_cuda).parameters:
                s8 = torch.cat([s, s[1:2]])
                js3 = torch.tensor([2, 0, 1], dtype=torch.int32, device="cuda")
                timed(f"K7 step arm armed {dname} n={n}", lambda: cf.lsmr_step_cuda(
                    x, hbar, h, v, w, wsq, beta, s8, js3, on, thr, div, 100, window=4))

    # -- deflated def-CG on the dense GP system ---------------------------------------
    xd, _ = make_infinite_digits(cs.PAPER_N, seed=0, noise=0.10)
    xd = torch.as_tensor(xd, dtype=f64, device="cuda")
    k_dense = RBFKernel(theta=cs.THETA, lengthscale=cs.LENGTHSCALE).gram(xd)
    half = torch.full((cs.PAPER_N,), 0.5, dtype=f64, device="cuda")
    op = KernelSystemOperator(lambda u: k_dense @ u, half)
    g.manual_seed(2)
    b = rnd(cs.PAPER_N)
    W = torch.linalg.qr(rnd(cs.PAPER_N, cs.K)).Q.T.contiguous()
    AW = op.basis_matvec(W)
    for key, profiler, M in (
        ("defcg", cs.profile_defcg_steps, None),
        ("pdefcg", cs.profile_pdefcg_steps, jacobi(1.0 + half * half * torch.diagonal(k_dense))),
    ):
        out[f"{key}_profile"] = prof = profiler(torch, k_dense)
        defcg(op, b, W=W, AW=AW, tol=0.0, maxiter=8, M=M)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = defcg(op, b, W=W, AW=AW, tol=0.0, maxiter=64, M=M)
        torch.cuda.synchronize()
        digest(f"{key} 64 steps", (res.x,))
        ms = out[f"{key}_ms_per_iteration"] = (
            1e3 * (time.perf_counter() - t0) / int(res.info.iterations))
        print(f"[{args.label}] def-CG n={cs.PAPER_N}{' Jacobi' if M is not None else ''}: "
              f"{prof['launches_per_iteration']:.1f} launches per iteration, device "
              f"{prof['gemv_ms_per_iteration']:.4f} ms GEMV + "
              f"{prof['other_ms_per_iteration']:.4f} ms other; {ms:.4f} ms per iteration "
              "unprofiled", flush=True)
    del k_dense, op, W, AW
    torch.cuda.empty_cache()

    # -- damped LSMR on the least-squares main path's first system ---------------------
    m, n = cs.LSQ_MAIN["m"], cs.LSQ_MAIN["n"]
    A, b = next(cs.drifting_lsq(torch, 1, m, n, "cuda"))
    g.manual_seed(3)
    W = torch.linalg.qr(torch.randn(n, cs.LSQ_K, generator=g, device="cuda", dtype=f64)).Q.T
    W = W.contiguous()
    NW = (A @ W.T).T @ A + cs.LSQ_DAMP * W
    out["lsmr_profile"] = {"cold": cs.profile_lsmr_steps(torch, A, b),
                           "deflated": cs.profile_lsmr_steps(torch, A, b, W=W, NW=NW)}
    opA = DenseMatrixOperator(A)
    lsmr(opA, b, damp=cs.LSQ_DAMP, tol=0.0, maxiter=8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = lsmr(opA, b, damp=cs.LSQ_DAMP, tol=0.0, maxiter=256)
    torch.cuda.synchronize()
    digest("lsmr 256 steps", (res.x,))
    out["lsmr_ms_per_iteration"] = 1e3 * (time.perf_counter() - t0) / int(res.info.iterations)
    for name, pr in out["lsmr_profile"].items():
        print(f"[{args.label}] LSMR {name}: {pr['launches_per_iteration']:.1f} launches per "
              f"iteration, device {pr['gemv_ms_per_iteration']:.4f} ms GEMV + "
              f"{pr['other_ms_per_iteration']:.4f} ms other", flush=True)
    print(f"[{args.label}] LSMR cold: {out['lsmr_ms_per_iteration']:.4f} ms per iteration "
          "unprofiled", flush=True)
    del A, b, W, NW, opA
    torch.cuda.empty_cache()

    # -- Gauss-Newton training ------------------------------------------------------
    gn = cs.GN
    g.manual_seed(4)
    x = torch.randn(gn["samples"], gn["d"], generator=g, device="cuda", dtype=f64)
    x.mul_(math.sqrt(8.0 / gn["d"]))
    y = torch.tanh(x @ torch.randn(gn["d"], gn["out"], generator=g, device="cuda", dtype=f64))
    params = {"w": torch.randn(gn["d"], gn["out"], generator=g, device="cuda", dtype=f64) * 0.1}
    batch = {"x": x, "y": y}

    def residual_fn(pr, bt):
        return torch.tanh(bt["x"] @ pr["w"]) - bt["y"]

    cfg = HFConfig(k=4, ell=8, cg_tol=1e-6, cg_maxiter=200, init_damping=0.1,
                   solver="gauss_newton", recycle=True)
    state = hf_init(params, cfg, torch.Generator(device="cuda").manual_seed(1))
    for _ in range(3):
        params, state, _ = hf_step(params, state, batch, residual_fn=residual_fn, cfg=cfg)
    out["gn_profile"] = gp = cs.profile_gn_step(torch, params, state, batch, residual_fn, cfg)
    gp["ms_per_lsmr_iteration_profiled"] = gp["wall_ms_profiled"] / max(gp["iterations"], 1)
    print(f"[{args.label}] main-gn step: {gp['iterations']} LSMR iterations, {gp['launches']} "
          f"launches, device busy {gp['device_busy_share']:.1%}, "
          f"{gp['ms_per_lsmr_iteration_profiled']:.3f} ms per LSMR iteration under the profiler",
          flush=True)
    # Unprofiled: five more recycled steps, wall time per LSMR iteration.
    torch.cuda.synchronize()
    t0, its = time.perf_counter(), 0
    for _ in range(5):
        params, state, m = hf_step(params, state, batch, residual_fn=residual_fn, cfg=cfg)
        its += int(m["cg_iterations"])
    torch.cuda.synchronize()
    out["gn_wall"] = {"steps": 5, "iterations": its,
                      "ms_per_lsmr_iteration": 1e3 * (time.perf_counter() - t0) / max(its, 1)}
    print(f"[{args.label}] main-gn, 5 steps unprofiled: {its} LSMR iterations, "
          f"{out['gn_wall']['ms_per_lsmr_iteration']:.3f} ms per LSMR iteration", flush=True)
    for pr in (out["defcg_profile"], out["pdefcg_profile"], *out["lsmr_profile"].values()):
        pr.pop("kernels")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
