#!/usr/bin/env python3
"""Times of the redesigned kernels on the card: K9, K4, K5, K3, K8 and K10.

Times the kernels of the tree this script lives in, at the main paths'
shapes, beside the one PyTorch call that computes the same function (or
the plain version where there is none):

* K9 (``flash_attention``) in bf16 at qwen1.5-0.5b's prefill (4 × 16
  heads × 4 096, dh 64, causal) and at 32 768 tokens (b 1), and in f32 at
  the prefill shape, beside ``scaled_dot_product_attention``;
* K4 (``self_gram``) at 112 rows × 16 384 and 40 rows × 36 551, f64 and
  f32, beside ``S @ S.T``;
* K5 (``recombine_blocks``) at the same windows (u: m × 8), f64 and f32,
  beside the batched ``uᵀ @ S`` and ``S.sum()`` (a PyTorch read of the
  same bytes after the same L2 flush);
* K3 (``rbf_matvec``) at n = 36 551, d = 784, f64 r = 1, 8, 24 and f32
  r = 1, beside ``rbf_matvec_plain``, and in f64 r = 1 the same tile on
  the full grid without symmetry (K8's entry on the same X), and at d =
  16 and 256: the time is linear in d, so these split it into the
  cross term's cost per feature and a fixed part (epilogue, refills);
  then at the scale phase's n = 131 072, f64 r = 1 (symmetric) and r = 24
  (past the scratch budget, so on the full grid), and r = 24 once more in
  the symmetric mode with the budget lifted (8.6 GB of column scratch);
* K8 (``rbf_matvec_rect``) at 4 096 × 16 384, f64 and f32, r = 1;
* K10 (``ssd_scan``) at mamba2-1.3b's prefill (``chip_smoke.SSD_MAIN``),
  bf16 and f32, without and with the state in and out, beside
  ``ssd_plain``, the D skip as ``y + x·d`` and as one ``addcmul`` (times
  and their largest gap); with the ptxas registers and spills of each of its
  kernels (a build of ``csrc/ssd_scan.cu`` with ``-Xptxas -v`` into a
  temporary directory); and its training arms (backward, forward-mode
  tangent) at mamba2-1.3b's training shape (``chip_smoke.SSD_TRAIN``),
  bf16 and f32, with each of their kernels' times from the profiler.

Each time is the median of 25 CUDA-event timings (3 for K3, K8 and K9 at
32 768 tokens, 1 for K3 at n = 131 072) with the L2 evicted before each call
(``chip_smoke.device_ms``).  Then it counts the tensor-core instructions
(HMMA, DMMA) in the built libraries' SASS with ``cuobjdump``, where the
toolkit has it.  The last line is a JSON object.

To compare two trees on one card, copy this script into the other tree's
``tools/`` and run both in one call, in turns:

    PYTHONPATH=src python tools/kernel_times.py --label change
    python <other tree>/tools/kernel_times.py --label parent

``--only k3 k5`` times those sections alone (``--only k10`` K10 alone, a
few seconds of card time after the build).  Needs a CUDA card and
``nvcc``; takes about two minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import cg_fused as cf  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rbf_matvec as rbf  # noqa: E402

GRAM_SHAPES = ((112, 16384), (40, 36551))
SECTIONS = ("k9", "k4", "k5", "k3", "k8", "k10")
SCALE_RS = (1, 24)


def sass_counts(name: str) -> dict:
    """Tensor-core instructions per kernel symbol in ``csrc/<name>.cu``'s
    built library: ``{symbol: {"HMMA": n, "DMMA": n}}``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {"error": "cuobjdump not found"}
    text = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        for op in ("HMMA", "DMMA"):
            if fn and re.search(rf"\b{op}\b", line):
                counts.setdefault(fn, {}).setdefault(op, 0)
                counts[fn][op] += 1
    return counts


def ptxas_report(name: str) -> dict:
    """Registers and spill bytes per kernel of ``csrc/<name>.cu``, from a
    fresh ``nvcc -Xptxas -v`` build into a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(Path(tmp) / "lib.so"),
               str(_build.CSRC / f"{name}.cu")]
        run = subprocess.run(cmd, capture_output=True, text=True, check=True)
        log = run.stdout + run.stderr
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line) or re.search(
            r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if fn and m:
            out.setdefault(fn, {})["spill_stores"] = int(m.group(1))
            out[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if fn and m:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    return out


def time_ssd(label: str) -> dict:
    from repro_torch.kernels import ssd_scan as ss

    out = {}
    b, l, h, p, g, n, c = cs.SSD_MAIN
    nbytes, ops = cs.ssd_work(b, l, h, p, g, n, c, 2)
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, a, bm, cm, d, h0 = cs.ssd_inputs(torch, b, l, h, p, g, n, dtype, seed=2)
        t = {"ms": cs.device_ms(torch, lambda: ss.ssd_scan_cuda(x, dt, a, bm, cm, d, chunk=c)),
             "stateful_ms": cs.device_ms(torch, lambda: ss.ssd_scan_cuda(
                 x, dt, a, bm, cm, d, chunk=c, initial_state=h0, return_state=True)),
             "plain_ms": cs.device_ms(torch, lambda: ss.ssd_plain(x, dt, a, bm, cm, d, chunk=c),
                                      5)}
        want = ss.ssd_plain(x, dt, a, bm, cm, d, chunk=c, initial_state=h0, return_state=True)
        got = ss.ssd_scan_cuda(x, dt, a, bm, cm, d, chunk=c, initial_state=h0, return_state=True)
        t["max_abs_err"] = [float((u.float() - w.float()).abs().max()) for u, w in zip(got, want)]
        t["tflop_s"] = ops / t["ms"] / 1e9
        t["profiled_kernels_ms"] = cs.profile_kernels(
            torch, lambda: ss.ssd_scan_cuda(x, dt, a, bm, cm, d, chunk=c))
        if dtype == torch.bfloat16 and hasattr(ss, "HEADS_PER_BLOCK"):
            base = ss.HEADS_PER_BLOCK
            t["heads_per_block_ms"] = {}
            try:
                for hpb in (1, 2, 4, 8, 16):
                    ss.HEADS_PER_BLOCK = hpb
                    t["heads_per_block_ms"][hpb] = cs.device_ms(
                        torch, lambda: ss.ssd_scan_cuda(x, dt, a, bm, cm, d, chunk=c))
            finally:
                ss.HEADS_PER_BLOCK = base
        if dtype == torch.bfloat16:  # the D skip: _skip's two kernels, the wrapper's addcmul
            yk = ss.ssd_scan_cuda(x, dt, a, bm, cm, None, chunk=c)
            t["skip_ms"] = cs.device_ms(torch, lambda: ss._skip(yk, x, d))
            t["skip_addcmul_ms"] = cs.device_ms(torch, lambda: torch.addcmul(
                yk, x, d[None, None, :, None]))
            t["skip_addcmul_max_abs_diff"] = float(
                (ss._skip(yk, x, d) - torch.addcmul(yk, x, d[None, None, :, None])).abs().max())
            t["without_skip_ms"] = cs.device_ms(torch, lambda: ss.ssd_scan_cuda(
                x, dt, a, bm, cm, None, chunk=c))
        key = f"ssd_scan {str(dtype)[6:]} {cs.SSD_MAIN}"
        out[key] = t
        print(f"[{label}] {key}: {t['ms']:.4f} ms ({t['tflop_s']:.1f} TFLOP/s), with state in "
              f"and out {t['stateful_ms']:.4f} ms, plain {t['plain_ms']:.3f} ms (max abs err "
              f"y, state {t['max_abs_err'][0]:.2e}, {t['max_abs_err'][1]:.2e}); profiler "
              f"{t['profiled_kernels_ms']}"
              + (f"; heads per block: {t['heads_per_block_ms']} ms"
                 if "heads_per_block_ms" in t else "")
              + (f"; without the D skip {t['without_skip_ms']:.4f} ms; the skip as y + x·d "
                 f"{t['skip_ms']:.4f} ms, as addcmul {t['skip_addcmul_ms']:.4f} ms (max abs "
                 f"gap {t['skip_addcmul_max_abs_diff']:.2e})"
                 if "skip_ms" in t else ""), flush=True)
        del x, dt, a, bm, cm, d, h0, got, want
    # The training arms at mamba2-1.3b's training shape: each arm's time and
    # each of its kernels' (profiler), bf16 and f32.
    b, l, h, p, g, n, c = cs.SSD_TRAIN
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, a, bm, cm, _, _ = cs.ssd_inputs(torch, b, l, h, p, g, n, dtype, seed=2)
        gen = torch.Generator(device="cuda").manual_seed(3)
        rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")  # noqa: E731
        dy, tx = rnd(b, l, h, p).to(dtype), rnd(b, l, h, p).to(dtype)
        tb, tc = rnd(b, l, g, n).to(dtype), rnd(b, l, g, n).to(dtype)
        tdt, ta = 0.1 * rnd(b, l, h), 0.1 * rnd(h)
        _, _, hs, css = ss.ssd_scan_fwd_cuda(x, dt, a, bm, cm, chunk=c)
        arms = {"bwd": lambda: ss.ssd_scan_bwd_cuda(dy, x, dt, a, bm, cm, None, hs, css, chunk=c),
                "jvp": lambda: ss.ssd_scan_jvp_cuda(x, dt, a, bm, cm, None, hs, css, tx, tdt, ta,
                                                    tb, tc, chunk=c)}
        for arm, fn in arms.items():
            t = {"ms": cs.device_ms(torch, fn), "profiled_kernels_ms": cs.profile_kernels(torch, fn)}
            key = f"ssd_scan:{arm} {str(dtype)[6:]} {cs.SSD_TRAIN}"
            out[key] = t
            print(f"[{label}] {key}: {t['ms']:.4f} ms; profiler {t['profiled_kernels_ms']}",
                  flush=True)
        del x, dt, a, bm, cm, dy, tx, tb, tc, tdt, ta, hs, css
    out["ptxas"] = ptxas_report("ssd_scan")
    print(f"[{label}] ssd_scan ptxas: {out['ptxas']}", flush=True)
    return out


def time_recombine(label: str) -> dict:
    out = {}
    for dtype in (torch.float64, torch.float32):
        for rows, n in GRAM_SHAPES:
            g = torch.Generator(device="cuda").manual_seed(rows + n)
            s = torch.randn(rows, n, generator=g, device="cuda", dtype=dtype)
            u = torch.randn(rows // 2, cs.K, generator=g, device="cuda", dtype=dtype)
            ut = u.T.contiguous()
            want = cf.recombine_blocks_plain(s, u)
            t = {"ms": cs.device_ms(torch, lambda: cf.recombine_blocks_cuda(s, u)),
                 "library_ms": cs.device_ms(torch, lambda: torch.matmul(
                     ut, s.view(2, rows // 2, n))),
                 "plain_ms": cs.device_ms(torch, lambda: cf.recombine_blocks_plain(s, u)),
                 "read_ms": cs.device_ms(torch, lambda: s.sum()),
                 "max_abs_err": float((cf.recombine_blocks_cuda(s, u) - want).abs().max())}
            key = f"{str(dtype)[6:]} {rows}x{n}"
            out[key] = t
            print(f"[{label}] recombine_blocks {key}: {t['ms']:.4f} ms"
                  f", batched u^T @ S {t['library_ms']:.4f} ms, S.sum() {t['read_ms']:.4f} ms, "
                  f"plain {t['plain_ms']:.4f} ms "
                  f"(max abs err {t['max_abs_err']:.2e})", flush=True)
    return out


def time_rbf(label: str) -> dict:
    out = {}
    ls, theta = cs.LENGTHSCALE, cs.THETA
    for dtype, r in ((torch.float64, 1), (torch.float64, cs.K), (torch.float64, 24),
                     (torch.float32, 1)):
        x, v = cs.rbf_inputs(torch, cs.PAPER_N, cs.D, r, dtype, seed=r)
        _, ops = cs.rbf_work(cs.PAPER_N, cs.D, r, x.element_size())
        t = {"ms": cs.device_ms(torch, lambda: rbf.rbf_matvec_cuda(x, v, theta, ls),
                                cs.RBF_REPS),
             "plain_ms": cs.device_ms(torch, lambda: rbf.rbf_matvec_plain(
                 x, v, theta, ls, cs.BLOCK), cs.RBF_REPS)}
        t["tflop_s"] = ops / t["ms"] / 1e9
        if dtype == torch.float64 and r == 1:
            t["full_grid_ms"] = cs.device_ms(
                torch, lambda: rbf.rbf_matvec_rect_cuda(x, x, v, theta, ls), cs.RBF_REPS)
        if dtype == torch.float64 and r == 1:
            for d in (16, 256):
                xd, vd = cs.rbf_inputs(torch, cs.PAPER_N, d, 1, dtype, seed=d)
                t[f"d{d}_ms"] = cs.device_ms(
                    torch, lambda: rbf.rbf_matvec_cuda(xd, vd, theta, ls), cs.RBF_REPS)
            per = (t["ms"] - t["d256_ms"]) / (cs.D - 256)
            t["ms_per_feature"], t["fixed_ms"] = per, t["ms"] - per * cs.D
        key = f"rbf_matvec {str(dtype)[6:]} n={cs.PAPER_N} r={r}"
        out[key] = t
        print(f"[{label}] {key}: {t['ms']:.2f} ms ({t['tflop_s']:.1f} TFLOP/s on the "
              f"symmetric work), plain {t['plain_ms']:.2f} ms"
              + (f", full grid without symmetry {t['full_grid_ms']:.2f} ms; d = 16 / 256: "
                 f"{t['d16_ms']:.2f} / {t['d256_ms']:.2f} ms, so {t['ms_per_feature']:.4f} ms "
                 f"a feature + {t['fixed_ms']:.2f} ms fixed" if "full_grid_ms" in t else ""),
              flush=True)
        del x, v
    for r in SCALE_RS if hasattr(rbf, "_symmetric") else ():
        x, v = cs.rbf_inputs(torch, cs.SCALE_N, cs.D, r, torch.float64, seed=r)
        t = {"symmetric": rbf._symmetric(cs.SCALE_N, rbf.sym_lengths(cs.SCALE_N // rbf.TILE),
                                         r, 8),
             "ms": cs.device_ms(torch, lambda: rbf.rbf_matvec_cuda(x, v, theta, ls), 1),
             "plain_ms": cs.device_ms(torch, lambda: rbf.rbf_matvec_plain(
                 x, v, theta, ls, cs.BLOCK), 1)}
        if not t["symmetric"]:
            budget, rbf.SCRATCH_BYTES = rbf.SCRATCH_BYTES, 1 << 40
            try:
                t["symmetric_unbudgeted_ms"] = cs.device_ms(
                    torch, lambda: rbf.rbf_matvec_cuda(x, v, theta, ls), 1)
            finally:
                rbf.SCRATCH_BYTES = budget
        key = f"rbf_matvec float64 n={cs.SCALE_N} r={r}"
        out[key] = t
        print(f"[{label}] {key}: {t['ms']:.1f} ms "
              f"({'symmetric' if t['symmetric'] else 'full grid'}), plain "
              f"{t['plain_ms']:.1f} ms"
              + (f", symmetric with the scratch budget lifted "
                 f"{t['symmetric_unbudgeted_ms']:.1f} ms" if "symmetric_unbudgeted_ms" in t
                 else ""), flush=True)
        del x, v
    return out


def time_rect(label: str) -> dict:
    out = {}
    m, n = cs.K8_SHAPES[0]
    for dtype in (torch.float64, torch.float32):
        g = torch.Generator(device="cuda").manual_seed(1)
        xr = torch.rand((m, cs.D), generator=g, device="cuda", dtype=dtype)
        xc = torch.rand((n, cs.D), generator=g, device="cuda", dtype=dtype)
        v = torch.randn((n, 1), generator=g, device="cuda", dtype=dtype)
        _, ops = cs.rect_work(m, n, cs.D, 1, xr.element_size())
        t = {"ms": cs.device_ms(torch, lambda: rbf.rbf_matvec_rect_cuda(
                 xr, xc, v, cs.THETA, cs.LENGTHSCALE), cs.RBF_REPS),
             "plain_ms": cs.device_ms(torch, lambda: rbf.rbf_matvec_rect_plain(
                 xr, xc, v, cs.THETA, cs.LENGTHSCALE, cs.BLOCK), cs.RBF_REPS)}
        t["tflop_s"] = ops / t["ms"] / 1e9
        key = f"rbf_matvec_rect {str(dtype)[6:]} {m}x{n} r=1"
        out[key] = t
        print(f"[{label}] {key}: {t['ms']:.3f} ms ({t['tflop_s']:.1f} TFLOP/s), plain "
              f"{t['plain_ms']:.3f} ms", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=str(ROOT))
    ap.add_argument("--only", nargs="+", choices=SECTIONS, default=SECTIONS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build(["flash_attention", "cg_fused", "rbf_matvec", "ssd_scan"])
    out = {"label": args.label, "card": card, "flash_attention": {}, "self_gram": {}}
    if "k10" in args.only:
        out["ssd_scan"] = time_ssd(args.label)
    if "k5" in args.only:
        out["recombine_blocks"] = time_recombine(args.label)
    if "k3" in args.only:
        out["rbf_matvec"] = time_rbf(args.label)
    if "k8" in args.only:
        out["rbf_matvec_rect"] = time_rect(args.label)
    for label, case, dtype, reps in (("bf16 main", cs.ATTN_MAIN, torch.bfloat16, cs.REPS),
                                     ("bf16 32k", cs.ATTN_LONG, torch.bfloat16, cs.LONG_REPS),
                                     ("f32 main", cs.ATTN_MAIN, torch.float32, cs.REPS)):
        if "k9" not in args.only:
            break
        b, h, hkv, sq, sk, dh, causal, _ = case
        q, k, v = cs.attn_inputs(torch, b, h, hkv, sq, sk, dh, dtype, seed=2)
        _, ops = cs.attn_work(b, h, hkv, sq, sk, dh, causal, q.element_size())
        t = {"ms": cs.device_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, causal=causal),
                                reps),
             "sdpa_ms": cs.device_ms(torch, lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=causal), reps)}
        t["tflop_s"] = ops / t["ms"] / 1e9
        out["flash_attention"][label] = t
        print(f"[{args.label}] flash_attention {label} {case}: {t['ms']:.4f} ms "
              f"({t['tflop_s']:.1f} TFLOP/s), scaled_dot_product_attention "
              f"{t['sdpa_ms']:.4f} ms", flush=True)
        del q, k, v
    for dtype in (torch.float64, torch.float32) if "k4" in args.only else ():
        for rows, n in GRAM_SHAPES:
            g = torch.Generator(device="cuda").manual_seed(rows + n)
            s = torch.randn(rows, n, generator=g, device="cuda", dtype=dtype)
            err = float((cf.self_gram_cuda(s) - cf.self_gram_plain(s)).abs().max())
            t = {"ms": cs.device_ms(torch, lambda: cf.self_gram_cuda(s)),
                 "library_ms": cs.device_ms(torch, lambda: s @ s.T), "max_abs_err": err,
                 "profiled_kernels_ms": cs.profile_kernels(torch, lambda: cf.self_gram_cuda(s))}
            key = f"{str(dtype)[6:]} {rows}x{n}"
            out["self_gram"][key] = t
            print(f"[{args.label}] self_gram {key}: {t['ms']:.4f} ms, S @ S.T "
                  f"{t['library_ms']:.4f} ms (max abs err against the plain version "
                  f"{err:.2e}); profiler {t['profiled_kernels_ms']}", flush=True)
    out["sass"] = {name: sass_counts(name) for name in ("flash_attention", "cg_fused",
                                                        "rbf_matvec", "ssd_scan")}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
