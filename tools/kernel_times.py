#!/usr/bin/env python3
"""Times of K9 (``flash_attention``) and K4 (``self_gram``) on the card.

Times the kernels of the tree this script lives in, at the main paths'
shapes, beside the one PyTorch call that computes the same function:
K9 in bf16 at qwen1.5-0.5b's prefill (4 × 16 heads × 4 096, dh 64,
causal) and at 32 768 tokens (b 1), and in f32 at the prefill shape,
beside ``scaled_dot_product_attention``; K4 at 112 rows × 16 384 and
40 rows × 36 551, f64 and f32, beside ``S @ S.T``.  Each time is the
median of 25 CUDA-event timings (3 at 32 768 tokens) with the L2 evicted
before each call (``chip_smoke.device_ms``).  Then it counts the
tensor-core instructions (HMMA, DMMA) in the built libraries' SASS with
``cuobjdump``, where the toolkit has it.  The last line is a JSON object.

To compare two trees on one card, copy this script into the other tree's
``tools/`` and run both in one call, in turns:

    PYTHONPATH=src python tools/kernel_times.py --label change
    python <other tree>/tools/kernel_times.py --label parent

Needs a CUDA card and ``nvcc``; takes about a minute.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import cg_fused as cf  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

GRAM_SHAPES = ((112, 16384), (40, 36551))


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=str(ROOT))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build(["flash_attention", "cg_fused"])
    out = {"label": args.label, "card": card, "flash_attention": {}, "self_gram": {}}
    for label, case, dtype, reps in (("bf16 main", cs.ATTN_MAIN, torch.bfloat16, cs.REPS),
                                     ("bf16 32k", cs.ATTN_LONG, torch.bfloat16, cs.LONG_REPS),
                                     ("f32 main", cs.ATTN_MAIN, torch.float32, cs.REPS)):
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
    for dtype in (torch.float64, torch.float32):
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
    out["sass"] = {name: sass_counts(name) for name in ("flash_attention", "cg_fused")}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
