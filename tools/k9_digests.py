#!/usr/bin/env python3
"""K9's arms on seeded inputs: SHA-256 digests of their outputs, so two
trees' outputs compare bit for bit.

The serving arm (``flash_attention_cuda``) at ``chip_smoke.py``'s prefill
shapes: qwen1.5-0.5b's prefill (b 4, h 16, s 4 096, dh 64, causal) in bf16
and f32, prefill_32k's length (b 1, s 32 768) in bf16, and the GQA check
shapes at dh 16, 64 and 128.  The differentiated arms (the forward with the
row log-sum-exp, the backward's dq, dk and dv, the forward-mode tangent) at
qwen1.5-0.5b's training shape and ``chip_smoke.py``'s ``GRAD_CHECK`` shapes,
in f32 and bf16: the f32 digests show whether the CUDA-core arms changed.
To compare a change with its parent on one card::

    git archive <parent> | tar -x -C build/parent
    python tools/k9_digests.py --label parent --src build/parent/src
    python tools/k9_digests.py --label change

Needs a CUDA card and ``nvcc``.  The last line is a JSON object
``{"label", "card", "digests": {shape: digest}}``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (  # b, h, hkv, sq, sk, dh, causal, q_offset, dtype
    (4, 16, 16, 4096, 4096, 64, True, 0, "bfloat16"),
    (4, 16, 16, 4096, 4096, 64, True, 0, "float32"),
    (1, 16, 16, 32768, 32768, 64, True, 0, "bfloat16"),
    (1, 8, 2, 96, 96, 64, True, 0, "bfloat16"),
    (1, 16, 2, 33, 33, 128, True, 0, "bfloat16"),
    (2, 4, 1, 70, 150, 64, True, 80, "bfloat16"),
    (1, 2, 1, 40, 200, 16, False, 0, "float32"),
)
GRAD_SHAPES = (  # b, h, hkv, sq, sk, dh, causal (q_offset 0)
    (4, 16, 16, 4096, 4096, 64, True),
    (2, 8, 2, 256, 256, 16, False),
    (1, 8, 2, 300, 300, 64, True),
    (1, 8, 2, 200, 330, 128, False),
    (2, 8, 2, 130, 130, 128, True),
)


def _digest(t) -> str:
    import torch

    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--label", default="change")
    parser.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("k9_digests: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    digests = {}
    for b, h, hkv, sq, sk, dh, causal, off, dname in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(sq + sk + dh)
        q, k, v = (torch.randn(b, n, s, dh, generator=g, device="cuda").to(getattr(torch, dname))
                   for n, s in ((h, sq), (hkv, sk), (hkv, sk)))
        out = fa.flash_attention_cuda(q, k, v, causal=causal, q_offset=off)
        torch.cuda.synchronize()
        key = f"{(b, h, hkv, sq, sk, dh, causal, off)} {dname}"
        digests[key] = _digest(out)
    for case in GRAD_SHAPES:
        b, h, hkv, sq, sk, dh, causal = case
        for dname in ("float32", "bfloat16"):
            g = torch.Generator(device="cuda").manual_seed(sq + sk + dh + 1)
            q, dout, tq = (torch.randn(b, h, sq, dh, generator=g, device="cuda")
                           .to(getattr(torch, dname)) for _ in range(3))
            k, v, tk, tv = (torch.randn(b, hkv, sk, dh, generator=g, device="cuda")
                            .to(getattr(torch, dname)) for _ in range(4))
            out, lse = fa.flash_attention_lse_cuda(q, k, v, causal=causal)
            arms = {"lse": lse, **dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_cuda(
                dout, q, k, v, out, lse, causal=causal))),
                "jvp": fa.flash_attention_jvp_cuda(q, k, v, out, lse, tq, tk, tv, causal=causal)}
            torch.cuda.synchronize()
            for arm, t in arms.items():
                digests[f"{arm} {case} {dname}"] = _digest(t)
    print(json.dumps({"label": args.label, "card": card, "src": args.src, "digests": digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
