#!/usr/bin/env python3
"""K9's serving arm (``flash_attention_cuda``) on seeded inputs: SHA-256
digests of its outputs, so two trees' outputs compare bit for bit.

The shapes are ``chip_smoke.py``'s prefill shapes: qwen1.5-0.5b's prefill
(b 4, h 16, s 4 096, dh 64, causal) in bf16 and f32, prefill_32k's length
(b 1, s 32 768) in bf16, and the GQA check shapes at dh 16, 64 and 128.
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
        digests[key] = hashlib.sha256(out.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]
    print(json.dumps({"label": args.label, "card": card, "src": args.src, "digests": digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
