#!/usr/bin/env python3
"""K10's arms on seeded inputs: SHA-256 digests of their outputs, so two
trees' outputs compare bit for bit.

The serving arm (``ssd_scan_cuda``, with the final state), the training
forward (``ssd_scan_fwd_cuda``: y, the final state, the chunk-entry states
and cs), the backward (dx, ddt, da, dB, dC, dh0) and the forward-mode
tangent (ẏ, ḣ) at ``chip_smoke.py``'s shapes: mamba2-1.3b's training shape
(``SSD_TRAIN``: b 2, l 1 024), its prefill (``SSD_MAIN``: b 4, l 4 096) and
``SSD_CHECK``'s small ones, in f32 and bf16, the small ones also with a
state in and out.  The f32 digests show whether the CUDA-core arms changed;
the bf16 serving and training-forward digests whether the forward did.  To
compare a change with its parent on one card::

    git archive <parent> | tar -x -C build/parent
    python tools/k10_digests.py --label parent --src build/parent/src
    python tools/k10_digests.py --label change

Needs a CUDA card and ``nvcc``.  The last line is a JSON object
``{"label", "card", "src", "digests": {arm shape dtype state: digest}}``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSD_TRAIN = (2, 1024, 64, 64, 1, 128, 128)
SSD_MAIN = (4, 4096, 64, 64, 1, 128, 128)
SSD_CHECK = ((1, 64, 2, 16, 1, 16, 32), (2, 100, 4, 8, 2, 24, 32), (1, 37, 2, 4, 2, 8, 16),
             (2, 128, 8, 32, 1, 64, 64))


def _digest(t) -> str:
    import torch

    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def _inputs(torch, case, dtype, state):
    """x, dt, a, B, C, the state and the cotangents / tangents of ``case``
    from a seeded generator on the card, dt in [0.01, 0.4), a in (−2, −0.3]
    as the Mamba mixer makes them."""
    b, l, h, p, g, n, _ = case
    gen = torch.Generator(device="cuda").manual_seed(sum(case) + int(state))
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")  # noqa: E731
    x, dy, tx = (rnd(b, l, h, p).to(dtype) for _ in range(3))
    bm, cm, tb, tc = (rnd(b, l, g, n).to(dtype) for _ in range(4))
    dt = 0.01 + 0.39 * torch.rand(b, l, h, generator=gen, device="cuda")
    a = -(0.3 + 1.7 * torch.rand(h, generator=gen, device="cuda"))
    tdt, ta = 0.1 * rnd(b, l, h), 0.1 * rnd(h)
    h0, dh, th0 = (rnd(b, h, p, n) if state else None for _ in range(3))
    return x, dt, a, bm, cm, h0, dy, tx, tdt, ta, tb, tc, dh, th0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--label", default="change")
    parser.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    from repro_torch.kernels import ssd_scan as ss

    if not torch.cuda.is_available():
        print("k10_digests: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    runs = [(c, s) for c in SSD_CHECK for s in (False, True)]
    runs += [(SSD_TRAIN, False), (SSD_MAIN, False)]
    digests = {}
    for case, state in runs:
        for dname in ("float32", "bfloat16"):
            x, dt, a, bm, cm, h0, dy, tx, tdt, ta, tb, tc, dh, th0 = _inputs(
                torch, case, getattr(torch, dname), state)
            c = case[-1]
            arms = {"serve": ss.ssd_scan_cuda(x, dt, a, bm, cm, chunk=c, initial_state=h0,
                                              return_state=True),
                    "fwd": ss.ssd_scan_fwd_cuda(x, dt, a, bm, cm, h0, chunk=c)}
            _, _, hs, cs = arms["fwd"]
            arms["bwd"] = ss.ssd_scan_bwd_cuda(dy, x, dt, a, bm, cm, h0, hs, cs, dh, chunk=c)
            arms["jvp"] = ss.ssd_scan_jvp_cuda(x, dt, a, bm, cm, h0, hs, cs, tx, tdt, ta, tb, tc,
                                               th0, chunk=c)
            torch.cuda.synchronize()
            for arm, outs in arms.items():
                digests[f"{arm} {case} {dname} state={state}"] = "-".join(_digest(t) for t in outs)
            del arms, hs, cs
    print(json.dumps({"label": args.label, "card": card, "src": args.src, "digests": digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
