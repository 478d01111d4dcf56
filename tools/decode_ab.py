#!/usr/bin/env python3
"""Serving decode time a step, so two trees compare on one card.

seamless-m4t-large-v2 at ``chip_smoke.py``'s main-lm-encdec shape (random
f32 weights seeded 0, bf16 compute; 4 × 4 096 seeded normal source frames,
4 × 1 024 prompt tokens, 32 greedy decode steps), the one serving path
whose decode steps launch a kernel (K9: 24 one-row cross-attention calls a
step), and qwen1.5-0.5b's (main-lm-attn: 4 × 4 096 prompt tokens, 16
steps; no kernel in its decode steps).  Each is served ``--reps`` times
after a warm-up: the decode ms a step of each run (host clock, ended by a
synchronize), K9's launches a run and a digest of the greedy tokens and
the last step's logits.  To compare a change with its parent::

    git archive <parent> | tar -x -C build/parent
    python tools/decode_ab.py --label parent --src build/parent/src
    python tools/decode_ab.py --label change

Needs a CUDA card and ``nvcc``.  The last line is a JSON object
``{"label", "card", "runs": {arch: {"decode_ms": [...], ...}}}``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = (("seamless-m4t-large-v2", 4, 1024, 4096, 32), ("qwen1.5-0.5b", 4, 4096, None, 16))


def _digest(torch, *tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def serve(torch, models, cfg, model, batch, steps):
    """Prefill ``batch`` and take ``steps`` greedy decode steps; returns
    (decode seconds, greedy tokens, last logits)."""
    b, s = batch["tokens"].shape
    state = models.init_decode_state(cfg, b, s + steps, device="cuda")
    state, last = models.prefill(model, batch, state, cfg)
    tok = last[:, -1, : cfg.vocab_size].argmax(-1, keepdim=True)
    greedy = [tok]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, state = models.decode_step(model, tok, state, cfg)
        tok = logits[:, -1, : cfg.vocab_size].argmax(-1, keepdim=True)
        greedy.append(tok)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, torch.cat(greedy, dim=1), logits


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--label", default="change")
    parser.add_argument("--src", default=os.path.join(ROOT, "src"))
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, _runtime

    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    _build.build(["flash_attention", "ssd_scan"])
    runs = {}
    for arch, b, prompt, frames, steps in CELLS:
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda")
        model = models.init(gen.manual_seed(0), cfg, device="cuda")
        tokens = torch.randint(0, cfg.vocab_size, (b, prompt), device="cuda",
                               generator=gen.manual_seed(1))
        batch = {"tokens": tokens}
        if frames:
            batch["src_embeds"] = torch.randn(b, frames, cfg.d_model, device="cuda",
                                              generator=gen.manual_seed(2))
        serve(torch, models, cfg, model, batch, 2)  # warm-up
        ms, launches = [], []
        for _ in range(args.reps):
            before = _runtime.LAUNCHES["flash_attention"]
            sec, greedy, logits = serve(torch, models, cfg, model, batch, steps)
            ms.append(1e3 * sec / steps)
            launches.append(_runtime.LAUNCHES["flash_attention"] - before)
        runs[arch] = {"decode_ms": ms, "k9_launches": launches,
                      "digest": _digest(torch, greedy, logits.float())}
        print(f"{args.label} {arch}: decode {', '.join(f'{m:.2f}' for m in ms)} ms a step; K9 "
              f"launches {launches}; digest {runs[arch]['digest']}", flush=True)
        del model
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "card": card, "src": args.src, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
