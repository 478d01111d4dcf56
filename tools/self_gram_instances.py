#!/usr/bin/env python3
"""Why ``self_gram`` (K4) keeps two instances: times on the card.

``csrc/cg_fused.cu`` instantiates ``self_gram_partial`` for up to 64 rows
(def-CG's windows, 2(k + ℓ) = 40) and for up to 128 (the least-squares
windows, 112 rows in lsq_bench) and picks one at launch.  This script
builds the source as it is and a copy forced to the 128-row instance
(into ``build/self_gram_instances/``), then times both on the same
inputs, alternating as built, forced, forced, as built: 40 rows at
n = 36 551 (f64, f32) and n = 16 384 (f64), and 112 rows at n = 16 384
(f64, where both builds run the 128-row instance).  Each time is the
median of 50 CUDA-event timings with the L2 evicted before each call
(``chip_smoke.device_ms``).

    PYTHONPATH=src python tools/self_gram_instances.py

Needs a CUDA card and ``nvcc``; takes about half a minute.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, _runtime  # noqa: E402
from repro_torch.kernels import cg_fused as cf  # noqa: E402

SHAPES = ((40, 36551, torch.float64), (40, 16384, torch.float64),
          (40, 36551, torch.float32), (112, 16384, torch.float64))


def use(csrc: Path) -> None:
    """Point the loader at ``csrc`` and build it (if not built yet)."""
    _build.CSRC = csrc
    _build.load.cache_clear()
    _runtime._entry.cache_clear()
    _build.build(["cg_fused"])


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    built = _build.CSRC
    src = (built / "cg_fused.cu").read_text()
    forced_src = src.replace("if (m2 <= kSmallGramRows) {", "if (false) {")
    if forced_src == src:
        raise RuntimeError("the launch-time choice of instance was not found in cg_fused.cu")
    forced = ROOT / "build" / "self_gram_instances" / "csrc"
    os.makedirs(forced, exist_ok=True)
    (forced / "cg_fused.cu").write_text(forced_src)
    print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip())

    inputs = {}
    for rows, n, dtype in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(rows + n)
        inputs[(rows, n, dtype)] = torch.randn(rows, n, generator=g, device="cuda", dtype=dtype)
    times = {}
    for label, csrc in (("as built", built), ("forced 128", forced),
                        ("forced 128", forced), ("as built", built)):
        use(csrc)
        for (rows, n, dtype), s in inputs.items():
            err = float((cf.self_gram_cuda(s) - cf.self_gram_plain(s)).abs().max())
            ms = cs.device_ms(torch, lambda: cf.self_gram_cuda(s), reps=50)
            times.setdefault((rows, n, str(dtype)), {}).setdefault(label, []).append(ms)
            print(f"{label:10s} rows={rows:3d} n={n:5d} {dtype}: {ms:.4f} ms "
                  f"(max abs err against the plain version {err:.2e})", flush=True)
    _build.CSRC = built
    for (rows, n, dname), by in times.items():
        a, f = (sum(v) / len(v) for v in (by["as built"], by["forced 128"]))
        print(f"rows={rows:3d} n={n:5d} {dname}: as built {a:.4f} ms, forced to the "
              f"128-row instance {f:.4f} ms ({f / a:.2f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
