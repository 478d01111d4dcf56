"""Roofline analysis of the dry-run records, for one NVIDIA H100.

Per (arch × shape × mesh) cell, three time bounds a step:

    t_compute = FLOPs per card            / the card's peak for the cell's work
    t_memory  = bytes moved per card      / 3.35 TB/s             [HBM3]
    t_coll    = Σ collective bytes·α(op)  / 450 GB/s              [NVLink, each way]

FLOPs and bytes come from the step traced on the meta device
(:mod:`repro_torch.launch.trace_stats`): FLOPs by ``torch.utils
.flop_counter``'s formulas, the kernels' by the counts behind their bounds
(:mod:`repro_torch.kernels.work`), so the flash and SSD kernels' scores,
kept on chip, are already out of the bytes.  The peak is the one of the
unit and dtype the cell's work runs on, named in the record (``peak``):
bf16 on the tensor cores for the models, f32 on the CUDA cores for the GP
cell's RBF kernel (``H100``).  The collective model is the reference's:
per-card op bytes ``s`` move α·s bytes over one link, α(all-reduce) = 2,
α(others) = 1.  At one card there are no collectives and the term is 0.

The dominant term is the bottleneck; MODEL_FLOPS / traced FLOPs is the
useful-compute ratio (it catches remat's recompute and MoE capacity
waste).  The records keep the reference's key names
(``hlo_flops_per_device``, ``hlo_traffic_bytes_per_device``): the traced
counts stand where its HLO counts stood, so one roofline reads both.

Usage::

    python -m repro_torch.launch.roofline [--artifacts DIR] [--mesh single]
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W limit):
# HBM bytes/s, FLOP/s by unit and dtype ("float64"/"float32": the CUDA
# cores; "*_tensor": the tensor cores), NVLink bytes/s each way, memory.
H100 = {"bytes": 3.35e12, "float64": 34e12, "float32": 67e12, "float64_tensor": 67e12,
        "bfloat16_tensor": 989e12, "link": 450e9, "memory": 80e9}
CARD = "NVIDIA H100 80GB HBM3, 700 W"
# Peak tables keyed by a substring of the card's name.
PEAKS = {"H100": H100}

ALPHA = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}
ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "../../../artifacts/dryrun_torch")


def load_artifacts(art_dir: str) -> List[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def roofline_terms(rec: dict, peaks: dict = H100) -> Optional[dict]:
    """The three bounds of an ``ok`` record (None otherwise), its dominant
    term, the useful-FLOPs ratio and the roofline fraction, at ``peaks``
    (the FLOP rate ``peaks[rec["peak"]]``, bf16 tensor cores by default)."""
    if rec.get("status") != "ok":
        return None
    chips = rec["chips"]
    unit = rec.get("peak", "bfloat16_tensor")
    flops_dev = rec.get("hlo_flops_per_device", 0.0)
    traffic_dev = rec.get("hlo_traffic_bytes_per_device", 0.0)

    t_compute = flops_dev / peaks[unit]
    t_memory = traffic_dev / peaks["bytes"]

    t_coll = 0.0
    coll_bytes = 0.0
    for op, st in rec.get("collectives", {}).items():
        t_coll += ALPHA.get(op, 1.0) * st["bytes"] / peaks["link"]
        coll_bytes += st["bytes"]

    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = terms[dominant]

    model_flops_dev = rec.get("model_flops", 0.0) / chips
    useful_ratio = model_flops_dev / flops_dev if flops_dev else 0.0
    # roofline fraction: useful flops per card over peak, at the bound time
    frac = model_flops_dev / peaks[unit] / bound if bound > 0 else 0.0

    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "chips": chips,
        "peak": unit,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": bound,
        "model_flops": rec.get("model_flops", 0.0),
        "hlo_flops_total": flops_dev * chips,
        "useful_flops_ratio": useful_ratio,
        "roofline_fraction": frac,
        "collective_bytes_per_dev": coll_bytes,
        "moment_dtype": rec.get("moment_dtype"),
    }


def what_would_help(t: dict) -> str:
    if t["dominant"] == "compute":
        if t["useful_flops_ratio"] < 0.5:
            return (
                "compute-bound with low useful ratio — cut remat recompute "
                "/ capacity-factor waste"
            )
        return ("compute-bound — near the right wall; the products on wgmma at the "
                "tensor-core rate, larger tiles")
    if t["dominant"] == "memory":
        return (
            "memory-bound — keep scores in shared memory and registers (the "
            "flash and SSD kernels), fuse elementwise chains and casts, bf16 temporaries"
        )
    return (
        "collective-bound — reshard to cut all-gathers, overlap the NCCL "
        "collectives with compute"
    )


def table(art_dir: str, mesh: Optional[str] = "single") -> str:
    """A markdown row a record: its bytes, whether it fits the card's
    memory, the largest batch that does, and its roofline."""
    rows = []
    for rec in load_artifacts(art_dir):
        if mesh and rec.get("mesh") != mesh:
            continue
        head = f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} |"
        if rec.get("status") == "skipped":
            rows.append(f"{head} skipped — {rec['reason'][:48]} ||||||||")
            continue
        t = roofline_terms(rec)
        if t is None:
            rows.append(f"{head} ERROR {rec.get('error', '')[:48]} ||||||||")
            continue
        rows.append(
            "{head} {pg:.2f} | {kg:.2f} | {fits} | {mb} | {tf:.1f} | {bm:.3f} | **{dom}** "
            "| {ur:.2f} | {rf:.1%} |".format(
                head=head, pg=rec.get("param_bytes", 0) / 1e9, kg=rec["peak_bytes"] / 1e9,
                fits="yes" if rec["fits"] else "no", mb=rec.get("max_batch", "—"),
                tf=t["hlo_flops_total"] / 1e12, bm=1e3 * t["bound_s"], dom=t["dominant"],
                ur=t["useful_flops_ratio"], rf=t["roofline_fraction"],
            )
        )
    header = (
        "| arch | shape | mesh | params GB | peak GB | fits | largest batch | TFLOP | "
        "bound ms | bottleneck | useful-flops ratio | roofline fraction |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|---|"
    )
    return header + "\n" + "\n".join(rows)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default=os.path.abspath(ARTIFACT_DIR))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "all"])
    args = ap.parse_args(argv)
    mesh = None if args.mesh == "all" else args.mesh
    print(f"Dry-run bounds for one {CARD}")
    print(table(args.artifacts, mesh))
    print()
    for rec in load_artifacts(args.artifacts):
        if mesh and rec.get("mesh") != mesh:
            continue
        t = roofline_terms(rec)
        if t:
            print(f"{t['arch']:24s} {t['shape']:14s} -> {what_would_help(t)}")


if __name__ == "__main__":
    main()
