"""The dry-run: every (arch × shape) cell traced at full width for one H100.

For each cell the step is built on the meta device (parameters, optimizer
state, batch and caches are empty tensors: nothing is allocated) and run
once under :class:`~repro_torch.launch.trace_stats.TraceStats`: train
(loss, gradients and AdamW, ``cfg.remat`` as the config has it, bf16
moments above 1e11 parameters as the reference's), prefill (the prompt into
caches ``seq_len`` deep) or decode (one token against them).  Each record
holds

* the parameter, optimizer-state, batch and cache bytes;
* the peak live bytes and whether they fit the card's 80 GB;
* the traced FLOPs and bytes, the op census (the launches the step
  issues), ``model_flops`` (the useful-FLOPs numerator);
* the largest batch one card holds: a second trace at batch 1 (2 for a
  batch-1 cell) gives the bytes a sequence adds, since they are linear in
  the batch;
* ``status`` and ``reason`` under the reference's skip rules.

The kernels the steps reach (K9, K10; K3 in the GP cell) are custom ops
whose counts are those behind ``PERF.md`` §6's bounds
(:mod:`repro_torch.kernels.work`).  Only ``mesh="single"``, one card, is
traced: the many-card meshes wait for the sharding layouts (ROADMAP queue
1), as every record's ``note`` says.  Records go to
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json`` and are reused
when present (``--force`` traces again); ``python -m
repro_torch.launch.roofline`` tabulates them.

Usage::

    python -m repro_torch.launch.dryrun --all
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --force
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import models
from repro_torch.configs import gpc_mnist
from repro_torch.configs.registry import (
    ARCH_IDS,
    SHAPES,
    get_config,
    get_smoke_config,
    shape_applicable,
)
from repro_torch.launch import gpc_dryrun, roofline, trace_stats
from repro_torch.launch import steps as steps_lib

ARTIFACT_DIR = roofline.ARTIFACT_DIR
MEMORY = roofline.H100["memory"]
NOTE = ("one NVIDIA H100 (80 GB); the many-card meshes wait for the sharding layouts "
        "(ROADMAP queue 1)")
# The peak a cell's work runs at, by compute dtype (roofline.H100's keys).
PEAK_BY_DTYPE = {"bfloat16": "bfloat16_tensor", "float32": "float32",
                 "float64": "float64_tensor"}


def _bytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for t in trace_stats._tensors(list(trees)))


def trace_step(cfg, shape) -> dict:
    """One step of ``cfg`` at ``shape`` traced on the meta device: the sizes
    of what the step holds (``param_bytes``, ``opt_state_bytes``,
    ``batch_bytes``, ``cache_bytes``) and the trace's counts."""
    skeleton = models.transformer.Model(None, cfg, "meta")
    params = list(skeleton.parameters())
    batch = steps_lib.input_specs(cfg, shape)
    sizes = {"param_bytes": _bytes(params), "opt_state_bytes": 0, "cache_bytes": 0,
             "batch_bytes": _bytes(batch)}
    if shape.kind == "train":
        moment = torch.bfloat16 if cfg.total_params() > 1e11 else torch.float32
        pdict = steps_lib.params_dict(skeleton)
        opt = steps_lib.init_opt_state(pdict, moment)
        sizes["opt_state_bytes"] = _bytes(opt)
        sizes["moment_dtype"] = str(moment).split(".")[-1]
        step = steps_lib.make_train_step(cfg, moment_dtype=moment)
        _, counts = trace_stats.trace(step, pdict, opt, batch)
    elif shape.kind == "prefill":
        state = models.init_decode_state(cfg, shape.global_batch, shape.seq_len, device="meta")
        sizes["cache_bytes"] = _bytes(state)
        step = steps_lib.make_prefill_step(cfg, shape.seq_len)
        _, counts = trace_stats.trace(step, skeleton, batch, state, live=[params])
    else:
        state = steps_lib.decode_state_specs(cfg, shape, skeleton=skeleton)
        sizes["cache_bytes"] = _bytes(state)
        step = steps_lib.make_serve_step(cfg)
        _, counts = trace_stats.trace(step, skeleton, batch["tokens"], state, live=[params])
    return {**sizes, **counts}


def _max_batch(peak: float, batch: int, peak_other: float, other: int) -> int:
    """The largest batch whose peak fits the card, the peak linear in the
    batch through ``(batch, peak)`` and ``(other, peak_other)``."""
    per_seq = (peak - peak_other) / (batch - other)
    base = peak - batch * per_seq
    if base + per_seq > MEMORY:
        return 0
    return int((MEMORY - base) // per_seq) if per_seq > 0 else batch


def _write(path: str, record: dict):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)


def _cached(path: str, force: bool):
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    return None


def run_gpc_cell(outdir: str, force: bool = False, replicate_x: bool = False) -> dict:
    """The paper's own workload (one def-CG iteration at n = 2²⁰) as a
    cell.  At one card X is whole either way: ``newton_1m_optx`` (X kept,
    the reference's replicated X) is the same trace as ``newton_1m``."""
    cfg = gpc_mnist.CONFIG
    variant = "newton_1m_optx" if replicate_x else "newton_1m"
    path = os.path.join(outdir, f"gpc-mnist__{variant}__single.json")
    cached = _cached(path, force)
    if cached is not None:
        return cached
    record = {"arch": "gpc-mnist", "shape": variant, "mesh": "single", "chips": 1,
              "card": roofline.CARD, "status": "pending", "peak": PEAK_BY_DTYPE[cfg.dtype],
              "note": "one def-CG(8) iteration on K3, X whole on the card; scale by the "
                      "measured iteration counts; " + NOTE}
    try:
        t0 = time.time()
        counts = gpc_dryrun.trace_cell(cfg)
        record.update(_counts(counts), trace_s=round(time.time() - t0, 2),
                      x_bytes=cfg.n * cfg.d * (4 if cfg.dtype == "float32" else 8),
                      model_flops=gpc_dryrun.model_flops(cfg), status="ok")
        record["fits"] = record["peak_bytes"] <= MEMORY
    except Exception as exc:  # noqa: BLE001 — one cell's failure is its record
        record.update(status="error", error=f"{type(exc).__name__}: {exc}",
                      traceback=traceback.format_exc()[-4000:])
    _write(path, record)
    return record


def _counts(counts: dict) -> dict:
    """A trace's counts under the record's keys (the reference's names)."""
    return {"hlo_flops_per_device": counts["flops"],
            "hlo_traffic_bytes_per_device": counts["bytes"], "launches": counts["launches"],
            "op_census": counts["op_census"], "peak_bytes": counts["peak_bytes"],
            "collectives": {}}


def run_cell(arch: str, shape_name: str, outdir: str, force: bool = False,
             smoke: bool = False) -> dict:
    """Trace one cell (``smoke``: at the config's SMOKE width) and write its
    record."""
    if arch == "gpc-mnist":
        return run_gpc_cell(outdir, force)
    if arch == "gpc-mnist-optx":
        return run_gpc_cell(outdir, force, replicate_x=True)
    tag = f"{arch}__{shape_name}__single" + ("__smoke" if smoke else "")
    path = os.path.join(outdir, tag + ".json")
    cached = _cached(path, force)
    if cached is not None:
        return cached
    cfg = (get_smoke_config if smoke else get_config)(arch)
    shape = SHAPES[shape_name]
    record = {"arch": arch, "shape": shape_name, "mesh": "single", "chips": 1,
              "config": "smoke" if smoke else "full", "card": roofline.CARD,
              "status": "pending", "note": NOTE}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        record.update(status="skipped", reason=why)
        _write(path, record)
        return record
    try:
        t0 = time.time()
        full = trace_step(cfg, shape)
        other = 1 if shape.global_batch > 1 else 2
        small = trace_step(cfg, dataclasses.replace(shape, global_batch=other))
        record.update({k: full[k] for k in ("param_bytes", "opt_state_bytes", "batch_bytes",
                                            "cache_bytes")})
        record.update(
            _counts(full),
            moment_dtype=full.get("moment_dtype"), remat=cfg.remat,
            peak=PEAK_BY_DTYPE[cfg.dtype], device_memory_bytes=MEMORY,
            fits=full["peak_bytes"] <= MEMORY,
            max_batch=_max_batch(full["peak_bytes"], shape.global_batch, small["peak_bytes"],
                                 other),
            peak_bytes_at_batch={other: small["peak_bytes"]},
            trace_s=round(time.time() - t0, 2),
            model_flops=steps_lib.model_flops(cfg, shape),
            active_params=cfg.active_params(), total_params=cfg.total_params(),
            status="ok")
    except Exception as exc:  # noqa: BLE001 — one cell's failure is its record
        record.update(status="error", error=f"{type(exc).__name__}: {exc}",
                      traceback=traceback.format_exc()[-4000:])
    _write(path, record)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--outdir", default=os.path.abspath(ARTIFACT_DIR))
    args = ap.parse_args(argv)

    archs = (list(ARCH_IDS) + ["gpc-mnist", "gpc-mnist-optx"]
             if (args.all or args.arch is None) else [args.arch])
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]

    n_fail = 0
    for arch in archs:
        for shape in shapes[:1] if arch.startswith("gpc-mnist") else shapes:
            rec = run_cell(arch, shape, args.outdir, args.force)
            line = f"{rec['arch']:24s} {rec['shape']:14s} {rec['mesh']:6s} {rec['status']:7s}"
            if rec["status"] == "ok":
                line += (f" flops={rec['hlo_flops_per_device']:.3e}"
                         f" peak={rec['peak_bytes'] / 1e9:.2f}GB"
                         f" trace={rec.get('trace_s', 0):.1f}s")
            elif rec["status"] == "error":
                n_fail += 1
                line += " " + rec.get("error", "")[:120]
            print(line, flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
