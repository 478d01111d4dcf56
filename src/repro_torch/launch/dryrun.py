"""The dry-run: every (arch × shape) cell traced at full width, on one
H100 and on the reference's many-card meshes.

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

``--mesh`` picks the meshes (:data:`MESHES`): ``single`` is one card;
``pod`` the reference's ``(16, 16) = ("data", "model")``, 256 cards;
``multi`` its ``(2, 16, 16) = ("pod", "data", "model")``, 512; ``four``
``make_mesh_auto``'s mesh at four cards, ``(4, 1)`` (ZeRO over four, no
tensor parallelism: what a four-card cell would run); ``all`` every one.
A many-card cell is traced on one rank (rank 0) of a fake process group
(``FakeStore``, backend ``"fake"``) whose ``DeviceMesh`` lives on the meta
device: the model at the mesh's tensor-parallel degree, its parameters,
AdamW state, batch and caches DTensors laid out by ``launch.mesh`` (local
tensors on the meta device), so every number is one rank's, and the
record adds the collectives DTensor's redistributions issue on that rank
(count and bytes by the reference's HLO names) and ``chips``.  A batch the
data-parallel axes do not divide is replicated (``long_500k``); the
second trace for the largest batch is at one sequence a data rank (two
for a replicated batch).  The GPC cell runs its iteration on the solve
mesh of all the cards (``core.sharded``'s layout: vectors row-sharded, X
whole on each).

The kernels the steps reach (K9, K10; K3/K8 in the GP cell) are custom
ops whose counts are those behind ``PERF.md`` §6's bounds
(:mod:`repro_torch.kernels.work`).  Records go to
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json`` and are reused
when present (``--force`` traces again); ``python -m
repro_torch.launch.roofline`` tabulates them.

Usage::

    python -m repro_torch.launch.dryrun --all --mesh all
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh pod --force
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import convert, models
from repro_torch.configs import gpc_mnist
from repro_torch.configs.registry import (
    ARCH_IDS,
    SHAPES,
    get_config,
    get_smoke_config,
    shape_applicable,
)
from repro_torch.launch import gpc_dryrun, roofline, trace_stats
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import sharding as shd

ARTIFACT_DIR = roofline.ARTIFACT_DIR
MEMORY = roofline.H100["memory"]
NOTE = "one NVIDIA H100 (80 GB)"
# mesh name -> (shape, axis names); "single" is one card, no mesh.
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "four": ((4, 1), ("data", "model"))}
MESH_NOTE = ("{chips} NVIDIA H100 (80 GB each), one rank's numbers; the collective term "
             "assumes NVLink's 450 GB/s on every link, which flatters a model axis wider "
             "than one 8-card NVLink domain (16 spans two)")
# The peak a cell's work runs at, by compute dtype (roofline.H100's keys).
PEAK_BY_DTYPE = {"bfloat16": "bfloat16_tensor", "float32": "float32",
                 "float64": "float64_tensor"}


def _bytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for t in trace_stats._tensors(list(trees)))


@contextlib.contextmanager
def fake_world(ranks: int):
    """A fake process group of ``ranks`` ranks, this process rank 0, for the
    block (the one it replaces, if any, is gone after it)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


class Layout:
    """A cell's layout on a many-card mesh: the mesh (meta device), its
    bound environment, the tensor-parallel degree, and how to lay out a
    model, a batch and a decode state."""

    def __init__(self, mesh_name: str, batch: int):
        shape, axes = MESHES[mesh_name]
        self.mesh = mesh_lib.make_model_mesh(shape, axes, device_type="cpu")
        sizes = dict(zip(axes, shape))
        self.dp = sizes.get("pod", 1) * sizes["data"]
        self.tp = sizes["model"]
        self.batch_sharded = batch % self.dp == 0
        self.env = mesh_lib.bind(self.mesh, batch_shardable=self.batch_sharded)

    def model(self, cfg):
        skeleton = models.transformer.Model(None, cfg, "meta", self.tp)
        return convert.distribute(skeleton, self.mesh, self.env)

    def batch(self, batch):
        return mesh_lib.distribute_batch(self.mesh, batch, self.env)

    def state(self, state):
        return mesh_lib.distribute_decode_state(self.mesh, state, self.env)


def trace_step(cfg, shape, layout=None) -> dict:
    """One step of ``cfg`` at ``shape`` traced on the meta device, on one
    card or on rank 0 of ``layout``'s mesh: the sizes of what the step
    holds (``param_bytes``, ``opt_state_bytes``, ``batch_bytes``,
    ``cache_bytes``, a rank's) and the trace's counts."""
    tp = 1 if layout is None else layout.tp
    skeleton = (models.transformer.Model(None, cfg, "meta") if layout is None
                else layout.model(cfg))
    params = list(skeleton.parameters())
    batch = steps_lib.input_specs(cfg, shape)
    batch = batch if layout is None else layout.batch(batch)
    sizes = {"param_bytes": _bytes(params), "opt_state_bytes": 0, "cache_bytes": 0,
             "batch_bytes": _bytes(batch)}

    def placed(state):
        return state if layout is None else layout.state(state)

    if shape.kind == "train":
        moment = torch.bfloat16 if cfg.total_params() > 1e11 else torch.float32
        pdict = steps_lib.params_dict(skeleton)
        opt = steps_lib.init_opt_state(pdict, moment)
        sizes["opt_state_bytes"] = _bytes(opt)
        sizes["moment_dtype"] = str(moment).split(".")[-1]
        step = steps_lib.make_train_step(cfg, moment_dtype=moment, tp=tp)
        _, counts = trace_stats.trace(step, pdict, opt, batch)
    elif shape.kind == "prefill":
        state = placed(models.init_decode_state(cfg, shape.global_batch, shape.seq_len, tp,
                                                device="meta"))
        sizes["cache_bytes"] = _bytes(state)
        step = steps_lib.make_prefill_step(cfg, shape.seq_len)
        _, counts = trace_stats.trace(step, skeleton, batch, state, live=[params])
    else:
        state = placed(steps_lib.decode_state_specs(cfg, shape, skeleton=None if layout is None
                                                    else skeleton, tp=tp))
        sizes["cache_bytes"] = _bytes(state)
        step = steps_lib.make_serve_step(cfg)
        _, counts = trace_stats.trace(step, skeleton, batch["tokens"], state, live=[params])
    return {**sizes, **counts}


def _max_batch(peak: float, batch: int, peak_other: float, other: int, step: int = 1) -> int:
    """The largest batch (a multiple of ``step``) whose peak fits the card,
    the peak linear in the batch through ``(batch, peak)`` and ``(other,
    peak_other)``."""
    per_seq = (peak - peak_other) / (batch - other)
    base = peak - batch * per_seq
    if base + step * per_seq > MEMORY:
        return 0
    if per_seq <= 0:
        return batch
    return int((MEMORY - base) // per_seq) // step * step


def _write(path: str, record: dict):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)


def _cached(path: str, force: bool):
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    return None


def _chips(mesh_name: str) -> int:
    return 1 if mesh_name == "single" else math.prod(MESHES[mesh_name][0])


def _note(mesh_name: str) -> str:
    return NOTE if mesh_name == "single" else MESH_NOTE.format(chips=_chips(mesh_name))


def run_gpc_cell(outdir: str, force: bool = False, replicate_x: bool = False,
                 mesh: str = "single") -> dict:
    """The paper's own workload (one def-CG iteration at n = 2²⁰) as a
    cell.  X is whole on every card either way (the reference's replicated
    X): ``newton_1m_optx`` is the same trace as ``newton_1m``.  On a
    many-card mesh the iteration runs on the solve mesh of all its cards,
    the vectors row-sharded."""
    cfg = gpc_mnist.CONFIG
    variant = "newton_1m_optx" if replicate_x else "newton_1m"
    path = os.path.join(outdir, f"gpc-mnist__{variant}__{mesh}.json")
    cached = _cached(path, force)
    if cached is not None:
        return cached
    chips = _chips(mesh)
    record = {"arch": "gpc-mnist", "shape": variant, "mesh": mesh, "chips": chips,
              "card": roofline.CARD, "status": "pending", "peak": PEAK_BY_DTYPE[cfg.dtype],
              "note": "one def-CG(8) iteration on K3 (K8 on a mesh), X whole on each card; "
                      "scale by the measured iteration counts; " + _note(mesh)}
    try:
        t0 = time.time()
        if mesh == "single":
            counts = gpc_dryrun.trace_cell(cfg)
        else:
            with fake_world(chips):
                counts = gpc_dryrun.trace_cell(cfg, mesh_lib.make_solve_mesh(device="meta"))
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
            "collectives": counts["collectives"]}


def run_cell(arch: str, shape_name: str, outdir: str, force: bool = False,
             smoke: bool = False, mesh: str = "single") -> dict:
    """Trace one cell (``smoke``: at the config's SMOKE width) on ``mesh``
    (a name of :data:`MESHES`, or ``single``) and write its record."""
    if arch in ("gpc-mnist", "gpc-mnist-optx"):
        return run_gpc_cell(outdir, force, replicate_x=arch == "gpc-mnist-optx", mesh=mesh)
    tag = f"{arch}__{shape_name}__{mesh}" + ("__smoke" if smoke else "")
    path = os.path.join(outdir, tag + ".json")
    cached = _cached(path, force)
    if cached is not None:
        return cached
    cfg = (get_smoke_config if smoke else get_config)(arch)
    shape = SHAPES[shape_name]
    record = {"arch": arch, "shape": shape_name, "mesh": mesh, "chips": _chips(mesh),
              "config": "smoke" if smoke else "full", "card": roofline.CARD,
              "status": "pending", "note": _note(mesh)}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        record.update(status="skipped", reason=why)
        _write(path, record)
        return record
    try:
        t0 = time.time()
        if mesh == "single":
            other, step = (1 if shape.global_batch > 1 else 2), 1
            full = trace_step(cfg, shape)
            small = trace_step(cfg, dataclasses.replace(shape, global_batch=other))
            layout = None
        else:
            with fake_world(_chips(mesh)):
                layout = Layout(mesh, shape.global_batch)
                step = layout.dp if layout.batch_sharded else 1
                other = (2 * step if shape.global_batch == step else step) if \
                    layout.batch_sharded else 2
                full = trace_step(cfg, shape, layout)
                layout = Layout(mesh, other)
                small = trace_step(cfg, dataclasses.replace(shape, global_batch=other), layout)
                shd.set_axis_env(None)
        record.update({k: full[k] for k in ("param_bytes", "opt_state_bytes", "batch_bytes",
                                            "cache_bytes")})
        record.update(
            _counts(full),
            moment_dtype=full.get("moment_dtype"), remat=cfg.remat,
            peak=PEAK_BY_DTYPE[cfg.dtype], device_memory_bytes=MEMORY,
            fits=full["peak_bytes"] <= MEMORY,
            max_batch=_max_batch(full["peak_bytes"], shape.global_batch, small["peak_bytes"],
                                 other, step),
            peak_bytes_at_batch={other: small["peak_bytes"]},
            trace_s=round(time.time() - t0, 2),
            model_flops=steps_lib.model_flops(cfg, shape),
            active_params=cfg.active_params(), total_params=cfg.total_params(),
            status="ok")
        if layout is not None:
            record.update(tp=layout.tp, dp=layout.dp, batch_sharded=layout.batch_sharded)
    except Exception as exc:  # noqa: BLE001 — one cell's failure is its record
        record.update(status="error", error=f"{type(exc).__name__}: {exc}",
                      traceback=traceback.format_exc()[-4000:])
    finally:
        shd.set_axis_env(None)
    _write(path, record)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", *MESHES, "all"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--outdir", default=os.path.abspath(ARTIFACT_DIR))
    args = ap.parse_args(argv)

    archs = (list(ARCH_IDS) + ["gpc-mnist", "gpc-mnist-optx"]
             if (args.all or args.arch is None) else [args.arch])
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", *MESHES] if args.mesh == "all" else [args.mesh]

    n_fail = 0
    for arch in archs:
        for shape in shapes[:1] if arch.startswith("gpc-mnist") else shapes:
            for mesh in meshes:
                rec = run_cell(arch, shape, args.outdir, args.force, mesh=mesh)
                line = (f"{rec['arch']:24s} {rec['shape']:14s} {rec['mesh']:6s} "
                        f"{rec['status']:7s}")
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
