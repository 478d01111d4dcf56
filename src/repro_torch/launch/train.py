"""The training entry point: mesh, model, AdamW and the fault-tolerant loop
(the port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --preset full \\
        --batch 4 --seq 4096 --steps 6

runs on the card (``--device cpu`` for the CPU); ``--arch`` takes every id
of :data:`repro_torch.configs.ARCH_IDS`.  Parameters are f32,
drawn from a generator seeded 0, and the model computes in ``cfg.dtype``;
batches come from :class:`repro_torch.data.TokenPipeline`; the
:class:`repro_torch.runtime.Trainer` checkpoints, restarts and tracks
stragglers.  :func:`make_mesh_auto` takes the reference's mesh for the
ranks of the process group: the production meshes at 256 and 512 ranks,
``(n, 1)`` below (ZeRO and data parallelism over ``n``).  A process with
no process group, one card, runs on one device with plain tensors.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch import convert, models
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.runtime import Trainer, TrainerConfig


def make_mesh_auto(device="cuda"):
    """The reference's choice of mesh for the ranks of the initialized
    process group: ``(2, 16, 16)`` from 512 ranks, ``(16, 16)`` from 256,
    else ``(n, 1) = ("data", "model")``; ``None`` (one device) without a
    process group."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return None
    n = dist.get_world_size()
    kind = torch.device(device).type
    if n >= 256:
        return mesh_lib.make_production_mesh(multi_pod=n >= 512, device_type=kind)
    return mesh_lib.make_model_mesh((n, 1), device_type=kind)


def build(arch: str, preset: str, batch: int, seq: int, lr: float, device="cuda", *,
          backend: str = "auto", n_layers: Optional[int] = None):
    """``(cfg, mesh, (params, opt_state), pipeline, step_fn)``; ``step_fn(state,
    batch) -> (state, metrics)`` is what :class:`Trainer` drives.  ``n_layers``
    cuts the configuration's depth (a multiple of its period).  On a mesh
    of more than one rank the parameters and the AdamW moments are
    DTensors laid out by ``mesh.param_shardings`` (its ``model`` axis the
    tensor-parallel degree) and each batch is sharded over the DP axes."""
    cfg = get_config(arch) if preset == "full" else get_smoke_config(arch)
    if n_layers is not None:
        if n_layers % cfg.period():
            raise ValueError(f"{arch}: {n_layers} layers is not a multiple of the period "
                             f"{cfg.period()}")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    mesh = make_mesh_auto(device)
    tp = 1 if mesh is None else mesh_lib.mesh_axes(mesh)["model"]
    model = models.init(torch.Generator(device=device).manual_seed(0), cfg, device=device, tp=tp)
    env = None
    if mesh is not None and mesh.size() > 1:
        env = mesh_lib.bind(mesh)
        model = convert.distribute(model, mesh, env)
    params = steps_lib.params_dict(model)
    opt = steps_lib.init_opt_state(params)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=batch, seq_len=seq)
    train_step = steps_lib.make_train_step(cfg, lr=lr, backend=backend, tp=tp)

    def step_fn(state, batch):
        params, opt = state
        if env is not None:
            batch = mesh_lib.distribute_batch(
                mesh, {k: torch.as_tensor(v, device=device) for k, v in batch.items()}, env)
        params, opt, metrics = train_step(params, opt, batch)
        return (params, opt), metrics

    return cfg, mesh, (params, opt), pipe, step_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCH_IDS)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args(argv)

    cfg, mesh, state, pipe, step_fn = build(args.arch, args.preset, args.batch, args.seq,
                                            args.lr, args.device)
    n_dev = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 1
    print(f"arch={cfg.name} devices={n_dev} mesh={mesh_lib.mesh_axes(mesh)} "
          f"params={cfg.total_params()/1e6:.1f}M")

    losses = []

    def logging_step(state, batch):
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if len(losses) % 20 == 0:
            first = np.mean(losses[:10])
            print(f"step {len(losses):5d} loss {losses[-1]:.4f} (first10 {first:.4f}) "
                  f"aux {float(metrics['aux']):.4f}", flush=True)
        return state, metrics

    trainer = Trainer(
        logging_step, pipe.make_batch, state,
        TrainerConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                      checkpoint_dir=args.ckpt_dir),
        device=torch.device(args.device),
    )
    out = trainer.run()
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(
        f"done: {out['final_step']} steps, loss {first:.4f} -> {last:.4f} "
        f"({'LEARNED' if last < first - 0.1 else 'no clear drop'}) "
        f"restarts={out['events'].restarts} stragglers={out['events'].stragglers}"
    )


if __name__ == "__main__":
    main()
