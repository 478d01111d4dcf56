"""The training entry point: model, AdamW and the fault-tolerant loop on one device
(the port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --preset full \\
        --batch 4 --seq 4096 --steps 6

runs on the card (``--device cpu`` for the CPU); ``--arch`` takes every id
of :data:`repro_torch.configs.ARCH_IDS`.  Parameters are f32,
drawn from a generator seeded 0, and the model computes in ``cfg.dtype``;
batches come from :class:`repro_torch.data.TokenPipeline`; the
:class:`repro_torch.runtime.Trainer` checkpoints, restarts and tracks
stragglers.  The mesh is 1 × 1: tensor parallelism and ZeRO wait for the
sharding layouts (ROADMAP queue 1).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.runtime import Trainer, TrainerConfig


def build(arch: str, preset: str, batch: int, seq: int, lr: float, device="cuda", *,
          backend: str = "auto", n_layers: Optional[int] = None):
    """``(cfg, mesh, (params, opt_state), pipeline, step_fn)``; ``step_fn(state,
    batch) -> (state, metrics)`` is what :class:`Trainer` drives.  ``n_layers``
    cuts the configuration's depth (a multiple of its period)."""
    cfg = get_config(arch) if preset == "full" else get_smoke_config(arch)
    if n_layers is not None:
        if n_layers % cfg.period():
            raise ValueError(f"{arch}: {n_layers} layers is not a multiple of the period "
                             f"{cfg.period()}")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    mesh = mesh_lib.make_train_mesh(device)
    model = models.init(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    params = steps_lib.params_dict(model)
    opt = steps_lib.init_opt_state(params)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=batch, seq_len=seq)
    train_step = steps_lib.make_train_step(cfg, lr=lr, backend=backend)

    def step_fn(state, batch):
        params, opt = state
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
    n_dev = torch.cuda.device_count() if mesh.device.type == "cuda" else 1
    print(f"arch={cfg.name} devices={n_dev} mesh={mesh.axes} "
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
        device=mesh.device,
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
