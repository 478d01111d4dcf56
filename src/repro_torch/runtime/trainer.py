"""Fault-tolerant training loop (the counterpart of ``repro.runtime.trainer``).

* **checkpoint / restart**: resumes from the newest readable checkpoint of
  the state (parameters and optimizer state) and the step; the data
  pipeline is addressed by step, so the stream continues exactly;
* **failure handling**: an exception in a step (an injected fault, a lost
  device) restores the newest checkpoint and replays from it, within a
  bounded number of restarts;
* **stragglers**: a step slower than ``straggler_factor`` × the median of
  the last ``straggler_window`` steps is logged and counted;
* **preemption**: :meth:`Trainer.request_stop` checkpoints synchronously
  and leaves the loop.

Checkpoints go through :class:`repro_torch.checkpoint.CheckpointManager`
(the reference's on-disk layout).  Each step ends in a synchronize on the
state's device, so the step times are device times.  A restore puts every
leaf on ``device`` (the template leaf's device when None): the port's
counterpart of the reference's ``state_shardings``.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import pytree as pt

Tree = Any


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 10
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    max_restarts: int = 5
    straggler_factor: float = 3.0
    straggler_window: int = 20


@dataclasses.dataclass
class TrainerEvents:
    restarts: int = 0
    stragglers: int = 0
    step_times: List[float] = dataclasses.field(default_factory=list)
    log: List[str] = dataclasses.field(default_factory=list)


def _synchronize(state: Tree) -> None:
    """Wait for the device work that produced ``state``."""
    for leaf in pt.tree_leaves(state):
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type == "cuda":
                torch.cuda.synchronize(leaf.device)
            return


class Trainer:
    """Drives ``step_fn(state, batch) -> (state, metrics)`` with fault
    tolerance.  ``state`` is one tree of tensors (parameters and optimizer
    state); ``make_batch(step)`` must be deterministic."""

    def __init__(
        self,
        step_fn: Callable[[Tree, Any], Any],
        make_batch: Callable[[int], Any],
        init_state: Tree,
        config: TrainerConfig,
        *,
        device=None,
        fault_hook: Optional[Callable[[int], None]] = None,
        time_fn: Callable[[], float] = time.perf_counter,
    ):
        self.step_fn = step_fn
        self.make_batch = make_batch
        self.config = config
        self.device = device
        self.fault_hook = fault_hook
        self.time_fn = time_fn  # injectable clock (deterministic tests)
        self.events = TrainerEvents()
        self.ckpt = CheckpointManager(config.checkpoint_dir, keep=config.keep_checkpoints)
        self._stop = False

        restored = self.ckpt.restore_latest(init_state, device)
        if restored is not None:
            self.start_step, self.state, _ = restored
            self.events.log.append(f"resumed from step {self.start_step}")
        else:
            self.start_step, self.state = 0, init_state

    def request_stop(self):  # preemption signal (SIGTERM handler target)
        self._stop = True

    def run(self) -> Dict[str, Any]:
        cfg = self.config
        step = self.start_step
        restarts = 0
        last_metrics: Dict[str, Any] = {}

        while step < cfg.total_steps:
            if self._stop:
                self._save(step, blocking=True)
                self.events.log.append(f"preempted at step {step}")
                break
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)  # may raise (injected failure)
                t0 = self.time_fn()
                batch = self.make_batch(step)
                self.state, metrics = self.step_fn(self.state, batch)
                _synchronize(self.state)
                dt = self.time_fn() - t0
                self._track_straggler(step, dt)
                last_metrics = metrics
                step += 1
                if step % cfg.checkpoint_every == 0:
                    self._save(step, blocking=not cfg.async_checkpoint)
            except Exception as exc:  # noqa: BLE001 — any step failure
                restarts += 1
                self.events.restarts = restarts
                self.events.log.append(f"step {step} failed: {exc!r}")
                if restarts > cfg.max_restarts:
                    raise RuntimeError(f"exceeded max_restarts={cfg.max_restarts}") from exc
                restored = self.ckpt.restore_latest(self.state, self.device)
                if restored is not None:
                    step, self.state, _ = restored
                    self.events.log.append(f"restored to step {step}")
                else:
                    step = 0
                    self.events.log.append("no checkpoint — restart from 0")

        self.ckpt.wait()
        self._save(step, blocking=True)
        return {"final_step": step, "state": self.state, "metrics": last_metrics,
                "events": self.events}

    def _save(self, step: int, blocking: bool):
        self.ckpt.save(self.state, step, extra={"step": step}, blocking=blocking)

    def _track_straggler(self, step: int, dt: float):
        times = self.events.step_times
        times.append(dt)
        if len(times) >= 5:
            med = statistics.median(times[-self.config.straggler_window:])
            if dt > self.config.straggler_factor * med:
                self.events.stragglers += 1
                self.events.log.append(
                    f"straggler: step {step} took {dt:.3f}s "
                    f"(median {med:.3f}s) — mitigation hook fired")
