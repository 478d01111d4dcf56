"""Serving step functions and the model-FLOPs count.

The port of ``repro.launch.steps``' serving half: ``make_prefill_step``
and ``make_serve_step`` close a configuration (and the kernel ``backend``)
over :func:`repro_torch.models.prefill` / :func:`decode_step`.  Training
steps come with the training slice; the reference's abstract input specs
serve its XLA dry-run, which is re-targeted later.
"""

from __future__ import annotations

from repro_torch import models
from repro_torch.configs.registry import ShapeSpec
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, max_len: int, *, backend: str = "auto"):
    """``(params, batch, state) -> (state, last_logits)``."""

    def prefill_step(params, batch, state):
        return models.prefill(params, batch, state, cfg, backend=backend)

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, backend: str = "auto"):
    """``(params, tokens, state) -> (logits, state)``."""

    def serve_step(params, tokens, state):
        return models.decode_step(params, tokens, state, cfg, backend=backend)

    return serve_step


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """6·N_active·tokens (train) or 2·N_active·tokens (inference)."""
    n_active = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # one new token per sequence
