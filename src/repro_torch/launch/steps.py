"""Step functions and the model-FLOPs count (the port of
``repro.launch.steps``).

* :func:`make_train_step` — loss, gradients, AdamW update;
* :func:`make_prefill_step` / :func:`make_serve_step` — close a
  configuration (and the kernel ``backend``) over
  :func:`repro_torch.models.prefill` / :func:`decode_step`.

Training parameters are a dict keyed by the model's parameter names
(``dict(model.named_parameters())``); the step runs the model on them with
``torch.func.functional_call``.  The reference's abstract input specs
(``input_specs``, ``decode_state_specs``) serve its XLA dry-run, which is
re-targeted to meta-device tensors later (ROADMAP queue 1, the dry-run).
"""

from __future__ import annotations

import torch

from repro_torch import models
from repro_torch.configs.registry import ShapeSpec
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adam_init, adam_update


def params_dict(model: models.transformer.Model) -> dict:
    """A model's parameters as the dict the training step takes."""
    return {name: p.detach() for name, p in model.named_parameters()}


def loss_and_grads(cfg: ModelConfig, params: dict, batch, *, backend: str = "auto",
                   skeleton=None):
    """``(loss, metrics, grads)`` of ``lm_loss`` at ``params`` (a dict as
    :func:`params_dict` gives it; ``grads`` keyed alike), by
    ``torch.autograd.grad`` through ``torch.func.functional_call`` on
    ``skeleton`` (a model of ``cfg``, by default one on the meta device)."""
    skeleton = models.transformer.Model(None, cfg, "meta") if skeleton is None else skeleton
    leaves = {name: p.detach().requires_grad_(True) for name, p in params.items()}
    with torch.enable_grad():
        loss, metrics = torch.func.functional_call(
            skeleton, leaves, (models.lm_loss, batch, cfg), {"backend": backend})
        grads = torch.autograd.grad(loss, list(leaves.values()))
    metrics = {key: val.detach() for key, val in metrics.items()}
    return loss.detach(), metrics, dict(zip(leaves, grads))


def make_train_step(cfg: ModelConfig, *, lr: float = 1e-4, moment_dtype=torch.float32,
                    backend: str = "auto"):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``:
    :func:`loss_and_grads`, then AdamW with weight decay 0.1; metrics
    ``loss``, ``xent`` and ``aux`` (0-d tensors).  ``params`` is a dict as
    :func:`params_dict` gives it."""
    skeleton = models.transformer.Model(None, cfg, "meta")

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(cfg, params, batch, backend=backend,
                                              skeleton=skeleton)
        new_params, new_opt = adam_update(grads, opt_state, params, lr=lr, weight_decay=0.1)
        return new_params, new_opt, {"loss": loss, "xent": metrics["xent"], "aux": metrics["aux"]}

    return train_step


def init_opt_state(params, moment_dtype=torch.float32):
    state = adam_init(params)
    if moment_dtype != torch.float32:
        cast = {name: t.to(moment_dtype) for name, t in state.mu.items()}
        state = state._replace(mu=cast, nu={name: t.to(moment_dtype)
                                            for name, t in state.nu.items()})
    return state


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
