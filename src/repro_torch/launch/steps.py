"""Step functions and the model-FLOPs count (the port of
``repro.launch.steps``).

* :func:`make_train_step` — loss, gradients, AdamW update;
* :func:`make_prefill_step` / :func:`make_serve_step` — close a
  configuration (and the kernel ``backend``) over
  :func:`repro_torch.models.prefill` / :func:`decode_step`.

* :func:`input_specs` / :func:`decode_state_specs` — every input of a
  cell as empty tensors (on the meta device by default: nothing is
  allocated), with the reference's shapes and dtypes; what the dry-run
  (:mod:`repro_torch.launch.dryrun`) traces against.

Training parameters are a dict keyed by the model's parameter names
(``dict(model.named_parameters())``); the step runs the model on them with
``torch.func.functional_call``.

Modality-frontend stubs, as the reference's: seamless feeds precomputed
audio frame embeddings ``(B, S_src, d_model)``; chameleon feeds VQ token
ids (its frontend emits ids into the shared vocabulary).
"""

from __future__ import annotations

import torch

from repro_torch import models
from repro_torch.configs.registry import ShapeSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import compute_dtype
from repro_torch.models.sharding import is_distributed, plain_replicated
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
    with torch.enable_grad(), plain_replicated():
        loss, metrics = torch.func.functional_call(
            skeleton, leaves, (models.lm_loss, batch, cfg), {"backend": backend})
        grads = torch.autograd.grad(loss, list(leaves.values()))
    metrics = {key: val.detach() for key, val in metrics.items()}
    grads = dict(zip(leaves, grads))
    if any(is_distributed(g) for g in grads.values()):
        # Each gradient laid out as its parameter: a ZeRO shard's sum over
        # the batch axes is a reduce-scatter.
        grads = {name: g.redistribute(params[name].device_mesh, params[name].placements)
                 for name, g in grads.items()}
    return loss.detach(), metrics, grads


def make_train_step(cfg: ModelConfig, *, lr: float = 1e-4, moment_dtype=torch.float32,
                    backend: str = "auto", tp: int = 1):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``:
    :func:`loss_and_grads`, then AdamW with weight decay 0.1; metrics
    ``loss``, ``xent`` and ``aux`` (0-d tensors).  ``params`` is a dict as
    :func:`params_dict` gives it, of a model built at tensor-parallel
    degree ``tp`` (DTensors on a mesh: the update then runs on each rank's
    shards)."""
    skeleton = models.transformer.Model(None, cfg, "meta", tp)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(cfg, params, batch, backend=backend,
                                              skeleton=skeleton)
        with plain_replicated():
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


def input_specs(cfg: ModelConfig, shape: ShapeSpec, device="meta") -> dict:
    """The batch of one cell: int32 ``tokens`` (and ``labels`` to train),
    an encoder–decoder's ``src_embeds`` ``(B, S, d_model)`` in the compute
    dtype; a prefill's decoder prompt is ``max(source_len // 4, 64)``
    tokens there, a decode cell's one new token (the cache depth is the
    decode state's)."""
    b, s = shape.global_batch, shape.seq_len
    act = compute_dtype(cfg)

    def empty(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=device)

    if shape.kind == "train":
        batch = {"tokens": empty((b, s)), "labels": empty((b, s))}
    elif shape.kind == "prefill":
        s_dec = max(cfg.source_len // 4, 64) if cfg.is_encdec else s
        batch = {"tokens": empty((b, s_dec))}
    else:
        return {"tokens": empty((b, 1))}
    if cfg.is_encdec:
        batch = {"src_embeds": empty((b, s, cfg.d_model), act), **batch}
    return batch


def decode_state_specs(cfg: ModelConfig, shape: ShapeSpec, device="meta",
                       skeleton=None, tp: int = 1) -> models.DecodeState:
    """The decode state of a decode cell, its caches ``seq_len`` deep; an
    encoder–decoder's also holds the cross-attention memory a prefill of
    ``source_len`` frames leaves (``_cross_memory`` on ``skeleton``, by
    default a model of ``cfg`` on ``device``: the reference's ``build2``)."""
    b, s = shape.global_batch, shape.seq_len
    state = models.init_decode_state(cfg, b, max_len=s, tp=tp, device=device)
    if not cfg.is_encdec:
        return state
    skeleton = models.transformer.Model(None, cfg, device, tp) if skeleton is None else skeleton
    src = torch.zeros((b, cfg.source_len, cfg.d_model), dtype=compute_dtype(cfg), device=device)
    with plain_replicated():  # a distributed skeleton: the source is the same on every rank
        return state._replace(memory=models.transformer._cross_memory(skeleton, src, cfg))


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """6·N_active·tokens (train) or 2·N_active·tokens (inference)."""
    n_active = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # one new token per sequence
