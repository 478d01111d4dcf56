"""Model assembly: decoder-only LMs, hybrid stacks and the encoder–decoder.

The port of ``repro.models.transformer``.  The stack is a ``ModuleList`` of
``n_layers`` blocks, each run in turn (the reference stacks its parameters
per period and scans them; layer ``j·period + i`` here is period ``j``,
block ``i`` there): dense and hybrid mixers (``cfg.layer_kinds()``) and
FFNs ``mlp``, ``moe`` or ``moe+mlp`` (``cfg.ffn_kinds()``; arctic's dense
residual adds the MLP to the MoE output).  An encoder–decoder
(``cfg.is_encdec``, seamless) adds ``encoder``: ``encoder_layers``
attention + MLP blocks run non-causally over the source (``src_embeds``,
or ``src_tokens`` through the embedding) with sinusoidal positions from 0,
then its own final norm; every decoder block then cross-attends
(``cross_norm``, ``cross_attn``) to K/V projected once per layer from the
encoder's output (:func:`_cross_memory`), and the decoder takes no
positions of its own, as the reference's.  Three modes share the block
code:

* :func:`forward_hidden` — full sequence, no cache;
* :func:`prefill` — full sequence with cache write-back (serving; an
  encoder–decoder encodes here and carries the cross K/V in
  ``DecodeState.memory``);
* :func:`decode_step` — one token against the carried caches (and memory).

Every entry point takes ``backend`` (``auto`` | ``cuda`` | ``plain`` |
``reference``, see :mod:`repro_torch.kernels.ops`) and hands it to the
kernels: on CUDA tensors ``auto`` runs the flash-attention (K9) and SSD
scan (K10) kernels, on CPU tensors their plain versions.  MoE layers sum
their auxiliary losses into :func:`forward_hidden`'s second output.

With ``cfg.remat``, a full-sequence pass that autograd records (no caches,
as the reference's ``jax.checkpoint`` of each period; the encoder's stack
too) runs each block under non-reentrant ``torch.utils.checkpoint``, a
decoder block with its layer's cross K/V as an input: its activations are
recomputed in the backward, the kernels through their custom ops, the MoE
layers on the forward's expert ids (``moe.remat_contexts``).  Inside
a ``torch.func`` transform or under forward-mode AD (the Hessian-free
LM's GGN products) blocks are not checkpointed: saved-tensor hooks do not
compose with them, and forward mode saves nothing for a backward.
:func:`lm_loss` is the training loss: the reference's chunked
cross-entropy, whose backward recomputes one chunk of logits at a time.

Built at tensor-parallel degree ``tp`` (:func:`init`), a model has the
reference's padded attention heads; with DTensor parameters
(``convert.distribute``) and an axis environment bound
(``launch.mesh.bind``) every entry point runs on the mesh: residuals are
constrained to the batch layout after each block (``sharding.shard``, as
the reference's), plain tensors count as replicated
(``sharding.on_mesh``), and the loss reduces the vocab-sharded logits
over ``model`` (:class:`_VocabShards`), so it is the unsharded loss.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.autograd import forward_ad
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mamba as ssm
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    compute_dtype,
    embed_apply,
    embed_init,
    lm_head_weights,
    mlp_apply,
    mlp_init,
    norm_apply,
    norm_init,
    sinusoidal_positions,
)
from repro_torch.models.sharding import is_distributed, on_mesh, shard

Cache = Union[attn.KVCache, ssm.SSMState]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """``mixer_norm`` + ``attn`` or ``ssm``, with ``cross`` then
    ``cross_norm`` + ``cross_attn``, then ``ffn_norm`` + ``mlp``, ``moe`` or
    both (``moe+mlp``)."""

    def __init__(self, generator, cfg: ModelConfig, mixer: str, ffn: str, device,
                 cross: bool = False, tp: int = 1):
        super().__init__()
        self.mixer_norm = norm_init(cfg, device=device)
        if mixer == "attn":
            self.attn = attn.attn_init(generator, cfg, device=device, tp=tp)
        else:
            self.ssm = ssm.mamba_init(generator, cfg, device=device)
        if cross:
            self.cross_norm = norm_init(cfg, device=device)
            self.cross_attn = attn.attn_init(generator, cfg, device=device, tp=tp)
        if ffn != "none":
            self.ffn_norm = norm_init(cfg, device=device)
        if ffn in ("mlp", "moe+mlp"):
            self.mlp = mlp_init(generator, cfg, device=device)
        if ffn in ("moe", "moe+mlp"):
            self.moe = moe_mod.moe_init(generator, cfg, device=device)

    def forward(self, x, cfg: ModelConfig, **kw):
        """:func:`_block_apply` on this block (so that
        ``torch.func.functional_call`` can run it on given parameters)."""
        return _block_apply(self, x, cfg, **kw)


def _block_apply(block: Block, x, cfg: ModelConfig, *, causal=True, cache=None,
                 memory=None, positions=None, backend="auto"):
    """One residual block; returns ``(x, new_cache, aux)``, ``aux`` the MoE
    loss (None without a MoE FFN).  A cross block attends to ``memory``,
    its layer's ``(k, v)``."""
    h = norm_apply(block.mixer_norm, x, cfg)
    if hasattr(block, "attn"):
        out, new_cache = attn.attn_apply(block.attn, h, cfg, causal=causal, cache=cache,
                                         positions=positions, backend=backend)
    else:
        out, new_cache = ssm.mamba_apply(block.ssm, h, cfg, state=cache, backend=backend)
    x = shard(x + out, "batch", None, None)
    if hasattr(block, "cross_attn"):
        h = norm_apply(block.cross_norm, x, cfg)
        out, _ = attn.attn_apply(block.cross_attn, h, cfg, causal=False, memory=memory,
                                 backend=backend)
        x = x + out
    aux = None
    if hasattr(block, "ffn_norm"):
        h = norm_apply(block.ffn_norm, x, cfg)
        y = None
        if hasattr(block, "moe"):
            y, aux = moe_mod.moe_apply(block.moe, h, cfg)
        if hasattr(block, "mlp"):
            ym = mlp_apply(block.mlp, h, cfg)
            y = ym if y is None else y + ym
        x = shard(x + y, "batch", None, None)
    return x, new_cache, aux


class Encoder(nn.Module):
    """An encoder–decoder's ``blocks`` (``encoder_layers`` attention + MLP
    blocks) and ``final_norm``."""

    def __init__(self, generator, cfg: ModelConfig, device, tp: int = 1):
        super().__init__()
        self.blocks = nn.ModuleList(Block(generator, cfg, "attn", "mlp", device, tp=tp)
                                    for _ in range(cfg.encoder_layers))
        self.final_norm = norm_init(cfg, device=device)


class Model(nn.Module):
    """``embed``, ``blocks`` (one per layer), ``final_norm`` and, for an
    encoder–decoder, ``encoder``; built for ``cfg`` at tensor-parallel
    degree ``tp`` (kept as ``self.cfg``, ``self.tp``)."""

    def __init__(self, generator, cfg: ModelConfig, device, tp: int = 1):
        super().__init__()
        self.cfg, self.tp = cfg, tp
        self.embed = embed_init(generator, cfg, device=device)
        self.blocks = nn.ModuleList(
            Block(generator, cfg, mixer, ffn, device, cross=cfg.cross_attention, tp=tp)
            for mixer, ffn in zip(cfg.layer_kinds(), cfg.ffn_kinds())
        )
        self.final_norm = norm_init(cfg, device=device)
        if cfg.is_encdec:
            self.encoder = Encoder(generator, cfg, device, tp)

    def forward(self, fn, *args, **kwargs):
        """``fn(self, *args, **kwargs)``: with
        ``torch.func.functional_call(model, params, (fn, ...))`` any entry
        point of this module (:func:`lm_loss`, :func:`forward_hidden`) runs
        on the parameters ``params`` (a dict keyed by parameter name)."""
        return fn(self, *args, **kwargs)


def init(generator: torch.Generator, cfg: ModelConfig, *, device="cuda", tp: int = 1) -> Model:
    """The model's parameters in ``cfg.param_dtype`` on ``device``, drawn
    from ``generator`` (a generator on that device) with the reference's
    distributions (its numbers differ: see :mod:`repro_torch.convert` to
    carry the reference's parameters over), its attention laid out for a
    ``tp``-way ``model`` axis (``attention.padded_q_heads``)."""
    return Model(generator, cfg, device, tp)


def _remat(x: torch.Tensor, cfg: ModelConfig, caches, blocks) -> bool:
    """Whether the blocks run checkpointed: ``cfg.remat``, no caches, and a
    pass that autograd records (through ``x`` or the first block's
    parameters: an encoder's input is data) outside any ``torch.func``
    transform or forward-mode AD (see the module's docstring)."""
    if not (cfg.remat and caches is None and torch.is_grad_enabled()):
        return False
    probes = (x, next(blocks[0].parameters()))
    return any(t.requires_grad for t in probes) and not any(
        torch._C._functorch.is_functorch_wrapped_tensor(t)
        or forward_ad.unpack_dual(t).tangent is not None for t in probes)


def _block_rerun(block: Block, x, cfg: ModelConfig, kw, *named):
    return torch.func.functional_call(block, dict(named), (x, cfg), kw)


def _stack_apply(blocks, x, cfg: ModelConfig, *, causal=True, caches=None, memory=None,
                 backend="auto"):
    """Every block of ``blocks`` in turn, block ``i`` with ``caches[i]`` and
    ``memory[i]`` where given; returns ``(x, new caches | None, aux)``,
    ``aux`` the f32 sum of the MoE layers' losses (0 without any)."""
    remat = _remat(x, cfg, caches, blocks)
    new_caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, block in enumerate(blocks):
        kw = dict(causal=causal, cache=None if caches is None else caches[i],
                  memory=None if memory is None else memory[i], backend=backend)
        if remat:
            # The block's parameters go in as inputs: the recompute runs
            # after a functional_call that supplied them has restored the
            # module's own.  Its MoE layers reuse the forward's expert ids;
            # its cross K/V (in kw) are inputs too, so their gradients
            # reach the encoder.
            x, nc, a = checkpoint(_block_rerun, block, x, cfg, kw,
                                  *(dict(block.named_parameters()).items()),
                                  use_reentrant=False, preserve_rng_state=False,
                                  context_fn=moe_mod.remat_contexts)
        else:
            x, nc, a = _block_apply(block, x, cfg, **kw)
        new_caches.append(nc)
        if a is not None:
            aux = aux + a
    return x, (new_caches if caches is not None else None), aux


def _tokens(tokens, device) -> torch.Tensor:
    if isinstance(tokens, np.ndarray):
        return torch.as_tensor(tokens.astype(np.int64), device=device)
    return tokens.to(device)


def _decoder_inputs(params: Model, batch, cfg: ModelConfig):
    """Token ids, or precomputed embeddings for ``input_mode ==
    "embeddings"``; numpy inputs go to the model's device."""
    device = params.embed.table.device
    if cfg.input_mode == "embeddings" and "embeds" in batch:
        return torch.as_tensor(batch["embeds"], device=device).to(compute_dtype(cfg))
    return embed_apply(params.embed, _tokens(batch["tokens"], device), cfg)


def _add_positions(x, cfg: ModelConfig, start: int = 0):
    """Absolute sinusoidal positions for a decoder-only model without RoPE
    (callers skip an encoder–decoder's decoder: the reference adds it
    none)."""
    if cfg.rope:
        return x
    return x + sinusoidal_positions(x.shape[1], x.shape[2], x.dtype, start=start,
                                    device=x.device)[None]


def _encode(params: Model, batch, cfg: ModelConfig, *, backend="auto"):
    """The encoder over ``batch["src_embeds"]`` (``input_mode ==
    "embeddings"``) or ``batch["src_tokens"]``: sinusoidal positions from 0,
    the non-causal stack, its final norm; ``(B, S_src, D)``."""
    device = params.embed.table.device
    if cfg.input_mode == "embeddings":
        x = torch.as_tensor(batch["src_embeds"], device=device).to(compute_dtype(cfg))
    else:
        x = embed_apply(params.embed, _tokens(batch["src_tokens"], device), cfg)
    x = x + sinusoidal_positions(x.shape[1], x.shape[2], x.dtype, device=device)[None]
    x, _, _ = _stack_apply(params.encoder.blocks, x, cfg, causal=False, backend=backend)
    return norm_apply(params.encoder.final_norm, x, cfg)


def _cross_memory(params: Model, enc_out, cfg: ModelConfig):
    """Each decoder layer's cross-attention ``(k, v)``, a list."""
    return [attn.encode_memory(block.cross_attn, enc_out, cfg) for block in params.blocks]


def _decoder_start(params: Model, batch, cfg: ModelConfig, backend):
    """The decoder's input and, for an encoder–decoder, the memory of the
    encoded source (None otherwise)."""
    x = _decoder_inputs(params, batch, cfg)
    if not cfg.is_encdec:
        return _add_positions(x, cfg), None
    return x, _cross_memory(params, _encode(params, batch, cfg, backend=backend), cfg)


@on_mesh
def forward_hidden(params: Model, batch, cfg: ModelConfig, *, backend="auto"):
    """Full-sequence decoder forward; returns ``(hidden (B, S, D), aux)``
    with ``aux`` the f32 sum of the MoE layers' losses (0 without any), as
    the reference returns it.  An encoder–decoder's ``batch`` also holds
    its source (:func:`_encode`)."""
    x, memory = _decoder_start(params, batch, cfg, backend)
    x, _, aux = _stack_apply(params.blocks, x, cfg, causal=True, memory=memory,
                             backend=backend)
    return norm_apply(params.final_norm, x, cfg), aux


@on_mesh
def lm_loss(params: Model, batch, cfg: ModelConfig, *, backend="auto"):
    """Causal-LM loss: chunked cross-entropy plus the MoE aux term.

    ``batch`` holds ``tokens`` (or ``embeds``), an encoder–decoder's source
    (``src_embeds`` or ``src_tokens``) and ``labels`` (int, −1 = masked),
    numpy or tensors.  Returns ``(loss, {"xent", "aux",
    "tokens"})``, as the reference does."""
    hidden, aux = forward_hidden(params, batch, cfg, backend=backend)
    w = lm_head_weights(params.embed, cfg)
    labels = _tokens(batch["labels"], hidden.device)
    xent, n_tok = _chunked_xent(hidden, w, labels, cfg)
    loss = xent + cfg.router_aux_coef * aux
    return loss, {"xent": xent, "aux": aux, "tokens": n_tok}


def _chunk_logits(h, w, vocab_size: int):
    """One chunk's f32 logits with the padded vocab rows masked to −1e30."""
    logits = (h @ w).float()
    if logits.shape[-1] > vocab_size:
        logits[..., vocab_size:] = -1e30
    return logits


class _ChunkedXent(torch.autograd.Function):
    """Σ softmax cross-entropy of ``hidden @ w`` over label-valid rows,
    ``chunk`` sequence rows at a time.  Only ``hidden``, ``w`` and the
    labels are saved: the backward recomputes each chunk's logits and forms
    its ``softmax − onehot`` there, so no more than one chunk's (B, chunk,
    V) logits exists at a time.  The logits' gradient is cast to the
    products' dtype before the two products, as the reference's cast
    transposes; ``w``'s is summed over the chunks in f32."""

    @staticmethod
    def forward(hidden, w, labels, vocab_size, chunk):
        if is_distributed(hidden):
            return _VocabShards(hidden, w, labels).loss(vocab_size, chunk)
        tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for s0 in range(0, hidden.shape[1], chunk):
            logits = _chunk_logits(hidden[:, s0 : s0 + chunk], w, vocab_size)
            lab = labels[:, s0 : s0 + chunk]
            m = logits.amax(dim=-1, keepdim=True)
            lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
            ll = logits.gather(-1, lab.clamp(min=0)[..., None])[..., 0]
            tot = tot + torch.where(lab >= 0, lse - ll, 0.0).sum()
        return tot

    @staticmethod
    def setup_context(ctx, inputs, output):
        hidden, w, labels, vocab_size, chunk = inputs
        ctx.save_for_backward(hidden, w, labels)
        ctx.vocab_size, ctx.chunk = vocab_size, chunk

    @staticmethod
    def backward(ctx, g):
        hidden, w, labels = ctx.saved_tensors
        if is_distributed(hidden):
            return _VocabShards(hidden, w, labels).grads(g, ctx.vocab_size, ctx.chunk) + (
                None, None, None)
        dh = torch.empty_like(hidden)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for s0 in range(0, hidden.shape[1], ctx.chunk):
            h = hidden[:, s0 : s0 + ctx.chunk]
            lab = labels[:, s0 : s0 + ctx.chunk]
            dlogits = torch.softmax(_chunk_logits(h, w, ctx.vocab_size), dim=-1)
            dlogits.scatter_add_(-1, lab.clamp(min=0)[..., None],
                                 torch.full(lab.shape + (1,), -1.0, device=h.device))
            dlogits = (dlogits * ((lab >= 0) * g)[..., None]).to(h.dtype)
            dh[:, s0 : s0 + ctx.chunk] = dlogits @ w.T
            dw += (h.reshape(-1, h.shape[-1]).T @ dlogits.reshape(-1, w.shape[1])).float()
        return dh, dw.to(w.dtype), None, None, None


class _VocabShards:
    """:class:`_ChunkedXent` on a mesh: the logits sharded over ``model`` by
    vocabulary (the reference's ``shard(logits, "batch", None, "model")``),
    each rank holding its batch rows and its columns of ``w``.  The
    softmax's max, its sum and the label's logit are reduced over
    ``model`` (``funcol.all_reduce``), so the loss is the unsharded one,
    partial over the batch axes; the backward forms each rank's columns of
    ``softmax − onehot`` and returns ``dhidden`` partial over ``model`` and
    ``dw`` partial over the batch axes."""

    def __init__(self, hidden, w, labels):
        from torch.distributed.tensor import Partial, Replicate, Shard

        from repro_torch.models.sharding import get_axis_env, placements

        self.mesh = mesh = hidden.device_mesh
        names = mesh.mesh_dim_names
        self.model = names.index("model")
        batch = placements((get_axis_env().get("batch"),), names)
        self.rows = tuple(Replicate() if i == self.model else p for i, p in enumerate(batch))
        self.h = shard(hidden, "batch", None, None).to_local()
        self.lab = shard(labels, "batch", None).to_local()
        self.w = w.redistribute(mesh, placements((None, "model"), names)).to_local()
        tp = mesh.size(self.model)
        self.offset = mesh.get_local_rank("model") * -(-w.shape[1] // tp)
        self.hidden, self.full_w = hidden, w
        self.partial_rows = tuple(Partial() if isinstance(p, Shard) else p for p in self.rows)
        self.Partial, self.Shard = Partial, Shard

    def _reduce(self, t, op):
        from torch.distributed import _functional_collectives as funcol

        return funcol.all_reduce(t, op, (self.mesh, self.model))

    def _chunk(self, s0, chunk, vocab_size):
        """A chunk's local f32 logits (the padded vocab masked), ``lse``,
        labels and the mask of labels in this rank's columns."""
        h = self.h[:, s0 : s0 + chunk]
        lab = self.lab[:, s0 : s0 + chunk]
        logits = (h @ self.w).float()
        cols = self.offset + torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(cols < vocab_size, logits, -1e30)
        m = self._reduce(logits.amax(dim=-1, keepdim=True), "max")
        lse = m[..., 0] + torch.log(self._reduce(torch.exp(logits - m).sum(dim=-1), "sum"))
        own = (lab >= self.offset) & (lab < self.offset + logits.shape[-1])
        return h, lab, logits, lse, own

    def _local_label(self, lab, own, width):
        return torch.where(own, lab - self.offset, 0).clamp(max=width - 1)[..., None]

    def loss(self, vocab_size, chunk):
        from torch.distributed.tensor import DTensor

        tot = torch.zeros((), dtype=torch.float32, device=self.h.device)
        for s0 in range(0, self.h.shape[1], chunk):
            _, lab, logits, lse, own = self._chunk(s0, chunk, vocab_size)
            ll = logits.gather(-1, self._local_label(lab, own, logits.shape[-1]))[..., 0]
            ll = self._reduce(torch.where(own, ll, 0.0), "sum")
            tot = tot + torch.where(lab >= 0, lse - ll, 0.0).sum()
        return DTensor.from_local(tot, self.mesh, self.partial_rows, run_check=False)

    def grads(self, g, vocab_size, chunk):
        from torch.distributed.tensor import DTensor, Replicate

        if is_distributed(g):
            g = g.redistribute(self.mesh, (Replicate(),) * self.mesh.ndim).to_local()
        dh = torch.empty_like(self.h)
        dw = torch.zeros(self.w.shape, dtype=torch.float32, device=self.w.device)
        for s0 in range(0, self.h.shape[1], chunk):
            h, lab, logits, lse, own = self._chunk(s0, chunk, vocab_size)
            dlogits = torch.exp(logits - lse[..., None])
            dlogits.scatter_add_(-1, self._local_label(lab, own, logits.shape[-1]),
                                 torch.where(own, -1.0, 0.0)[..., None])
            dlogits = (dlogits * ((lab >= 0) * g)[..., None]).to(h.dtype)
            dh[:, s0 : s0 + chunk] = dlogits @ self.w.T
            dw += (h.reshape(-1, h.shape[-1]).T @ dlogits.reshape(-1, self.w.shape[1])).float()
        model_partial = tuple(self.Partial() if i == self.model else p
                              for i, p in enumerate(self.rows))
        w_grad = tuple(self.Shard(1) if i == self.model else p
                       for i, p in enumerate(self.partial_rows))
        return (DTensor.from_local(dh, self.mesh, model_partial, run_check=False,
                                   shape=self.hidden.shape, stride=self.hidden.stride()),
                DTensor.from_local(dw.to(self.w.dtype), self.mesh, w_grad, run_check=False,
                                   shape=self.full_w.shape, stride=self.full_w.stride()))


def _chunked_xent(hidden, w, labels, cfg: ModelConfig):
    """Mean softmax cross-entropy over the valid labels, over sequence
    chunks of ``cfg.logits_chunk`` (see :class:`_ChunkedXent`); returns
    ``(xent, valid label count)``."""
    chunk = min(cfg.logits_chunk, hidden.shape[1])
    cnt = (labels >= 0).sum().to(torch.int32)
    tot = _ChunkedXent.apply(hidden, w, labels, cfg.vocab_size, chunk)
    return tot / torch.clamp(cnt, min=1), cnt


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    caches: List[Cache]  # one KVCache or SSMState per layer
    memory: Optional[list]  # cross-attention (k, v) per layer (encoder-decoder only)
    length: int


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, tp: int = 1, *,
                      device="cuda") -> DecodeState:
    caches = [
        attn.init_cache(cfg, batch, max_len, tp, device=device) if kind == "attn"
        else ssm.init_ssm_state(cfg, batch, device=device)
        for kind in cfg.layer_kinds()
    ]
    return DecodeState(caches=caches, memory=None, length=0)


def _logits(params: Model, x, cfg: ModelConfig):
    h = norm_apply(params.final_norm, x, cfg)
    return (h @ lm_head_weights(params.embed, cfg)).float()


@on_mesh
def prefill(params: Model, batch, state: DecodeState, cfg: ModelConfig, *, backend="auto"):
    """Consume the prompt, filling the caches; returns ``(state,
    last_logits (B, 1, padded vocab))``.  An encoder–decoder encodes the
    batch's source here and carries its cross K/V in the state's
    ``memory``."""
    x, memory = _decoder_start(params, batch, cfg, backend)
    memory = state.memory if memory is None else memory
    x, caches, _ = _stack_apply(params.blocks, x, cfg, causal=True, caches=state.caches,
                                memory=memory, backend=backend)
    logits = _logits(params, x[:, -1:, :], cfg)
    return DecodeState(caches=caches, memory=memory,
                       length=state.length + x.shape[1]), logits


@on_mesh
def decode_step(params: Model, tokens, state: DecodeState, cfg: ModelConfig, *, backend="auto"):
    """One serving step: new token(s) (B, s) → logits (B, s, padded vocab);
    the caches advance in place and the state's length by ``s``; an
    encoder–decoder's layers cross-attend to the state's ``memory``."""
    x = embed_apply(params.embed, _tokens(tokens, params.embed.table.device), cfg)
    if not cfg.is_encdec:
        x = _add_positions(x, cfg, start=state.length)
    x, caches, _ = _stack_apply(params.blocks, x, cfg, causal=True, caches=state.caches,
                                memory=state.memory, backend=backend)
    logits = _logits(params, x, cfg)
    return logits, DecodeState(caches=caches, memory=state.memory,
                               length=state.length + x.shape[1])
