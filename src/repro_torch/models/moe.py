"""Mixture-of-Experts FFN: top-k routing, capacity-based dispatch.

The port of ``repro.models.moe``, with its semantics:

  1. router logits in f32 → softmax → top-k ``(gates, expert ids)`` per
     token, the gates renormalised over the k;
  2. the assignments sorted by expert (stable, so tokens have token-major
     priority), each taking a position in its expert; positions at or past
     the capacity are dropped and contribute 0;
  3. the kept tokens gathered into an ``(E, C, d)`` buffer per dispatch
     group, every expert run as one batched product pair, the outputs
     weighted by their gates and combined back per token.

``moe_apply_grouped`` (the default) makes each batch row its own dispatch
group with capacity ``max(int(s·k/e·cf), k)``; ``moe_apply_global`` pools
all ``b·s`` tokens under :func:`capacity`.  Their auxiliary load-balancing
losses differ as the reference's do.

The expert products are plain batched matrix products (the reference
computes them outside any Pallas kernel).  Dispatch and combine are row
gathers through :class:`GatherRows`, whose backward is itself a gather:
a token's gradient sums its k slots in the order of its k choices, so no
float atomics run and two backward passes agree bit for bit (autograd's
backward of an index would scatter-add).  No ``(B, E, S, d)`` tensor is
formed: the ``(B·S, d)`` rows are indexed directly.

On a mesh the expert stacks are sharded over ``model`` (``_es``): the
routing runs whole on every rank (f32, replicated, as P12 needs), each
rank dispatches and combines its own experts' assignments on its local
tensors, and the output, partial over ``model``, is summed by the
``shard`` after it.  The grouped dispatcher keeps the batch sharded; the
global one gathers it (its capacity pools every token).

:func:`record_routing` lets a caller read each layer's routing decisions
(expert ids and kept masks), e.g. to compare two runs; under
:func:`replay_routing` the layers take a recorded run's expert ids instead
of their own top-k, so that two runs whose router logits differ by
rounding can be compared at the same routing.  A block that
``torch.utils.checkpoint`` recomputes in the backward takes the expert ids
its forward took (:func:`remat_contexts`), whatever context the backward
runs in: remat never routes again.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _param, dense_init, param_dtype, weight
from repro_torch.models.sharding import _axes, get_axis_env, is_distributed, shard


class MoE(nn.Module):
    """``router`` (d, E) and the expert stacks ``gate``/``up`` (E, d, f)
    and ``down`` (E, f, d) (SwiGLU), or ``up`` and ``down`` (GELU): the
    reference's ``router``, ``gate_es``, ``up_es``, ``down_es``."""

    def __init__(self, generator, cfg: ModelConfig, device):
        super().__init__()
        pd, d, e = param_dtype(cfg), cfg.d_model, cfg.n_experts
        f = cfg.moe_d_ff or cfg.d_ff

        def expert_stack(d_in, d_out):
            w = torch.randn((e, d_in, d_out), generator=generator, dtype=pd, device=device)
            return _param(w * (1.0 / d_in) ** 0.5)

        self.router = dense_init(generator, d, e, pd, device)
        if cfg.mlp_type == "swiglu":
            self.gate = expert_stack(d, f)
        self.up = expert_stack(d, f)
        self.down = expert_stack(f, d)


def moe_init(generator, cfg: ModelConfig, *, device="cuda") -> MoE:
    return MoE(generator, cfg, device)


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.experts_per_token / cfg.n_experts * cfg.capacity_factor)
    return max(c, cfg.experts_per_token)


class Routing(NamedTuple):
    """One layer's routing: ``experts`` (…, S, k) ids in each token's order
    of choice, ``kept`` (…, S, k) whether the assignment found a slot."""

    experts: torch.Tensor
    kept: torch.Tensor


_RECORDS: List[Optional[list]] = [None]
_REPLAY: List[Optional[Iterator[Routing]]] = [None]
_REMAT: List[Optional[Tuple[str, object]]] = [None]  # set by remat_contexts


@contextlib.contextmanager
def record_routing():
    """Within the block, every MoE layer appends its :class:`Routing` (on
    the host) to the yielded list, in the order the layers run (a
    recompute under ``cfg.remat`` appends nothing)."""
    records: list = []
    previous, _RECORDS[0] = _RECORDS[0], records
    try:
        yield records
    finally:
        _RECORDS[0] = previous


@contextlib.contextmanager
def replay_routing(records):
    """Within the block, every MoE layer takes the expert ids of the next of
    ``records`` (:func:`record_routing`'s list of a run that called the
    same layers on the same shapes) in place of its top-k; its gates are its
    own probabilities at those ids, renormalised, and capacity drops
    assignments by its own rule."""
    previous, _REPLAY[0] = _REPLAY[0], iter(records)
    try:
        yield
    finally:
        _REPLAY[0] = previous


class _RematRouting:
    """Sets what :func:`_choose` does inside ``torch.utils.checkpoint``:
    ``keep`` appends each layer's expert ids to ``kept``, ``reuse`` takes
    them back in order.  Re-enterable: each entry reads ``kept`` afresh."""

    def __init__(self, mode: str, kept: list):
        self.mode, self.kept = mode, kept

    def __enter__(self):
        self.previous = _REMAT[0]
        _REMAT[0] = (self.mode, self.kept if self.mode == "keep" else iter(self.kept))

    def __exit__(self, *exc):
        _REMAT[0] = self.previous


def remat_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: the checkpointed forward
    keeps its MoE layers' expert ids (on the device), and the recompute
    takes them back instead of routing (and records nothing), so the
    backward's activations belong to the forward's routing even where it
    runs outside the forward's :func:`replay_routing`."""
    kept: list = []
    return _RematRouting("keep", kept), _RematRouting("reuse", kept)


def _note(eidx, keep):
    if _RECORDS[0] is not None and not (_REMAT[0] and _REMAT[0][0] == "reuse"):
        _RECORDS[0].append(Routing(eidx.detach().cpu(), keep.detach().cpu()))


class GatherRows(torch.autograd.Function):
    """``out[m] = src[idx[m]]`` (zeros where ``idx[m] < 0``) for ``src``
    (N, …), ``idx`` (M,).  ``inv`` (N, r) lists, for each source row, the
    ≤ r output rows that read it (−1 for none), in a fixed order; the
    backward is the gather ``dsrc[n] = Σᵢ dout[inv[n, i]]`` summed in that
    order.  Forward mode gathers the tangent as the forward gathers."""

    @staticmethod
    def forward(src, idx, inv):
        return _gather(src, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, idx, inv = inputs
        ctx.save_for_backward(idx, inv)
        ctx.save_for_forward(idx, inv)

    @staticmethod
    def backward(ctx, dout):
        _, inv = ctx.saved_tensors
        return _gather(dout, inv.reshape(-1)).unflatten(0, inv.shape).sum(dim=1), None, None

    @staticmethod
    def jvp(ctx, tsrc, _tidx, _tinv):
        idx, _ = ctx.saved_tensors
        return _gather(tsrc, idx)


def _gather(src, idx):
    valid = (idx >= 0).view(-1, *([1] * (src.dim() - 1)))
    return torch.where(valid, src[idx.clamp(min=0)], 0)


def _slot_maps(flat_e, keep, pos, e: int, cap: int):
    """For G dispatch groups of A assignments each (``flat_e``, ``keep``,
    ``pos`` (G, A)): the flat slot ``(g·e + expert)·cap + pos`` of every
    assignment (−1 if dropped) and, per slot, the flat assignment
    ``g·A + a`` it holds (−1 if empty)."""
    g, a_n = flat_e.shape
    n_slots = g * e * cap
    dev = flat_e.device
    group = torch.arange(g, device=dev)[:, None]
    slot = torch.where(keep, (group * e + flat_e) * cap + pos, -1)
    # Each kept slot is written once (an integer write, no sum); dropped
    # assignments all land on one spare row, cut off after.  No boolean
    # mask, so no host sync.
    asg = torch.full((n_slots + 1,), -1, dtype=torch.long, device=dev)
    asg[torch.where(keep, slot, n_slots).reshape(-1)] = torch.arange(g * a_n, device=dev)
    return slot.reshape(-1), asg[:n_slots]


def _probs(p: MoE, x2):
    """The f32 softmax router over the rows of ``x2`` (…, d)."""
    return torch.softmax((x2 @ weight(p.router, x2.dtype)).float(), dim=-1)


def _choose(probs, cfg: ModelConfig):
    """``(gates, expert ids)`` of router probabilities ``probs``: the top-k
    (or the replayed or remat-kept ids), the gates renormalised."""
    # The gates are gathered at the ids on every path, so that a recompute
    # on kept ids runs (and saves for the backward) what its forward did.
    mode, kept = _REMAT[0] or (None, None)
    if mode == "reuse":
        eidx = next(kept)
    elif _REPLAY[0] is None:
        eidx = torch.topk(probs.detach(), cfg.experts_per_token, dim=-1).indices
    else:
        eidx = next(_REPLAY[0]).experts.to(probs.device).reshape(*probs.shape[:-1], -1)
    if mode == "keep":
        kept.append(eidx)
    gates = torch.gather(probs, -1, eidx)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, eidx


def _positions(flat_e, e: int):
    """Per dispatch group (rows of ``flat_e`` (G, A)): each assignment's
    position within its expert in token-major order, and the counts per
    expert."""
    order = torch.argsort(flat_e, dim=1, stable=True)
    counts = torch.zeros((flat_e.shape[0], e), dtype=flat_e.dtype, device=flat_e.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))  # integer counts: exact
    starts = torch.cumsum(counts, dim=1) - counts
    sorted_e = torch.gather(flat_e, 1, order)
    pos_sorted = torch.arange(flat_e.shape[1], device=flat_e.device) - torch.gather(
        starts, 1, sorted_e)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)  # a permutation
    return pos, counts


def _experts(p: MoE, xg, cfg: ModelConfig):
    """Every expert on its ``(E, C, d)`` rows (leading group axes folded
    into C), one batched product each; activations in f32 cast back, as
    the reference's."""
    dt = xg.dtype
    if cfg.mlp_type == "swiglu":
        g = torch.bmm(xg, p.gate.to(dt))
        u = torch.bmm(xg, p.up.to(dt))
        h = F.silu(g.float()).to(dt) * u
    else:
        h = F.gelu(torch.bmm(xg, p.up.to(dt)).float(), approximate="tanh").to(dt)
    return torch.bmm(h, p.down.to(dt))


def _dispatch_run(p: MoE, x2, flat_e, keep, pos, cap: int, cfg: ModelConfig):
    """Gather each group's kept rows of ``x2`` (G·S, d) into the expert
    slots of ``p``'s experts (``flat_e`` counts from its first), run them,
    and return their outputs per slot ``(G·E·cap, d)`` with the slot and
    assignment maps."""
    k, e = cfg.experts_per_token, p.up.shape[0]
    g = flat_e.shape[0]
    slot, asg = _slot_maps(flat_e, keep, pos, e, cap)
    tok = torch.where(asg >= 0, asg // k, -1)
    xg = GatherRows.apply(x2, tok, slot.view(-1, k))  # (G·E·cap, d)
    xg = xg.view(g, e, cap, -1).transpose(0, 1).reshape(e, g * cap, -1)
    yo = _experts(p, xg, cfg).view(e, g, cap, -1).transpose(0, 1).reshape(g * e * cap, -1)
    return yo, slot, asg


def _own(p: MoE, flat_e, keep, first: int, cfg: ModelConfig):
    """The assignments of ``p``'s experts ``[first, first + E_p)``: their
    ids counted from ``first`` and their kept mask (all of them when ``p``
    holds every expert)."""
    e = p.up.shape[0]
    if e == cfg.n_experts:
        return flat_e, keep
    local = flat_e - first
    return local, keep & (local >= 0) & (local < e)


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN on (B, S, D); returns ``(output, f32 aux loss)``, with the
    dispatcher ``cfg.moe_dispatch`` names (``grouped`` or ``global``)."""
    if cfg.moe_dispatch == "grouped":
        return moe_apply_grouped(p, x, cfg)
    return moe_apply_global(p, x, cfg)


def moe_apply_grouped(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """Each batch row its own dispatch group, capacity per (row, expert):
    the gate-weighted expert outputs of a token's kept assignments summed
    in its order of choice; aux ``E · mean_b Σ_e frac_be · mean_s probs``."""
    probs = _probs(p, x)  # (B, S, E)
    y, frac = _on_expert_ranks(_grouped_rank, p, x, probs, cfg, pooled=False)
    aux = cfg.n_experts * torch.mean(torch.sum(frac * probs.mean(dim=1), dim=-1))
    return shard(y, "batch", None, None), aux.float()


def _grouped_rank(p: MoE, x, probs, cfg: ModelConfig, first: int):
    """:func:`moe_apply_grouped`'s routing and dispatch over ``p``'s experts
    (from ``first``): ``(output, frac (B, E))``."""
    b, s, d = x.shape
    k, e = cfg.experts_per_token, cfg.n_experts
    cap = max(int(s * k / e * cfg.capacity_factor), k)
    gates, eidx = _choose(probs, cfg)  # (B, S, k)
    flat_e = eidx.reshape(b, s * k)
    pos, counts = _positions(flat_e, e)
    keep = pos < cap
    _note(eidx, keep.view(b, s, k))
    flat_e, keep = _own(p, flat_e, keep, first, cfg)
    yo, slot, asg = _dispatch_run(p, x.reshape(b * s, d), flat_e, keep, pos, cap, cfg)
    vals = GatherRows.apply(yo, slot, asg.view(-1, 1)).view(b, s, k, d)
    w = gates.to(x.dtype) * keep.view(b, s, k).to(x.dtype)
    return (vals * w[..., None]).sum(dim=2), counts.float() / (s * k)


def moe_apply_global(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """One capacity pool of :func:`capacity` over all ``b·s`` tokens: each
    slot's expert output weighted by its gate, a token's kept slots summed
    in its order of choice; aux ``E · Σ_e frac_e · mean_t probs``."""
    probs = _probs(p, x)  # (B, S, E)
    y, frac = _on_expert_ranks(_global_rank, p, x, probs, cfg, pooled=True)
    aux = cfg.n_experts * torch.sum(frac * probs.reshape(-1, cfg.n_experts).mean(dim=0))
    return shard(y, "batch", None, None), aux.float()


def _global_rank(p: MoE, x, probs, cfg: ModelConfig, first: int):
    """:func:`moe_apply_global`'s routing and dispatch over ``p``'s experts
    (from ``first``), its ``b·s`` tokens pooled: ``(output, frac (E,))``."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.experts_per_token, cfg.n_experts
    cap = capacity(cfg, t)
    x2 = x.reshape(t, d)
    gates, eidx = _choose(probs.reshape(t, e), cfg)  # (T, k)
    flat_e = eidx.reshape(1, t * k)
    pos, counts = _positions(flat_e, e)
    keep = pos < cap
    _note(eidx.view(b, s, k), keep.view(b, s, k))
    flat_e, keep = _own(p, flat_e, keep, first, cfg)
    yo, slot, asg = _dispatch_run(p, x2, flat_e, keep, pos, cap, cfg)
    gate_slot = GatherRows.apply(gates.reshape(-1).to(x.dtype), asg, slot.view(-1, 1))
    yo = yo * gate_slot[:, None]
    vals = GatherRows.apply(yo, slot, asg.view(-1, 1)).view(t, k, d)
    return vals.sum(dim=1).view(b, s, d), counts[0].float() / (t * k)


def _on_expert_ranks(fn, p: MoE, x, probs, cfg: ModelConfig, *, pooled: bool):
    """``fn(p, x, probs, cfg, 0)``; on DTensors, on each rank's local
    tensors with its own experts (the ``_es`` stacks sharded over
    ``model``): the routing runs on every rank (f32, replicated), each
    rank combines its experts' outputs and the output stays partial over
    ``model`` until the caller's ``shard`` sums it.  A grouped dispatch
    keeps the batch sharded; a pooled one gathers it, since its capacity
    pools every token."""
    if not is_distributed(x):
        return fn(p, x, probs, cfg, 0)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    batch = set(_axes(get_axis_env().get("batch"))) if not pooled else set()
    tp = mesh.size(names.index("model")) if "model" in names else 1
    first = (mesh.get_local_rank("model") if "model" in names else 0) * (cfg.n_experts // tp)

    def each(model, data):
        return tuple(model if n == "model" else data if n in batch else Replicate()
                     for n in names)

    rows, part = each(Replicate(), Shard(0)), each(Partial(), Shard(0))
    stacks = tuple(getattr(p, n) for n in ("gate", "up", "down") if hasattr(p, n))
    weight = each(Shard(0), Replicate())
    weight_grad = each(Shard(0), Partial())

    def run(x, probs, *local):
        experts = SimpleNamespace(**dict(zip(("gate", "up", "down")[-len(local):], local)))
        return fn(experts, x, probs, cfg, first)

    return local_map(
        run,
        out_placements=(part, rows),
        in_placements=(rows, rows) + (weight,) * len(stacks),
        in_grad_placements=(part, part) + (weight_grad,) * len(stacks),
        device_mesh=mesh,
        redistribute_inputs=True,
    )(x, probs, *stacks)
