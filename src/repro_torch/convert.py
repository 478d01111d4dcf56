"""Carry the reference's state into the port and back.

What a solve sequence carries from one solve to the next is its
``RecycleState`` plus the ``SolveSpec`` it runs under, a Nyström sketch
``(U, Λ)`` where it preconditions, and the Hessian-free optimizer's
``HFState`` (its recycle state, previous step and LM damping).  With these
helpers a sequence started in ``repro`` continues in ``repro_torch`` (and
back) and gives the same numbers; a state given whole splits into a
rank's share for the sharded engine.  The model zoo's parameters cross
with :func:`model_params_from_numpy` and :func:`model_params_to_numpy`
(and as the training step's dict with :func:`train_params_from_numpy`);
a training run's AdamW and PowerSGD states and batches with
:func:`adam_state_from_numpy`, :func:`powersgd_state_from_numpy` and
:func:`train_batch_from_numpy`.
Arrays cross as numpy, so neither package imports the other.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.api import SolveSpec
from repro_torch.core.recycle import RecycleState
from repro_torch.models import sharding as shd
from repro_torch.models.attention import kv_sharded
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.optim.hessian_free import HFState


def recycle_state_from_numpy(
    W, AW, theta, systems_solved, drift, *, dtype: torch.dtype, device="cuda"
) -> RecycleState:
    """A :class:`RecycleState` on ``device`` from the reference's arrays.

    A ``deflsmr`` state carries as it is: its ``AW`` slot holds the
    normal-operator products ``NW = (AᵀA + λI)W`` in both packages.
    """

    def tensor(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return RecycleState(
        W=tensor(W),
        AW=tensor(AW),
        theta=tensor(theta),
        systems_solved=torch.as_tensor(
            int(np.asarray(systems_solved)), dtype=torch.int32, device=device
        ),
        drift=tensor(drift).reshape(()),
    )


def recycle_state_shard_from_numpy(
    W, AW, theta, systems_solved, drift, *, rank: int, world_size: int,
    dtype: torch.dtype, device="cuda",
) -> RecycleState:
    """Rank ``rank``'s share of a reference :class:`RecycleState` given
    whole: its columns ``[rank·n/p, (rank+1)·n/p)`` of ``W`` and ``AW``
    (the layout of :class:`repro_torch.launch.SolveMesh`), the k-sized and
    scalar leaves replicated.  Ready for ``solve(..., mesh=)`` on that rank."""
    W, AW = np.asarray(W), np.asarray(AW)
    n = W.shape[1]
    if n % world_size:
        raise ValueError(f"W has {n} columns, not divisible by {world_size} ranks")
    cols = slice(rank * (n // world_size), (rank + 1) * (n // world_size))
    return recycle_state_from_numpy(
        W[:, cols], AW[:, cols], theta, systems_solved, drift, dtype=dtype, device=device
    )


def recycle_state_to_numpy(state: RecycleState) -> Dict[str, np.ndarray]:
    """The inverse: ``{W, AW, theta, systems_solved, drift}`` as numpy."""
    return {
        name: getattr(state, name).detach().cpu().numpy()
        for name in ("W", "AW", "theta", "systems_solved", "drift")
    }


def nystrom_sketch_from_numpy(
    U, lam, *, dtype: torch.dtype, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A reference Nyström sketch (``randomized_nystrom``'s ``(U, lam)``:
    ``(rank, n)`` rows in descending eigenvalue order) on ``device``, ready
    for :func:`repro_torch.core.nystrom_preconditioner` or
    :func:`repro_torch.core.kernel_nystrom_preconditioner`."""
    return (
        torch.as_tensor(np.array(U), dtype=dtype, device=device),
        torch.as_tensor(np.array(lam), dtype=dtype, device=device),
    )


def spec_from_fields(fields: dict) -> SolveSpec:
    """A :class:`SolveSpec` from the reference's ``dataclasses.asdict(spec)``
    without its ``strategy`` (the port's default strategy is the
    reference's, :class:`HarmonicRitz`)."""
    if "strategy" in fields:
        raise ValueError(
            "pass the spec's fields without 'strategy': strategies are "
            "objects of each package, not data"
        )
    return SolveSpec(**fields)


def hf_state_from_numpy(
    recycle: dict, delta_prev, damping, step, last_cg_iters, *,
    dtype: torch.dtype, device="cuda",
) -> HFState:
    """An :class:`repro_torch.optim.HFState` on ``device`` from the
    reference's: ``recycle`` is ``{W, AW, theta, systems_solved, drift}``
    (its bootstrap basis included), ``delta_prev`` an array or a dict of
    arrays shaped like the parameters.  The LM damping stays float32 and
    the counters int32, as in the reference."""

    def tree(a):
        if isinstance(a, dict):
            return {key: tree(val) for key, val in a.items()}
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    def i32(a):
        return torch.as_tensor(int(np.asarray(a)), dtype=torch.int32, device=device)

    return HFState(
        recycle=recycle_state_from_numpy(**recycle, dtype=dtype, device=device),
        delta_prev=tree(delta_prev),
        damping=torch.as_tensor(np.float32(np.asarray(damping)), device=device),
        step=i32(step),
        last_cg_iters=i32(last_cg_iters),
    )


def hf_state_to_numpy(state: HFState) -> dict:
    """The inverse: the keyword arguments of :func:`hf_state_from_numpy`."""

    def tree(a):
        if isinstance(a, dict):
            return {key: tree(val) for key, val in a.items()}
        return a.detach().cpu().numpy()

    return {
        "recycle": recycle_state_to_numpy(state.recycle),
        "delta_prev": tree(state.delta_prev),
        "damping": tree(state.damping),
        "step": tree(state.step),
        "last_cg_iters": tree(state.last_cg_iters),
    }


# The reference's leaf names carry a sharding suffix (``_cs`` column-,
# ``_rs`` row-, ``_hs`` head-, ``_vs`` vocab-, ``_es`` expert-sharded); the
# port's are the names without it, and ``models.sharding`` holds the one
# table of suffixes (``leaf_suffix``): leaves absent there (``wk``, ``wv``,
# ``bk``, ``bv`` where the KV heads are replicated, the norms'
# ``scale``/``bias``, ``q_norm``, ``k_norm``, ``down_bias``, the MoE
# ``router``) have the same name in both.
_SUFFIXES = ("_cs", "_rs", "_hs", "_vs", "_es")


def _port_leaf(ref_name: str, sub: Optional[str] = None) -> str:
    """The port's name of the reference leaf ``ref_name`` of sub-module
    ``sub`` (``attn``, ``mlp``, ``moe``, ...)."""
    name, sfx = ref_name[:-3], ref_name[-3:]
    if sfx in _SUFFIXES and sfx in (shd.leaf_suffix(name, sub), shd.leaf_suffix(name, sub, True)):
        return name
    if sfx in _SUFFIXES or shd.leaf_suffix(ref_name, sub):
        raise KeyError(f"unknown reference parameter {ref_name!r}")
    return ref_name


def _ref_leaf(name: str, sub: Optional[str] = None, kv: bool = False) -> str:
    return name + shd.leaf_suffix(name, sub, kv)


def _unstack(blocks: list, n_layers: int, prefix: str, state: dict) -> None:
    """``blocks`` (a period's block trees, leaves stacked over periods) into
    ``state`` as ``{prefix}blocks.{layer}.{sub}.{leaf}``."""
    period = len(blocks)
    for i, block in enumerate(blocks):
        for sub, leaves in block.items():
            for leaf, arr in leaves.items():
                arr = np.asarray(arr)
                for j in range(n_layers // period):
                    state[f"{prefix}blocks.{j * period + i}.{sub}.{_port_leaf(leaf, sub)}"] = arr[j]


def model_state_from_numpy(tree: dict, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """A tree shaped like ``repro.models.init``'s parameters (nested dicts
    and lists of numpy arrays: the parameters, their gradients, Adam's
    moments, a flat vector unraveled) as a dict keyed by the port's
    parameter names.  The leading period axis of
    ``tree["periods"]["blocks"][i]`` is unstacked: layer ``j·period + i``
    is period ``j``, block ``i``; an encoder–decoder's
    ``tree["encoder"]["periods"]["blocks"][0]`` (period 1, stacked over
    ``encoder_layers``) becomes ``encoder.blocks.{layer}`` and its
    ``final_norm`` ``encoder.final_norm``."""
    state = {}
    groups = [("embed", tree["embed"]), ("final_norm", tree["final_norm"])]
    if cfg.is_encdec:
        groups.append(("encoder.final_norm", tree["encoder"]["final_norm"]))
        _unstack(tree["encoder"]["periods"]["blocks"], cfg.encoder_layers, "encoder.", state)
    for group, leaves in groups:
        for leaf, arr in leaves.items():
            state[f"{group}.{_port_leaf(leaf)}"] = np.asarray(arr)
    _unstack(tree["periods"]["blocks"], cfg.n_layers, "", state)
    return state


def model_params_from_numpy(tree: dict, cfg: ModelConfig, *, tp: int = 1,
                            device="cuda") -> Model:
    """A :class:`repro_torch.models.transformer.Model` on ``device`` holding
    the reference's parameters (``tree`` as :func:`model_state_from_numpy`
    takes it), built at tensor-parallel degree ``tp`` (the reference's
    ``init(..., tp=tp)``: padded query heads, ``wk_cs``/``bk_hs`` names
    where the KV heads shard)."""
    state = model_state_from_numpy(tree, cfg)
    model = Model(None, cfg, "meta", tp)
    expected = set(model.state_dict())
    if set(state) != expected:
        raise KeyError(f"parameter trees differ: missing {sorted(expected - set(state))}, "
                       f"unexpected {sorted(set(state) - expected)}")
    model.load_state_dict(
        {k: torch.as_tensor(np.array(v), device=device) for k, v in state.items()},
        assign=True,
    )
    return model.requires_grad_(False)


def distribute(model: Model, mesh, env) -> Model:
    """``model`` with each parameter a DTensor laid out by
    ``launch.mesh.param_shardings`` on ``mesh`` under ``env``: every rank
    holds the same full parameters (the same seed, or the same tree) and
    keeps its own shards (no communication)."""
    from repro_torch.launch import mesh as mesh_lib

    shardings = mesh_lib.param_shardings(mesh, model, env)
    for name, p in list(model.named_parameters()):
        module_name, _, leaf = name.rpartition(".")
        module = model.get_submodule(module_name)
        dt = mesh_lib.place(p.detach(), mesh, shardings[name])
        setattr(module, leaf, torch.nn.Parameter(dt, requires_grad=p.requires_grad))
    return model


def _arrays(module, sub=None, kv=False) -> dict:
    return {_ref_leaf(k, sub, kv): v.detach().cpu().numpy()
            for k, v in module.named_parameters()}


def _stack(blocks, period: int, kv: bool = False) -> list:
    """``blocks`` (one module a layer) as the reference's period blocks,
    each leaf stacked over the periods."""
    out = []
    for i in range(period):
        layers = blocks[i::period]
        stacked = {}
        for sub, _ in layers[0].named_children():
            per_layer = [_arrays(getattr(layer, sub), sub, kv) for layer in layers]
            stacked[sub] = {k: np.stack([p[k] for p in per_layer]) for k in per_layer[0]}
        out.append(stacked)
    return out


def model_params_to_numpy(model: Model) -> dict:
    """The inverse: the reference's parameter tree (nested dicts and lists
    of numpy arrays, blocks stacked over periods) from a port model."""
    kv = kv_sharded(model.cfg, model.tp)
    tree = {"embed": _arrays(model.embed),
            "periods": {"blocks": _stack(model.blocks, model.cfg.period(), kv)},
            "final_norm": _arrays(model.final_norm)}
    if model.cfg.is_encdec:
        tree["encoder"] = {"periods": {"blocks": _stack(model.encoder.blocks, 1, kv)},
                           "final_norm": _arrays(model.encoder.final_norm)}
    return tree


def _tensors(tree, device, dtype=None):
    """A tree of numpy arrays (dicts, lists) as the same tree of tensors."""
    if isinstance(tree, dict):
        return {key: _tensors(val, device, dtype) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(val, device, dtype) for val in tree)
    return torch.as_tensor(np.array(tree), dtype=dtype, device=device)


def train_params_from_numpy(tree: dict, cfg: ModelConfig, *, device="cuda") -> Dict[str, torch.Tensor]:
    """The reference's parameter tree as the training step's parameter
    dict (:func:`repro_torch.launch.params_dict`'s keys)."""
    return _tensors(model_state_from_numpy(tree, cfg), device)


def adam_state_from_numpy(mu, nu, count, *, cfg: Optional[ModelConfig] = None, device="cuda"):
    """An :class:`repro_torch.optim.AdamState` from the reference's moments
    and count.  With ``cfg`` the moments are model parameter trees and come
    keyed by the port's parameter names; without, any tree of arrays keeps
    its structure."""
    from repro_torch.optim.adam import AdamState

    def tree(t):
        return _tensors(model_state_from_numpy(t, cfg) if cfg is not None else t, device,
                        torch.float32)

    return AdamState(mu=tree(mu), nu=tree(nu),
                     count=torch.as_tensor(int(np.asarray(count)), dtype=torch.int32, device=device))


def powersgd_state_from_numpy(q, error, *, device="cuda"):
    """A :class:`repro_torch.optim.PowerSGDState` from the reference's
    per-leaf bases and error memories (trees of arrays, structure kept), so
    that both packages start from the same ``Q``."""
    from repro_torch.optim.grad_compress import PowerSGDState

    return PowerSGDState(q=_tensors(q, device, torch.float32),
                         error=_tensors(error, device, torch.float32))


def train_batch_from_numpy(batch: dict, *, dtype: Optional[torch.dtype] = None,
                           device="cuda") -> Dict[str, torch.Tensor]:
    """The reference's train-step batch as tensors on ``device``: integer
    arrays (``tokens``, ``labels``, ``src_tokens``) as int64, float arrays
    (an encoder–decoder's ``src_embeds``, ``embeds``) as floats, in
    ``dtype`` or, without one, their own (bf16 included)."""

    def tensor(val):
        arr = np.asarray(val)
        if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: exact through f32
            return torch.as_tensor(arr.astype(np.float32), device=device).to(
                dtype or torch.bfloat16)
        if arr.dtype.kind == "f":
            t = torch.as_tensor(arr, device=device)
            return t if dtype is None else t.to(dtype)
        return torch.as_tensor(arr.astype(np.int64), device=device)

    return {key: tensor(val) for key, val in batch.items()}
