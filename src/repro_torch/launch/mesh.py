"""The meshes: the solve group (the port's counterpart of
``repro.launch.mesh.make_solve_mesh``) and the model meshes (of
``make_production_mesh`` and the reference's sharding rules).

The reference shards the Krylov engine over a 1-D ``"solve"`` mesh of
devices driven by one program.  The port runs one process per rank under
``torch.distributed`` (SPMD): every rank runs the same solve on its own
block of the coordinates, and the ranks meet only in collectives.
:func:`make_solve_mesh` wraps the process group the caller has set up
(the whole world, or the subgroup of its first ``n_devices`` ranks) as a
:class:`SolveMesh`, which owns the two collectives of the sharded engine
and counts them in :data:`COLLECTIVES`:

* ``all_reduce`` — a sum over the ranks, in place;
* ``all_gather`` — every rank's block, concatenated along one dimension.

Both go to ``torch.distributed`` as they are, on either backend: NCCL,
one rank per card, and gloo, the backend for several ranks on one card
(NCCL refuses two ranks on one GPU), which takes CUDA tensors for both
collectives on the card's PyTorch (2.11) and stages them through host
memory itself.

The helpers :meth:`SolveMesh.shard` / :meth:`SolveMesh.gather` (vectors
and ``(k, n)`` bases) and :meth:`SolveMesh.shard_state` /
:meth:`SolveMesh.gather_state` (a :class:`RecycleState`) take the roles
of the reference's ``solve_vector_sharding`` and
``solve_state_shardings``: rank ``i`` of ``p`` owns the contiguous block
of columns ``[i·n/p, (i+1)·n/p)``.

The model meshes are ``torch.distributed`` device meshes with the
reference's axis names: ``(n, 1) = ("data", "model")``, the production
``(16, 16)`` and ``(2, 16, 16) = ("pod", "data", "model")``
(:func:`make_production_mesh`, over the ranks of an initialized process
group: real ones, or a fake one for the dry-run).  :func:`axis_env_for` /
:func:`bind` bind the logical names of ``models.sharding`` to their axes
(``batch`` and ``fsdp`` over the data-parallel axes, ``model`` over
``model``; a batch the DP axes do not divide, ``long_500k``'s, is
replicated and its caches' sequence sharded over ``data``), and
:func:`param_shardings`, :func:`batch_shardings` and
:func:`decode_state_shardings` give the reference's layouts as DTensor
placements: tensor parallelism from the leaf names' suffixes, ZeRO-3
(:func:`_fsdp_augment`), batches over the DP axes, caches and states by
kind.  :func:`distribute_batch` / :func:`distribute_decode_state` (and
``convert.distribute`` for a model) lay the same full tensors on every
rank out as DTensors, each rank keeping its shard.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.models import sharding as shd

# Collectives issued through a SolveMesh, by kind (all ranks count their own).
COLLECTIVES = {"all_reduce": 0, "all_gather": 0}


@dataclasses.dataclass(eq=False)
class SolveMesh:
    """One rank's view of the solve group.

    Attributes:
      group: the process group (``None``: the default, whole world).
      size: its ranks, the world's first ``size``; the number of blocks
        the coordinates are split into.
      rank: this process's rank in the group; ``-1`` when this process is
        not a member (a subgroup built on every rank of the world).
      device: where this rank's tensors live.
      backend: the group's backend (``"nccl"`` or ``"gloo"``).
    """

    group: Optional[dist.ProcessGroup]
    size: int
    rank: int
    device: torch.device
    backend: str

    @property
    def member(self) -> bool:
        return self.rank >= 0

    # -- collectives ----------------------------------------------------

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        COLLECTIVES["all_reduce"] += 1
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes), concatenated along ``dim``."""
        COLLECTIVES["all_gather"] += 1
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    # -- layout helpers -------------------------------------------------

    def block(self, n: int) -> slice:
        """This rank's columns of a length-``n`` dimension."""
        if n % self.size:
            raise ValueError(
                f"length {n} is not divisible by the solve group's "
                f"{self.size} ranks"
            )
        step = n // self.size
        return slice(self.rank * step, (self.rank + 1) * step)

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the last dimension of a full vector or
        ``(k, n)`` basis, on this rank's device."""
        return t[..., self.block(t.shape[-1])].to(self.device).contiguous()

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`shard`: the full tensor on every rank
        (one ``all_gather``)."""
        return self.all_gather(t, dim=t.ndim - 1)

    def shard_state(self, state):
        """This rank's columns of a full :class:`RecycleState` (W, AW); the
        k-sized and scalar leaves are replicated."""
        return dataclasses.replace(
            state,
            W=self.shard(state.W),
            AW=self.shard(state.AW),
            theta=state.theta.to(self.device),
            systems_solved=state.systems_solved.to(self.device),
            drift=state.drift.to(self.device),
        )

    def gather_state(self, state):
        """A full :class:`RecycleState` from every rank's columns (two
        ``all_gather``\\ s): it feeds a solve at any other group size, or an
        unsharded one."""
        return dataclasses.replace(state, W=self.gather(state.W), AW=self.gather(state.AW))


def _local_device(device, global_rank: int) -> torch.device:
    """``cuda:<local rank mod device_count>`` for ``"cuda"``; as given else."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", global_rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_solve_mesh(n_devices: Optional[int] = None, *, device="cuda") -> SolveMesh:
    """The solve group over the process group the caller initialized.

    ``n_devices=None`` takes every rank of the world; a count takes the
    subgroup of the first ``n_devices`` ranks, built with
    ``torch.distributed.new_group``, which every rank of the world must
    call (ranks outside get a mesh whose ``member`` is False, and a solve
    on it raises).  ``device="cuda"`` places this rank on
    ``cuda:<local rank mod device_count>``, so that every rank of one
    card shares ``cuda:0``; ``device="cpu"`` keeps it on the host.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_solve_mesh needs an initialized torch.distributed process "
            "group (torch.distributed.init_process_group, or "
            "repro_torch.launch.run_ranks, which sets one up per rank)"
        )
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(
            f"n_devices={n_devices} out of range: the process group has "
            f"{world} ranks"
        )
    global_rank = dist.get_rank()
    if n == world:
        group = None
        rank = global_rank
    else:
        group = dist.new_group(list(range(n)))
        rank = global_rank if global_rank < n else -1
    return SolveMesh(
        group=group,
        size=n,
        rank=rank,
        device=_local_device(device, global_rank),
        backend=str(dist.get_backend()),
    )


# ---------------------------------------------------------------------------
# The model meshes: ("data", "model") and ("pod", "data", "model")
# ---------------------------------------------------------------------------

DP_AXES = ("pod", "data")


def make_model_mesh(shape, axes=("data", "model"), *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks of the initialized process group."""
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() < n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"need {n} ranks for mesh {tuple(shape)}, have {have}: initialize a "
                           "process group of that size first (run_ranks, or a fake one)")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's production mesh: ``(16, 16) = ("data", "model")``,
    256 ranks; multi-pod ``(2, 16, 16) = ("pod", "data", "model")``, 512
    ranks, ``pod`` a second data-parallel axis."""
    if multi_pod:
        return make_model_mesh((2, 16, 16), ("pod", "data", "model"), device_type=device_type)
    return make_model_mesh((16, 16), device_type=device_type)


def mesh_axes(mesh) -> dict:
    """``{axis: size}``; one device (``None``) is ``{"data": 1, "model": 1}``."""
    return {"data": 1, "model": 1} if mesh is None else shd.mesh_sizes(mesh)


def axis_env_for(mesh, *, batch_shardable: bool = True) -> Dict[str, Any]:
    """Logical-name binding for a mesh: ``batch`` and ``fsdp`` over the
    data-parallel axes, ``model`` over ``model``; a batch the DP axes do
    not divide (``long_500k``'s batch 1) is replicated and its caches'
    sequence dim sharded over ``data`` instead."""
    dp_axes = tuple(a for a in mesh.mesh_dim_names if a in DP_AXES)
    env: Dict[str, Any] = {
        "model": "model",
        "fsdp": dp_axes,
        "seq": None,
        "batch": dp_axes if batch_shardable else None,
    }
    if not batch_shardable:
        env["seq"] = "data"
    return env


def bind(mesh, *, batch_shardable: bool = True) -> Dict[str, Any]:
    """:func:`axis_env_for` bound (``models.sharding.set_axis_env``)."""
    env = axis_env_for(mesh, batch_shardable=batch_shardable)
    shd.set_axis_env(env, mesh)
    return env


def _fsdp_augment(spec: shd.Spec, shape, env, sizes: dict, stacked: bool) -> shd.Spec:
    """Shard the first un-sharded, divisible dim of a leaf over the
    ``fsdp`` axes (ZeRO-3), as the reference does for its ≥2-D leaves:
    those of the layers (``stacked``) count their period axis there, so a
    layer's vectors (norm scales, biases) are sharded too.  The port's
    leaves have no period axis to skip."""
    fsdp = env.get("fsdp")
    if not fsdp or len(shape) + stacked < 2:
        return spec
    size = math.prod(sizes[a] for a in fsdp)
    dims = list(spec) + [None] * (len(shape) - len(spec))
    for i, dim in enumerate(dims):
        if dim is None and shape[i] % size == 0 and shape[i] >= size:
            dims[i] = fsdp
            return tuple(dims)
    return spec


def param_specs(mesh, model, env) -> Dict[str, shd.Spec]:
    """``{parameter name: spec}`` of ``model`` on ``mesh``: its suffix's
    spec (``models.sharding``) with the ZeRO dim added."""
    from repro_torch.models.attention import kv_sharded

    sizes = shd.mesh_sizes(mesh)
    kv = kv_sharded(model.cfg, model.tp)
    out = {}
    for name, p in model.named_parameters():
        base = shd.leaf_dims(shd.ref_leaf_name(name, kv), p.dim())
        base = tuple(env.get(d) if d else None for d in base)
        stacked = name.startswith(("blocks.", "encoder.blocks."))
        out[name] = _fsdp_augment(base, tuple(p.shape), env, sizes, stacked)
    return out


def param_shardings(mesh, model, env) -> Dict[str, tuple]:
    """``{parameter name: DTensor placements}`` of ``model`` on ``mesh``
    (the reference's ``NamedSharding`` tree)."""
    return {name: shd.placements(spec, mesh.mesh_dim_names)
            for name, spec in param_specs(mesh, model, env).items()}


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def _batch_spec(mesh, shape, env) -> shd.Spec:
    b = env.get("batch")
    sizes = shd.mesh_sizes(mesh)
    if b and len(shape) >= 1 and shape[0] % math.prod(sizes[a] for a in shd._axes(b)) == 0:
        return (b,) + (None,) * (len(shape) - 1)
    return ()


def batch_shardings(mesh, batch: dict, env) -> Dict[str, tuple]:
    """Shard ``(B, ...)`` input batches over the DP axes (dim 0) where they
    divide B; else replicated."""
    return {k: shd.placements(_batch_spec(mesh, tuple(v.shape), env), mesh.mesh_dim_names)
            for k, v in batch.items()}


def _state_spec(kind: str, shape, env, sizes) -> shd.Spec:
    """A decode-state leaf's spec by its kind (the reference's rules
    without the period axis), axes that do not divide dropped."""
    batch, seq = env.get("batch"), env.get("seq")
    spec = {"ssd": (batch, "model", None, None), "conv": (batch, None, "model"),
            "memory": (batch, None, None, None), "cache": (batch, None, seq, None)}[kind]
    return tuple(ax if ax is not None and dim % math.prod(sizes[a] for a in shd._axes(ax)) == 0
                 else None for dim, ax in zip(shape, spec[: len(shape)]))


def decode_state_shardings(mesh, state, env):
    """The placements of a ``DecodeState``, shaped as it is (``KVCache``
    and ``SSMState`` per layer, cross memory ``(k, v)`` per layer,
    ``length`` a host int that needs none):

      ssd     (B, H, P, N)    → (batch, model, None, None)
      conv    (B, K-1, C)     → (batch, None, model)
      memory  (B, Hkv, S, d)  → (batch, None, None, None)
      cache   (B, Hkv, S, d)  → (batch, None, seq, None)
    """
    from repro_torch.models.attention import KVCache
    from repro_torch.models.mamba import SSMState

    sizes = shd.mesh_sizes(mesh)

    def pl(kind, t):
        return shd.placements(_state_spec(kind, tuple(t.shape), env, sizes), mesh.mesh_dim_names)

    caches = [KVCache(k=pl("cache", c.k), v=pl("cache", c.v), length=c.length)
              if isinstance(c, KVCache) else SSMState(conv=pl("conv", c.conv), ssd=pl("ssd", c.ssd))
              for c in state.caches]
    memory = None if state.memory is None else [
        (pl("memory", k), pl("memory", v)) for k, v in state.memory]
    return state._replace(caches=caches, memory=memory)


def place(t: torch.Tensor, mesh, placements_):
    """``t``, the same full tensor on every rank, as a DTensor: each rank
    keeps its own shard (no communication); a DTensor is redistributed."""
    from torch.distributed.tensor import distribute_tensor

    if shd.is_distributed(t):
        return t.redistribute(mesh, placements_)
    return distribute_tensor(t, mesh, placements_, src_data_rank=None)


def distribute_batch(mesh, batch: dict, env) -> dict:
    pls = batch_shardings(mesh, batch, env)
    return {k: place(v, mesh, pls[k]) for k, v in batch.items()}


def distribute_decode_state(mesh, state, env):
    """A ``DecodeState`` whose tensors are DTensors laid out by
    :func:`decode_state_shardings` (``length`` stays a host int)."""
    pls = decode_state_shardings(mesh, state, env)
    caches = [type(c)(*[place(t, mesh, p) if isinstance(t, torch.Tensor) else t
                        for t, p in zip(c, pc)]) for c, pc in zip(state.caches, pls.caches)]
    memory = None if state.memory is None else [
        (place(k, mesh, pk), place(v, mesh, pv))
        for (k, v), (pk, pv) in zip(state.memory, pls.memory)]
    return state._replace(caches=caches, memory=memory)
