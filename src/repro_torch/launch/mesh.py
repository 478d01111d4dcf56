"""The solve group: the port's counterpart of ``repro.launch.mesh.make_solve_mesh``.

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
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

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


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    """The training mesh: ``data`` × ``model`` ranks on ``device``.  One
    device (1 × 1) until tensor parallelism and ZeRO are ported (ROADMAP
    queue 1, the sharding layouts)."""

    device: torch.device
    shape: tuple = (("data", 1), ("model", 1))

    @property
    def axes(self) -> dict:
        return dict(self.shape)


def make_train_mesh(device="cuda") -> TrainMesh:
    return TrainMesh(device=torch.device(device))
