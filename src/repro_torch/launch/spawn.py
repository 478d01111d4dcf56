"""Start the ranks of a solve group on one machine: :func:`run_ranks`.

One process per rank, started with ``torch.multiprocessing`` (spawn), each
joining the process group through a file rendezvous in a fresh temporary
directory, with the collective timeout given.  The parent waits for all of
them up to a join limit: a rank that raises makes :func:`run_ranks` raise
(the others are stopped), and a group that outlives the limit is stopped
and reported, so a deadlock fails instead of hanging.  What rank 0's
function returns comes back through a pickle in that directory; the
function and its arguments must be picklable (a module-level function,
numpy arrays), and the function should return host data (numpy).

On CUDA the port's sources are built once in the parent before the ranks
start (:func:`repro_torch.kernels._build.build`), so that the ranks only
load the libraries and never race on ``build/``.  Each rank takes
``cuda:<rank mod device_count>``; CPU ranks split the machine's cores
between them (``torch.set_num_threads``).  NCCL takes one rank per card;
gloo runs any number of ranks on one card, or on the CPU.  The ranks talk
over the loopback interface unless ``GLOO_SOCKET_IFNAME`` /
``NCCL_SOCKET_IFNAME`` say otherwise.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_RESULT = "rank0.pkl"


def _rank_main(rank, fn, world_size, backend, device, args, workdir, timeout_s):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ["LOCAL_RANK"] = str(rank)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:  # the ranks share the machine's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(
        backend,
        init_method="file://" + os.path.join(workdir, "rendezvous"),
        rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    try:
        out = fn(*args)
        if rank == 0:
            with open(os.path.join(workdir, _RESULT), "wb") as fh:
                pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def run_ranks(
    fn: Callable[..., Any],
    world_size: int,
    *,
    backend: str = "gloo",
    device: str = "cuda",
    args: Sequence[Any] = (),
    timeout_s: float = 300.0,
) -> Any:
    """Run ``fn(*args)`` on ``world_size`` ranks; return rank 0's result.

    ``backend`` is ``"nccl"`` (one rank per card) or ``"gloo"``;
    ``device`` is where the ranks compute (``"cuda"`` or ``"cpu"``).
    ``timeout_s`` bounds every collective (the process group's timeout)
    and the whole run (the join limit, twice it).  Raises if any rank
    fails or the run passes the limit; never hangs.
    """
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build

        _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    workdir = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main,
            args=(fn, world_size, backend, device, tuple(args), workdir, timeout_s),
            nprocs=world_size,
            join=False,
            start_method="spawn",
        )
        deadline = time.monotonic() + 2.0 * timeout_s
        try:
            while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"run_ranks: {world_size} ranks of {fn.__name__} still "
                        f"running after {2.0 * timeout_s:.0f} s"
                    )
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                    proc.join(10)
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
        with open(os.path.join(workdir, _RESULT), "rb") as fh:
            return pickle.load(fh)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
