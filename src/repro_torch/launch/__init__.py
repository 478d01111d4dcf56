"""repro_torch.launch — running the sharded engine on several ranks, and
the model zoo's training and serving steps.

:func:`make_solve_mesh` wraps an initialized ``torch.distributed`` process
group as the :class:`SolveMesh` that ``solve(..., mesh=)`` shards over;
:func:`run_ranks` starts the ranks of such a group on one machine.
:func:`make_train_step`, :func:`make_prefill_step` and
:func:`make_serve_step` close a model configuration over ``lm_loss`` and
AdamW, ``models.prefill`` and ``models.decode_step``; :func:`make_train_mesh`
is the training mesh (one device until tensor parallelism).
"""

from repro_torch.launch.mesh import COLLECTIVES, SolveMesh, make_solve_mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.launch.mesh import TrainMesh, make_train_mesh
from repro_torch.launch.steps import (
    init_opt_state,
    loss_and_grads,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    model_flops,
    params_dict,
)

__all__ = ["COLLECTIVES", "SolveMesh", "TrainMesh", "init_opt_state", "loss_and_grads",
           "make_prefill_step",
           "make_serve_step", "make_solve_mesh", "make_train_mesh", "make_train_step",
           "model_flops", "params_dict", "run_ranks"]
