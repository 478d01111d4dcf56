"""repro_torch.launch — running the sharded engine on several ranks, and
the model zoo's training and serving steps.

:func:`make_solve_mesh` wraps an initialized ``torch.distributed`` process
group as the :class:`SolveMesh` that ``solve(..., mesh=)`` shards over;
:func:`run_ranks` starts the ranks of such a group on one machine.
:func:`make_train_step`, :func:`make_prefill_step` and
:func:`make_serve_step` close a model configuration over ``lm_loss`` and
AdamW, ``models.prefill`` and ``models.decode_step``.  ``launch.mesh`` lays
the models out on a ``("data", "model")`` ``DeviceMesh`` (tensor
parallelism, ZeRO and data parallelism as DTensor placements:
:func:`make_production_mesh`, :func:`bind`, :func:`param_shardings`,
:func:`batch_shardings`, :func:`decode_state_shardings`) and
``launch.train.make_mesh_auto`` picks the training mesh.
:func:`input_specs` / :func:`decode_state_specs` give a cell's inputs as
meta tensors; ``launch.dryrun`` traces every cell on them for one H100
(``launch.trace_stats``, ``launch.roofline``, ``launch.gpc_dryrun``).
"""

from repro_torch.launch.mesh import COLLECTIVES, SolveMesh, make_solve_mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.launch.mesh import (
    axis_env_for,
    batch_shardings,
    bind,
    decode_state_shardings,
    make_production_mesh,
    param_shardings,
)
from repro_torch.launch.steps import (
    decode_state_specs,
    init_opt_state,
    input_specs,
    loss_and_grads,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    model_flops,
    params_dict,
)

__all__ = ["COLLECTIVES", "SolveMesh", "axis_env_for", "batch_shardings", "bind",
           "decode_state_shardings", "decode_state_specs", "init_opt_state", "input_specs",
           "loss_and_grads", "make_prefill_step", "make_production_mesh", "make_serve_step",
           "make_solve_mesh", "make_train_step", "model_flops", "param_shardings", "params_dict",
           "run_ranks"]
