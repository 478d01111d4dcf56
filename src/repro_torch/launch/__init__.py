"""repro_torch.launch — running the sharded engine on several ranks, and
the model zoo's serving steps.

:func:`make_solve_mesh` wraps an initialized ``torch.distributed`` process
group as the :class:`SolveMesh` that ``solve(..., mesh=)`` shards over;
:func:`run_ranks` starts the ranks of such a group on one machine.
:func:`make_prefill_step` and :func:`make_serve_step` close a model
configuration over ``models.prefill`` / ``models.decode_step``.
"""

from repro_torch.launch.mesh import COLLECTIVES, SolveMesh, make_solve_mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.launch.steps import make_prefill_step, make_serve_step, model_flops

__all__ = ["COLLECTIVES", "SolveMesh", "make_prefill_step", "make_serve_step",
           "make_solve_mesh", "model_flops", "run_ranks"]
