"""repro_torch.launch — running the sharded engine on several ranks.

:func:`make_solve_mesh` wraps an initialized ``torch.distributed`` process
group as the :class:`SolveMesh` that ``solve(..., mesh=)`` shards over;
:func:`run_ranks` starts the ranks of such a group on one machine.
"""

from repro_torch.launch.mesh import COLLECTIVES, SolveMesh, make_solve_mesh
from repro_torch.launch.spawn import run_ranks

__all__ = ["COLLECTIVES", "SolveMesh", "make_solve_mesh", "run_ranks"]
