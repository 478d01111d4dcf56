"""repro_torch — the PyTorch and CUDA port of ``repro`` for the NVIDIA H100.

Laid out module for module like ``repro`` (the JAX reference, which this
package never imports).  Entry points that turn numpy into tensors put them
on ``"cuda"`` unless the caller asks for another device; functions that
take tensors run where those tensors live.  The def-CG and LSMR hot paths
run eight hand-written Hopper kernels (``repro_torch.kernels``), built from
``repro_torch/csrc`` at first use; ``repro_torch.optim`` is the
Hessian-free optimizer over them, and ``repro_torch.launch`` runs the
sharded engine (``solve(..., mesh=)``) on ``torch.distributed`` ranks.
``repro_torch.serve`` is the multi-tenant solve service over batched
solves.  ``repro_torch.models`` serves the model zoo's dense and Mamba2
stacks (``repro_torch.configs``) on two more kernels, flash attention and
the SSD scan.
"""

from repro_torch import configs, core, data, gp, kernels, launch, models, optim, serve

__all__ = ["configs", "core", "data", "gp", "kernels", "launch", "models", "optim", "serve"]
