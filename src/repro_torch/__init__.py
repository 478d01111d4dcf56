"""repro_torch — the PyTorch and CUDA port of ``repro`` for the NVIDIA H100.

Laid out module for module like ``repro`` (the JAX reference, which this
package never imports).  Entry points that turn numpy into tensors put them
on ``"cuda"`` unless the caller asks for another device; functions that
take tensors run where those tensors live.  The def-CG and LSMR hot paths
run seven hand-written Hopper kernels (``repro_torch.kernels``), built from
``repro_torch/csrc`` at first use; ``repro_torch.optim`` is the
Hessian-free optimizer over them.
"""

from repro_torch import core, data, gp, kernels, optim

__all__ = ["core", "data", "gp", "kernels", "optim"]
