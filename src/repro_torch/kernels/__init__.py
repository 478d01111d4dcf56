"""repro_torch.kernels — hand-written Hopper kernels of the port.

Contract per kernel: the CUDA source under ``csrc/``, the wrapper and its
plain PyTorch version in ``cg_fused.py`` or ``rbf_matvec.py``, the launch
counters and checks in ``_runtime.py``, the oracle in ``ref.py``, and
device dispatch in ``ops.py`` (``backend`` = auto | cuda | plain |
reference).  ``work.py`` holds the operations and bytes behind each
kernel's bound, which the custom ops of the kernels a dry-run traces (K3,
K8, K9, K10) also report to ``FlopCounterMode`` and the dry-run.  Nothing
here builds or imports a GPU toolchain at import time.
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
