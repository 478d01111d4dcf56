"""repro_torch.kernels — hand-written Hopper kernels of the port.

Contract per kernel: the CUDA source under ``csrc/``, the wrapper and its
plain PyTorch version in ``cg_fused.py`` or ``rbf_matvec.py``, the launch
counters and checks in ``_runtime.py``, the oracle in ``ref.py``, and
device dispatch in ``ops.py`` (``backend`` = auto | cuda | plain |
reference).  Nothing here builds or imports a GPU toolchain at import
time.
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
