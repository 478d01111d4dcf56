"""repro_torch.optim — AdamW, PowerSGD gradient compression, and the
Hessian-free optimizer with Krylov recycling."""

from repro_torch.optim.adam import AdamState, adam_init, adam_update
from repro_torch.optim.grad_compress import (
    PowerSGDState,
    compress,
    compress_decompress,
    decompress,
    powersgd_init,
)
from repro_torch.optim.hessian_free import (
    HFConfig,
    HFState,
    hf_init,
    hf_step,
    softmax_xent_hvp,
    squared_loss_hvp,
)

__all__ = [
    "AdamState", "adam_init", "adam_update",
    "PowerSGDState", "compress", "compress_decompress", "decompress",
    "powersgd_init",
    "HFConfig", "HFState", "hf_init", "hf_step",
    "softmax_xent_hvp", "squared_loss_hvp",
]
