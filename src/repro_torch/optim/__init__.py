"""repro_torch.optim — the Hessian-free optimizer with Krylov recycling."""

from repro_torch.optim.hessian_free import (
    HFConfig,
    HFState,
    hf_init,
    hf_step,
    softmax_xent_hvp,
    squared_loss_hvp,
)

__all__ = [
    "HFConfig", "HFState", "hf_init", "hf_step",
    "softmax_xent_hvp", "squared_loss_hvp",
]
