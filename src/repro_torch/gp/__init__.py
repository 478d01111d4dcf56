"""repro_torch.gp — GP classification, the paper's experiment."""

from repro_torch.gp.inducing import InducingResult, subset_gpc
from repro_torch.gp.kernels import RBFKernel
from repro_torch.gp.laplace import (
    LaplaceResult,
    NewtonTrace,
    laplace_gpc,
    logistic_quantities,
    predict_latent,
)

__all__ = [
    "InducingResult",
    "RBFKernel",
    "LaplaceResult",
    "NewtonTrace",
    "laplace_gpc",
    "logistic_quantities",
    "predict_latent",
    "subset_gpc",
]
