"""repro_torch.data — the synthetic, deterministic data of the port."""

from repro_torch.data.digits import make_infinite_digits
from repro_torch.data.tokens import TokenPipeline

__all__ = ["TokenPipeline", "make_infinite_digits"]
