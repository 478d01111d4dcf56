"""repro_torch.data — the synthetic, deterministic data of the port."""

from repro_torch.data.digits import make_infinite_digits

__all__ = ["make_infinite_digits"]
