"""Architecture registry: ``arch id`` resolution and the shape grid.

The port's copy of ``repro.configs.registry``, every architecture of the
reference's: dense GQA (qwen1.5, qwen3, starcoder2, stablelm, chameleon;
attention on the flash-attention kernel), pure SSD (mamba2, the SSD scan
kernel), MoE (olmoe, arctic), the hybrid (jamba: SSD and attention
layers, MoE every other layer) and the encoder–decoder
(seamless-m4t-large-v2: a non-causal encoder stack, and decoder layers
that cross-attend to its output, on the same kernel).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig

_ARCH_MODULES = {
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
}

ARCH_IDS = tuple(_ARCH_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(_ARCH_MODULES[arch]).SMOKE


def is_subquadratic(cfg: ModelConfig) -> bool:
    """SSM / hybrid stacks handle 512k decode; pure attention does not."""
    return cfg.family in ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """The reference's skip rule: long_500k only for sub-quadratic mixers."""
    if shape.name == "long_500k" and not is_subquadratic(cfg):
        return False, "pure full-attention arch — 512k decode skipped (DESIGN.md §4)"
    return True, ""
