"""Architecture registry: ``arch id`` resolution and the shape grid.

The port's copy of ``repro.configs.registry`` for the architectures it
builds so far: the dense GQA family (qwen1.5-0.5b, attention on the
flash-attention kernel) and the pure-SSD family (mamba2-1.3b, the SSD scan
kernel).  The reference's other eight architectures register here with
their families (MoE, hybrid, encoder–decoder; ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

_ARCH_MODULES = {
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
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
