"""Architecture registry + assigned input shapes.

``get(name)`` returns the full published config; ``get_smoke(name)`` the
reduced CPU-testable config.  ``SHAPES`` is the assigned shape set; cells are
(arch x shape) pairs filtered by ``applicable_shapes`` (long_500k only for
sub-quadratic archs).  A copy of the reference's registry: the
configurations are data, and every one of them is carried, though only
the dense attention and MoE-family block kinds run in the port so far.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..models.config import ArchConfig, reduced
from . import (command_r_plus_104b, deepseek_v2_236b, gemma2_27b,
               h2o_danube_3_4b, hymba_1_5b, internvl2_2b, olmoe_1b_7b,
               qwen3_4b, whisper_base, xlstm_1_3b)

REGISTRY: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (
        xlstm_1_3b, qwen3_4b, h2o_danube_3_4b, gemma2_27b,
        command_r_plus_104b, deepseek_v2_236b, olmoe_1b_7b, whisper_base,
        hymba_1_5b, internvl2_2b)
}

ARCH_IDS: Tuple[str, ...] = tuple(REGISTRY)


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def get_smoke(name: str, **overrides) -> ArchConfig:
    return reduced(get(name), **overrides)


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> List[Shape]:
    """Task skip rules: long_500k needs a sub-quadratic arch."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        out.append(SHAPES["long_500k"])
    return out


def all_cells() -> List[Tuple[str, str]]:
    cells = []
    for arch in ARCH_IDS:
        for shape in applicable_shapes(get(arch)):
            cells.append((arch, shape.name))
    return cells
