"""Architecture registry + assigned input shapes.

Every assigned architecture is a selectable config (``--arch <id>``); each is
paired with the LM shape set below.  ``long_500k`` requires sub-quadratic
attention and therefore only runs for the SSM/hybrid families — the skip is
recorded per-arch here and explained in DESIGN.md §Arch-applicability.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "qwen2-vl-2b", "qwen2.5-32b", "olmo-1b", "qwen3-0.6b", "yi-34b",
    "zamba2-7b", "whisper-base", "deepseek-moe-16b", "kimi-k2-1t-a32b",
    "falcon-mamba-7b",
]

_MODULES = {
    "qwen2-vl-2b": "qwen2_vl_2b",
    "qwen2.5-32b": "qwen2_5_32b",
    "olmo-1b": "olmo_1b",
    "qwen3-0.6b": "qwen3_0_6b",
    "yi-34b": "yi_34b",
    "zamba2-7b": "zamba2_7b",
    "whisper-base": "whisper_base",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_reduced(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.REDUCED


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) — the 40-cell table logic."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "SKIP(full-attention: 500k KV infeasible; see DESIGN.md)"
    return True, ""


def cells():
    """All 40 (arch, shape) cells with applicability."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = shape_applicable(cfg, s)
            out.append((a, s.name, ok, why))
    return out
