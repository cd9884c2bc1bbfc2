"""Architecture registry: one module per assigned arch (+ the paper's own).

``get_config(arch_id)`` resolves ids like "mixtral-8x7b" to a ModelConfig.
A copy of ``repro.configs`` (pure dataclasses): the port imports nothing
of the JAX package, and resolves every id as the reference does.
"""

from importlib import import_module

from .base import ModelConfig, RunConfig, ShapeConfig  # noqa: F401
from .shapes import SHAPES, shapes_for  # noqa: F401

ARCH_IDS = [
    "seamless-m4t-large-v2",
    "deepseek-moe-16b",
    "mixtral-8x7b",
    "granite-34b",
    "gemma3-4b",
    "nemotron-4-15b",
    "granite-3-8b",
    "zamba2-2.7b",
    "xlstm-125m",
    "qwen2-vl-72b",
]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str):
    """Resolve an --arch id to its ModelConfig (or the paper's TMFGConfig)."""
    if arch_id in ("paper-tmfg", "tmfg"):
        return import_module(".paper_tmfg", __package__).CONFIG
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    return import_module("." + _module_name(arch_id), __package__).CONFIG
