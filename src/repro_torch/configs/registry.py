# Copied from src/repro/configs/registry.py with repro. renamed to repro_torch.; keep its logic in step with that file.
"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

from importlib import import_module

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "yi-9b": "repro_torch.configs.yi_9b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
}

ARCHS = tuple(_MODULES)

# long_500k applicability (DESIGN.md §5): sub-quadratic (SSM/hybrid/local)
# archs run it; pure full-attention archs skip.
LONG_CONTEXT_ARCHS = ("jamba-v0.1-52b", "gemma2-27b", "xlstm-1.3b")


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch '{arch}'; have {list(_MODULES)}")
    return import_module(_MODULES[arch]).CONFIG


def shape_applicable(arch: str, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, (
            "pure full-attention arch: 500k context needs sub-quadratic "
            "attention (DESIGN.md §5)"
        )
    return True, ""
