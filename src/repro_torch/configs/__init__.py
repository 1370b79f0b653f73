"""Architecture registry: --arch <id> selects one of the assigned configs."""

from __future__ import annotations

import importlib

_MODULES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "phi3-medium-14b": "phi3_medium_14b",
    "starcoder2-7b": "starcoder2_7b",
    "gemma2-2b": "gemma2_2b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "xlstm-1.3b": "xlstm_1_3b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG


from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_applicable, all_cells  # noqa: F401,E402
