"""Architecture config registry: ``get("qwen2-7b")`` etc."""
from .base import ModelConfig, RunConfig, ShapeConfig, SHAPES

_MODULES = {
    "phi-3-vision-4.2b": "phi_3_vision_4p2b",
    "zamba2-2.7b": "zamba2_2p7b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "mamba2-1.3b": "mamba2_1p3b",
    "qwen3-14b": "qwen3_14b",
    "qwen2-72b": "qwen2_72b",
    "qwen2-7b": "qwen2_7b",
    "command-r-plus-104b": "command_r_plus_104b",
    "whisper-medium": "whisper_medium",
}

ARCH_IDS = list(_MODULES)


def get(name: str) -> ModelConfig:
    import importlib
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


__all__ = ["ModelConfig", "RunConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "get"]
