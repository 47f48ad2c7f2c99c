"""Architecture registry of the port: the JAX package's architecture ids,
every one of them ported."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "llama4_scout_17b_16e",
    "deepseek_v2_lite_16b",
    "zamba2_7b",
    "mamba2_780m",
    "phi4_mini_3p8b",
    "minicpm3_4b",
    "qwen1p5_110b",
    "gemma2_9b",
    "llava_next_34b",
    "seamless_m4t_large_v2",
]


def _module(arch: str):
    name = arch.replace("-", "_").replace(".", "p")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE_CONFIG
