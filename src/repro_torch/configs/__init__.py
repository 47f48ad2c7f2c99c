"""Architecture registry of the port: the JAX package's architecture ids,
of which only the ported ones resolve to a configuration."""
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
# the architectures whose block kinds are ported
PORTED = ["gemma2_9b", "phi4_mini_3p8b", "qwen1p5_110b", "llava_next_34b",
          "minicpm3_4b", "llama4_scout_17b_16e", "deepseek_v2_lite_16b",
          "mamba2_780m", "zamba2_7b"]


def _module(arch: str):
    name = arch.replace("-", "_").replace(".", "p")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if name not in PORTED:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP.md, "
                       f"queue 1 item 8.5: the encoder-decoder); "
                       f"ported: {PORTED}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE_CONFIG
