"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Each arch module defines CONFIG (full, paper-exact) and reduced() (smoke)."""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "whisper_base", "llama3_2_3b", "llama3_405b", "chatglm3_6b", "qwen3_32b",
    "internvl2_2b", "mixtral_8x7b", "kimi_k2", "zamba2_2_7b", "mamba2_370m",
]

_ALIASES = {
    "whisper-base": "whisper_base", "llama3.2-3b": "llama3_2_3b",
    "llama3-405b": "llama3_405b", "chatglm3-6b": "chatglm3_6b",
    "qwen3-32b": "qwen3_32b", "internvl2-2b": "internvl2_2b",
    "mixtral-8x7b": "mixtral_8x7b", "kimi-k2-1t-a32b": "kimi_k2",
    "zamba2-2.7b": "zamba2_2_7b", "mamba2-370m": "mamba2_370m",
}


def canonical(arch: str) -> str:
    a = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if a not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return a


def get_config(arch: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.CONFIG


def get_reduced(arch: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.reduced()


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}