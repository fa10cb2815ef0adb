"""Per-architecture training presets (copies of the JAX package's): how each
model fits the production mesh.

The memory strategy column is what makes the big configs fit 16 GB/chip on
256 chips (v5e):
- fsdp      : params + optimizer state sharded over the data axes (ZeRO-3)
- adafactor : factored second moments (1T-param Kimi-K2)
- bf16 state: moments stored bf16
- microbatch: grad-accumulation chunks for train_4k (activation memory)
"""

from __future__ import annotations

from repro_torch.configs.base import TrainConfig

_PRESETS = {
    "whisper_base": TrainConfig(microbatch=1),
    "llama3_2_3b": TrainConfig(microbatch=2),
    "llama3_405b": TrainConfig(fsdp=True, optimizer="adafactor",
                               opt_state_dtype="bfloat16",
                               accum_dtype="bfloat16", microbatch=8),
    "chatglm3_6b": TrainConfig(microbatch=2, fsdp=True),
    "qwen3_32b": TrainConfig(fsdp=True, microbatch=8),
    "internvl2_2b": TrainConfig(microbatch=2),
    "mixtral_8x7b": TrainConfig(fsdp=True, microbatch=4),
    "kimi_k2": TrainConfig(fsdp=True, optimizer="adafactor",
                           opt_state_dtype="bfloat16",
                           accum_dtype="bfloat16", microbatch=16),
    "zamba2_2_7b": TrainConfig(microbatch=4),
    "mamba2_370m": TrainConfig(microbatch=4),
}


def train_preset(arch: str) -> TrainConfig:
    from repro_torch.configs.registry import canonical
    return _PRESETS[canonical(arch)]

