"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256. [arXiv:2407.21783]

Scale case: bf16 params + bf16 optimizer moments + FSDP(ZeRO-3) over the data
axes are required to fit 16 GB/chip HBM on 256 chips (see EXPERIMENTS.md).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
    d_ff=53248, vocab_size=128256,
    rope_style="full", rope_theta=500000.0,
    param_dtype="bfloat16", seq_parallel=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=8, n_kv_heads=4, head_dim=16,
        d_ff=384, vocab_size=512, param_dtype="float32")
