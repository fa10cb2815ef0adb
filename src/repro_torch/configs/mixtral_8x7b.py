"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8 experts top-2, sliding-window attention (4096). [arXiv:2401.04088]

SWA makes ``long_500k`` decode runnable: the KV cache is a ring of size 4096.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    rope_style="full", rope_theta=1000000.0, sliding_window=4096,
    moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=14336),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, sliding_window=16,
        moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=256))
