"""zamba2-2.7b [hybrid]: 54 Mamba2 layers d_model=2560, ssm_state=64 + one
SHARED attention block (32H kv=32, d_ff=10240) applied every 9th layer.
[arXiv:2411.15242]

Hybrid family: ``long_500k`` runs — SSM state is O(1); the shared attention
block serves long contexts with a sliding window (4096) ring cache.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    rope_style="full", rope_theta=10000.0,
    ssm=SSMCfg(d_state=64, head_dim=64, expand=2, d_conv=4, chunk=128),
    shared_attn_period=9, sliding_window=4096,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512, shared_attn_period=2, sliding_window=16,
        ssm=SSMCfg(d_state=16, head_dim=32, expand=2, d_conv=4, chunk=32))
