"""mamba2-370m [ssm]: 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060]

``long_500k`` runs: O(1) recurrent state, no KV cache.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=128),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=128, vocab_size=512,
        ssm=SSMCfg(d_state=16, head_dim=32, expand=2, d_conv=4, chunk=32))
