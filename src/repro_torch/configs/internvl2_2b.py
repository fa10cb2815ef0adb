"""internvl2-2b [vlm]: InternLM2 backbone 24L d_model=2048 16H (GQA kv=8)
d_ff=8192 vocab=92553; InternViT frontend STUB (precomputed patch embeddings
prepended to the token sequence). [arXiv:2404.16821]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92553,
    rope_style="full", rope_theta=1000000.0, tie_embeddings=True,
    n_patches=256, frontend="vision",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, n_patches=8)
